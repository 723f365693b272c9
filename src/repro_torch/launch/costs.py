"""Roofline cost accounting: the analytic half of ``repro.launch.costs``.

The reference computes a step's FLOPs and HBM bytes analytically because
XLA's HloCostAnalysis counts every while-loop body once; the port has no
compiled program to read counters from, so the analytic model is all it
needs:

  * **FLOPs**: computed analytically from the model config + cell shape —
    an exact matmul inventory (attention, FFN/MoE-with-capacity, vocab
    projections, interaction layers) times the fwd/bwd/remat multiplier.
  * **HBM bytes**: analytic lower-bound traffic model (documented per
    family): parameter reads/writes (incl. optimizer state), activation
    read/write per layer, embedding gathers, KV-cache traffic. This is the
    roofline *denominator* convention: best-achievable traffic, so the
    memory term is a true lower bound on step time.

The formulas are the reference's, verbatim but for reading dtypes and
param counts from torch. Not ported: the reference's loop-aware collective
census (``parse_collectives_loop_aware``), which parses XLA's
post-partitioning HLO; the port runs no SPMD partitioner and emits no HLO.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.train.tree import flatten_with_paths, leaves

# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------


def _lm_layer_matmul_flops_per_token(cfg) -> float:
    """Projection + FFN matmul FLOPs for ONE token through ONE layer (fwd)."""
    d, hd = cfg.d_model, cfg.d_head
    attn = 2.0 * d * cfg.n_heads * hd  # wq
    attn += 2.0 * 2.0 * d * cfg.n_kv_heads * hd  # wk, wv
    attn += 2.0 * cfg.n_heads * hd * d  # wo
    if cfg.moe is not None:
        m = cfg.moe
        # HLO computes the full capacity buffer: E * C tokens of expert work,
        # C = T*K/E * capacity_factor  =>  per source token: K * cf experts
        ffn = 3.0 * 2.0 * d * m.d_expert_ff * m.top_k * m.capacity_factor
        ffn += 2.0 * d * m.n_experts  # router
        if m.n_shared:
            ffn += 3.0 * 2.0 * d * m.d_expert_ff * m.n_shared
    else:
        ffn = 3.0 * 2.0 * d * cfg.d_ff
    return attn + ffn


def _lm_attention_flops_per_token(cfg, seq: int, context: Optional[int] = None) -> float:
    """Score + AV einsum FLOPs per *query* token (fwd), summed over layers."""
    total = 0.0
    for l in range(cfg.n_layers):
        w = cfg.layer_window(l)
        if context is not None:  # decode: attend over the cache
            s_eff = min(w, context) if w > 0 else context
        else:  # full causal self-attention averages S/2 visible keys
            s_eff = min(w, seq) if w > 0 else seq / 2.0
        total += 2.0 * 2.0 * s_eff * cfg.n_heads * cfg.d_head
    return total


def _remat_mult(cfg) -> float:
    # fwd(1) + bwd(2) (+ recompute fwd(1) under full remat)
    return {"none": 3.0, "dots": 3.5, "full": 4.0}.get(getattr(cfg, "remat", "none"), 3.0)


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    tokens = batch * seq
    per_tok = cfg.n_layers * _lm_layer_matmul_flops_per_token(cfg)
    attn = _lm_attention_flops_per_token(cfg, seq) * tokens
    body = (per_tok * tokens + attn) * _remat_mult(cfg)
    logits = 2.0 * cfg.d_model * cfg.vocab * tokens * 3.0  # loss is outside remat
    embed_bwd = 2.0 * cfg.d_model * tokens  # scatter-add grads (cheap)
    return body + logits + embed_bwd


def lm_prefill_flops(cfg, batch: int, seq: int) -> float:
    tokens = batch * seq
    per_tok = cfg.n_layers * _lm_layer_matmul_flops_per_token(cfg)
    attn = _lm_attention_flops_per_token(cfg, seq) * tokens
    logits = 2.0 * cfg.d_model * cfg.vocab * batch  # last position only
    return per_tok * tokens + attn + logits


def lm_decode_flops(cfg, batch: int, context: int) -> float:
    per_tok = cfg.n_layers * _lm_layer_matmul_flops_per_token(cfg)
    attn = _lm_attention_flops_per_token(cfg, 1, context=context)
    logits = 2.0 * cfg.d_model * cfg.vocab
    return (per_tok + attn + logits) * batch


def gnn_train_flops(cfg, n_nodes: int, n_edges: int) -> float:
    h = cfg.d_hidden
    enc = n_nodes * (cfg.d_feat + h) * h + n_edges * (cfg.d_edge_feat + h) * h
    per_layer = n_edges * (3 * h + h) * h + n_nodes * (2 * h + h) * h
    dec = n_nodes * (h * h + h * cfg.n_vars)
    fwd = 2.0 * (enc + cfg.n_layers * per_layer + dec)
    mult = 4.0 if cfg.remat != "none" else 3.0
    return fwd * mult


def recsys_dense_params(cfg) -> int:
    """Interaction/MLP params (excludes the embedding table + wide vector)."""
    from repro_torch.archs.recsys import abstract_params

    total = 0
    for path, leaf in flatten_with_paths(abstract_params(cfg).tree())[0]:
        if "table" in path or "wide" in path or "pos_embed" in path:
            continue
        total += leaf.numel()
    return total


def recsys_forward_flops(cfg, batch: int) -> float:
    dense = recsys_dense_params(cfg)
    if cfg.kind == "din":
        # attention MLP runs per history position; split params by module
        from repro_torch.archs.recsys import abstract_params

        attn_p = sum(leaf.numel() for leaf in leaves(abstract_params(cfg).tree()["attn"]))
        rest = dense - attn_p
        return 2.0 * batch * (attn_p * cfg.seq_len + rest)
    if cfg.kind == "sasrec":
        per_pos = dense  # blocks run per sequence position
        attn_quad = 2.0 * 2.0 * cfg.seq_len * cfg.embed_dim * cfg.n_blocks
        return 2.0 * batch * cfg.seq_len * (per_pos + attn_quad) / 1.0
    return 2.0 * batch * dense


def recsys_train_flops(cfg, batch: int) -> float:
    return 3.0 * recsys_forward_flops(cfg, batch)


# ---------------------------------------------------------------------------
# analytic HBM bytes (lower-bound traffic)
# ---------------------------------------------------------------------------


def _dtype_bytes(cfg) -> int:
    return getattr(cfg, "dtype", torch.float32).itemsize


def lm_train_bytes(cfg, batch: int, seq: int) -> float:
    b = _dtype_bytes(cfg)
    tokens = batch * seq
    p = cfg.n_params()
    # params: read fwd + read bwd-recompute + grad write + AdamW (rd p,m,v / wr p,m,v in f32)
    param_traffic = p * b * 3 + p * 4 * 6
    # activations: ~6 major [tokens, d] tensors read+written per layer
    act = cfg.n_layers * tokens * cfg.d_model * b * 12
    logits = 2.0 * tokens * cfg.vocab * 4 / max(1, (tokens // cfg.vocab_chunk) if cfg.vocab_chunk else 1)
    return param_traffic + act + logits


def lm_decode_bytes(cfg, batch: int, context: int) -> float:
    b = _dtype_bytes(cfg)
    params = cfg.n_active_params() * b  # every weight read once
    cache = 0.0
    for l in range(cfg.n_layers):
        w = cfg.layer_window(l)
        s_eff = min(w, context) if w > 0 else context
        cache += 2.0 * s_eff * cfg.n_kv_heads * cfg.d_head * b * batch  # k+v read
    return params + cache


def lm_prefill_bytes(cfg, batch: int, seq: int) -> float:
    b = _dtype_bytes(cfg)
    tokens = batch * seq
    return cfg.n_params() * b + cfg.n_layers * tokens * cfg.d_model * b * 8


def gnn_train_bytes(cfg, n_nodes: int, n_edges: int) -> float:
    h, b = cfg.d_hidden, _dtype_bytes(cfg)
    per_layer = (2 * n_edges + 2 * n_nodes) * h * b * 3  # msgs+nodes, fwd/bwd
    return cfg.n_params() * (4 * 9) + cfg.n_layers * per_layer


def recsys_train_bytes(cfg, batch: int) -> float:
    lookups = batch * cfg.table.n_slots * cfg.table.dim * 4 * 3  # gather + grad scatter
    if cfg.kind in ("din", "sasrec"):
        lookups *= cfg.seq_len / max(cfg.table.n_slots, 1)
    dense = recsys_dense_params(cfg) * 4 * 9
    acts = batch * 4 * 4096  # order-of-magnitude MLP activations
    return lookups + dense + acts


def recsys_serve_bytes(cfg, batch: int) -> float:
    lookups = batch * cfg.table.n_slots * cfg.table.dim * 4
    if cfg.kind in ("din", "sasrec"):
        lookups *= cfg.seq_len / max(cfg.table.n_slots, 1)
    return lookups + recsys_dense_params(cfg) * 4


# ---------------------------------------------------------------------------
# dispatch per (family, kind)
# ---------------------------------------------------------------------------


def analytic_costs(family: str, kind: str, cfg, dims: dict) -> dict:
    """(flops, bytes) for the whole step, hardware-independent."""
    if family == "lm":
        B, S = dims["global_batch"], dims["seq_len"]
        if kind == "train":
            return {"flops": lm_train_flops(cfg, B, S), "bytes": lm_train_bytes(cfg, B, S)}
        if kind == "prefill":
            return {"flops": lm_prefill_flops(cfg, B, S), "bytes": lm_prefill_bytes(cfg, B, S)}
        return {"flops": lm_decode_flops(cfg, B, S), "bytes": lm_decode_bytes(cfg, B, S)}
    if family == "gnn":
        n, e = dims["_n_nodes"], dims["_n_edges"]
        return {"flops": gnn_train_flops(cfg, n, e), "bytes": gnn_train_bytes(cfg, n, e)}
    if family == "recsys":
        B = dims.get("n_candidates", dims["batch"]) if kind == "retrieval" else dims["batch"]
        if kind == "train":
            return {"flops": recsys_train_flops(cfg, B), "bytes": recsys_train_bytes(cfg, B)}
        return {"flops": recsys_forward_flops(cfg, B), "bytes": recsys_serve_bytes(cfg, B)}
    raise ValueError(family)
