"""Decoder-only transformer LM: the port of ``repro.archs.transformer``
(the five LM-family architectures and the sparse encoders' backbone).

``Transformer`` is an ``nn.Module`` whose layers are a plain
``nn.ModuleList`` in layer order; the reference's scan over stacked
``[repeats, ...]`` parameters has no counterpart in eager PyTorch.
``lm_params_from_reference`` and ``lm_params_to_reference`` carry the
reference's stacked param pytree to the port's ``state_dict`` and back.

``cfg.remat`` maps to activation checkpointing a layer at a time:
``"full"`` is ``torch.utils.checkpoint`` (``use_reentrant=False``);
``"dots"`` is a selective checkpoint that saves the matrix products'
outputs and recomputes the rest, as ``jax.checkpoint_policies.
checkpoint_dots`` does. The reference's sharding constraints (``act``,
``seq_shard``, ``dp_layout``) have no counterpart on one card: the fields
are kept so a config carries over, and they change nothing.

MoE layers (``LMConfig.moe``) are ``layers.MoE``; their aux loss adds up
over the layers as in the reference. The KV cache is a pytree of tensors in
the reference's layout (``init_cache``): ``blocks[j]`` holds ``k``/``v``
``[R, B, Tj, K, hd]`` and ``pos`` ``[R, B, Tj]`` (-1: an empty slot) for
the layers at position ``j`` of the window pattern, a ring buffer of
``window`` slots for a sliding-window layer, then ``tail``. ``lm_prefill``
and ``lm_decode_step`` are inference (no autograd) and write the cache in
place, where the reference returns a new one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.archs import layers
from repro_torch.archs.layers import AttnDims, MoEConfig
from repro_torch.device import resolve_device
from repro_torch.train.tree import dotted_names, nest_names, tree_map

# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    # attention pattern, cycled over layers: 0 global causal, W>0 sliding
    # window W, -1 bidirectional
    window_pattern: tuple[int, ...] = (0,)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # activation checkpointing of each layer: none | full | dots
    remat: str = "full"
    # attention KV-chunk size for the online-softmax path (0 = dense scores)
    attn_chunk: int = 0
    # sequence chunk for the cross-entropy (0 = materialize logits)
    vocab_chunk: int = 0
    seq_shard: bool = False  # no counterpart on one card
    dp_layout: bool = False  # no counterpart on one card

    @property
    def dims(self) -> AttnDims:
        return AttnDims(self.n_heads, self.n_kv_heads, self.d_head)

    @property
    def period(self) -> int:
        return len(self.window_pattern)

    @property
    def repeats(self) -> int:
        return self.n_layers // self.period

    @property
    def remainder(self) -> int:
        return self.n_layers % self.period

    def layer_window(self, layer: int) -> int:
        return self.window_pattern[layer % self.period]

    def cache_len(self, j: int, seq_len: int) -> int:
        """KV-cache length for position-in-period j at a given context size."""
        w = self.window_pattern[j]
        return min(w, seq_len) if w > 0 else seq_len

    def n_params(self) -> int:
        """Total parameter count (exact, from the init shapes)."""
        d, hd = self.d_model, self.d_head
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.moe is not None:
            m = self.moe
            ffn = d * m.n_experts * (2 * m.d_expert_ff) + m.n_experts * m.d_expert_ff * d
            ffn += d * m.n_experts  # router
            if m.n_shared:
                ffn += 3 * d * m.d_expert_ff * m.n_shared
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d  # 2 rmsnorm scales
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        return self.n_layers * per_layer + embed + head + d  # final norm

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only routed top_k + shared experts)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe
        hd = self.d_head
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * m.d_expert_ff * (m.top_k + m.n_shared) + d * m.n_experts
        per_layer = attn + ffn + 2 * d
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        return self.n_layers * per_layer + embed + head + d


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def model_device(device) -> torch.device:
    """Where a model is built: ``cuda`` unless ``"cpu"`` (raises without a
    GPU), or ``"meta"`` for shapes only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class Block(nn.Module):
    """One transformer layer: pre-norm attention and a pre-norm SwiGLU
    (``mlp``) or MoE (``moe``)."""

    def __init__(self, gen: torch.Generator | None, cfg: LMConfig, device=None):
        super().__init__()
        self.ln_attn = layers.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.ln_ffn = layers.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.attn = layers.Attention(gen, cfg.d_model, cfg.dims, cfg.dtype, device)
        if cfg.moe is not None:
            self.moe = layers.MoE(gen, cfg.d_model, cfg.moe, cfg.dtype, device)
        else:
            self.mlp = layers.SwiGLU(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device)


class Transformer(nn.Module):
    """Embedding (tied to the head), ``n_layers`` blocks, final RMSNorm."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator | None = None, device=None):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(layers.embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype,
                                                    device))
        self.layers = nn.ModuleList(Block(gen, cfg, device) for _ in range(cfg.n_layers))
        self.ln_out = layers.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                                          cfg.dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return lm_hidden_states(self, tokens, self.cfg)

    def reference_tree(self, named: dict) -> dict:
        """name -> tensor (the params, or a moment keyed as the params) ->
        the reference's stacked param pytree (checkpoints)."""
        return lm_params_to_reference(named, self.cfg)

    def from_reference_tree(self, tree) -> dict:
        return lm_params_from_reference(tree)


def init_lm_params(gen: torch.Generator | None, cfg: LMConfig, device=None) -> Transformer:
    """A ``Transformer`` with the reference's init distributions, drawn from
    ``gen`` (on the host, or on a CUDA generator's card) and placed on
    ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``: shapes only)."""
    return Transformer(cfg, gen, device)


def abstract_lm_params(cfg: LMConfig) -> Transformer:
    """The params on the ``meta`` device (no allocation): shapes and dtypes."""
    return Transformer(cfg, None, "meta")


# --------------------------------------------------------------------------
# reference param pytrees
# --------------------------------------------------------------------------


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def lm_params_from_reference(tree, prefix: str = "") -> dict:
    """The reference's ``init_lm_params`` pytree (numpy arrays or tensors)
    -> the port's ``state_dict`` (name -> tensor). Leaves of
    ``tree["blocks"][j]`` carry a leading ``[repeats]`` axis (MoE experts:
    ``[repeats, E, ...]``); layer ``r * period + j`` takes row ``r`` of block
    ``j``, and the tail layers follow. A layer's leaf at path ``a/b/c`` is
    the port's ``layers.{i}.a.b.c``."""
    out = {f"{prefix}embed": _as_tensor(tree["embed"]),
           f"{prefix}ln_out.scale": _as_tensor(tree["ln_out"]["scale"])}
    if "unembed" in tree:
        out[f"{prefix}unembed"] = _as_tensor(tree["unembed"])
    blocks = [b for b in tree["blocks"] if b is not None]
    period = len(blocks)
    repeats = 0
    for j, block in enumerate(blocks):
        for name, leaf in dotted_names(block).items():
            leaf = _as_tensor(leaf)
            repeats = leaf.shape[0]
            for r in range(repeats):
                out[f"{prefix}layers.{r * period + j}.{name}"] = leaf[r]
    for t, layer in enumerate(tree["tail"]):
        for name, leaf in dotted_names(layer).items():
            out[f"{prefix}layers.{repeats * period + t}.{name}"] = _as_tensor(leaf)
    return out


def lm_params_to_reference(named: dict, cfg: LMConfig, prefix: str = "") -> dict:
    """The inverse of ``lm_params_from_reference``: name -> tensor (params,
    or an optimizer moment keyed as the params) -> the reference's pytree,
    each block's leaves stacked over the repeats."""
    def layer(i):
        head = f"{prefix}layers.{i}."
        return nest_names({n[len(head):]: v for n, v in named.items() if n.startswith(head)})

    blocks = []
    for j in range(cfg.period):
        per = [layer(r * cfg.period + j) for r in range(cfg.repeats)]
        blocks.append(tree_map(lambda *xs: torch.stack(xs), *per) if per else None)
    tree = {
        "embed": named[f"{prefix}embed"],
        "blocks": blocks,
        "tail": [layer(cfg.repeats * cfg.period + t) for t in range(cfg.remainder)],
        "ln_out": {"scale": named[f"{prefix}ln_out.scale"]},
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = named[f"{prefix}unembed"]
    return tree


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _ffn(block: Block, h, cfg: LMConfig, token_axis: str):
    if cfg.moe is not None:
        return block.moe(h, token_axis)
    return block.mlp(h), torch.zeros((), device=h.device)


def _block_body(block: Block, x, cfg: LMConfig, window, positions):
    """One transformer block. Returns (y, aux_loss, (k, v))."""
    h = block.ln_attn(x)
    attn_out, kv = layers._self_attention(block.attn.params(), h, cfg.dims, positions, window,
                                          cfg.rope_theta, cfg.attn_chunk)
    x = x + attn_out
    h = block.ln_ffn(x)
    ffn_out, aux = _ffn(block, h, cfg, "all" if cfg.dp_layout else "data")
    return x + ffn_out, aux, kv


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: LMConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, context_fn=context)
    if cfg.remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def lm_hidden_states(model: Transformer, tokens: torch.Tensor,
                     cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> final hidden states [B, S, D] (+ aux loss, 0 for a
    dense model). Full-sequence forward; layer ``i`` attends with window
    ``cfg.layer_window(i)``, the tail layers continuing the pattern from 0."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = F.embedding(tokens, model.embed).to(cfg.dtype)
    aux = torch.zeros((), device=x.device)
    for i, block in enumerate(model.layers):
        layer = lambda x, _b=block, _w=cfg.layer_window(i): _block_body(  # noqa: E731
            _b, x, cfg, _w, positions)[:2]
        x, a = _remat_wrap(layer, cfg)(x)
        aux = aux + a
    return model.ln_out(x), aux


def _unembed(model: Transformer, cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return model.embed.T  # [D, V]
    return model.unembed


def lm_logits(model: Transformer, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    h, _ = lm_hidden_states(model, tokens, cfg)
    return (h @ _unembed(model, cfg)).float()


def lm_loss(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor, cfg: LMConfig):
    """Mean next-token cross entropy (+ aux). Labels < 0 are masked.

    With ``cfg.vocab_chunk > 0`` the unembed projection and log-softmax run
    over sequence chunks, so at most ``B * chunk * vocab`` logits exist at a
    time (forward; autograd keeps each chunk's for backward unless the
    layers are checkpointed).
    """
    h, aux = lm_hidden_states(model, tokens, cfg)
    B, S, D = h.shape
    w = _unembed(model, cfg)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()

    def chunk_loss(hc, lc, vc):
        logits = (hc @ w).float()  # [B, chunk, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.where(vc, logz - gold, 0.0)

    chunk = min(cfg.vocab_chunk, S) if cfg.vocab_chunk else 0
    if chunk and S > chunk and S % chunk == 0:
        total = torch.zeros((), device=h.device)
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            total = total + chunk_loss(h[:, sl], safe[:, sl], valid[:, sl]).sum()
    else:
        total = chunk_loss(h, safe, valid).sum()
    n = torch.clamp(valid.sum(), min=1)
    return total / n + 0.01 * aux, {"xent": total / n, "aux": aux, "tokens": n}


# --------------------------------------------------------------------------
# KV cache: prefill & decode
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of the KV cache for (cfg, max context)."""

    cfg: LMConfig
    batch: int
    seq_len: int  # max context the cache covers

    def lengths(self) -> list[int]:
        return [self.cfg.cache_len(j, self.seq_len) for j in range(self.cfg.period)]


def init_cache(spec: CacheSpec, dtype=None, device=None) -> dict:
    """Zero cache pytree on ``device`` (``cuda`` unless ``"cpu"``;
    ``"meta"``: shapes only).

    ``cache["blocks"][j]`` holds ``k/v: [R, B, Tj, K, hd]`` and ``pos: [R,
    B, Tj]`` (key positions; -1 = empty slot, masked out);
    ``cache["tail"][t]`` the same without the leading R. Sliding-window
    layers get ``Tj = window`` ring buffers.
    """
    cfg = spec.cfg
    dtype = dtype or cfg.dtype
    device = model_device(device)
    K, hd = cfg.n_kv_heads, cfg.d_head

    def one(r_axis: tuple, T: int):
        return {
            "k": torch.zeros(r_axis + (spec.batch, T, K, hd), dtype=dtype, device=device),
            "v": torch.zeros(r_axis + (spec.batch, T, K, hd), dtype=dtype, device=device),
            "pos": torch.full(r_axis + (spec.batch, T), -1, dtype=torch.int32, device=device),
        }

    blocks = [one((cfg.repeats,), spec.lengths()[j]) for j in range(cfg.period)]
    tail = [one((), spec.lengths()[t % cfg.period]) for t in range(cfg.remainder)]
    return {"blocks": blocks, "tail": tail}


def abstract_cache(spec: CacheSpec, dtype=None) -> dict:
    """The cache's tensors on the ``meta`` device: shapes and dtypes."""
    return init_cache(spec, dtype, "meta")


def _layer_entry(cache: dict, cfg: LMConfig, i: int) -> dict:
    """Layer ``i``'s cache entry: views into its block's stacked tensors."""
    if i < cfg.repeats * cfg.period:
        r, j = divmod(i, cfg.period)
        return {name: x[r] for name, x in cache["blocks"][j].items()}
    return cache["tail"][i - cfg.repeats * cfg.period]


def _cache_update(entry: dict, k_new, v_new, positions) -> dict:
    """Write [B, S_new] keys/values at ``positions`` into a ring-buffer
    cache entry, in place. A ring of T slots keeps the last T positions of a
    row (those the reference's last writes leave), so only they are written:
    no two writes meet in a slot."""
    T = entry["k"].shape[-3]
    if positions.shape[1] > T:
        k_new, v_new, positions = k_new[:, -T:], v_new[:, -T:], positions[:, -T:]
    slots = (positions % T).long()  # [B, S_new]
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    entry["k"][b_idx, slots] = k_new.to(entry["k"].dtype)
    entry["v"][b_idx, slots] = v_new.to(entry["v"].dtype)
    entry["pos"][b_idx, slots] = positions.to(entry["pos"].dtype)
    return entry


@torch.no_grad()
def lm_decode_step(model: Transformer, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                   cfg: LMConfig):
    """One decode step: ``tokens [B, 1]`` at position ``pos [B]``.

    Returns (logits [B, vocab], cache): every layer writes its new KV into
    the cache in place, then attends over its ring or full entry."""
    B = tokens.shape[0]
    positions = pos[:, None].to(torch.int32)  # [B, 1]
    x = F.embedding(tokens, model.embed).to(cfg.dtype)
    dims = cfg.dims
    for i, block in enumerate(model.layers):
        q, k, v, _ = layers._project_qkv(block.attn.params(), block.ln_attn(x), dims,
                                         positions, cfg.rope_theta)
        entry = _cache_update(_layer_entry(cache, cfg, i), k, v, positions)
        out = layers._attention_dense(q, entry["k"], entry["v"], positions, entry["pos"], dims,
                                      cfg.layer_window(i))
        x = x + out.reshape(B, 1, dims.n_heads * dims.d_head) @ block.attn.wo
        ffn_out, _ = _ffn(block, block.ln_ffn(x), cfg, "all")
        x = x + ffn_out
    h = model.ln_out(x)
    logits = (h[:, 0, :] @ _unembed(model, cfg)).float()
    return logits, cache


@torch.no_grad()
def lm_prefill(model: Transformer, tokens: torch.Tensor, cfg: LMConfig,
               cache_seq_len: int | None = None):
    """Full-sequence prefill producing (last-token logits, populated cache).

    The forward is the full causal pass; each layer's fresh KV is written
    into a cache sized for ``cache_seq_len`` (default: the prompt length)
    so decode can continue from it."""
    B, S = tokens.shape
    spec = CacheSpec(cfg, B, cache_seq_len or S)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    pos_b = positions[None, :].expand(B, S)
    x = F.embedding(tokens, model.embed).to(cfg.dtype)
    cache = init_cache(spec, device=tokens.device)
    for i, block in enumerate(model.layers):
        x, _, (k, v) = _block_body(block, x, cfg, cfg.layer_window(i), positions)
        _cache_update(_layer_entry(cache, cfg, i), k, v, pos_b)
    h = model.ln_out(x)
    logits = (h[:, -1, :] @ _unembed(model, cfg)).float()
    return logits, cache


# --------------------------------------------------------------------------
# FLOPs accounting (roofline MODEL_FLOPS)
# --------------------------------------------------------------------------


def train_step_model_flops(cfg: LMConfig, batch: int, seq: int) -> float:
    """6 * N_active * D + attention quadratic term, for one train step."""
    n = cfg.n_active_params()
    d_tokens = batch * seq
    base = 6.0 * n * d_tokens
    # attention scores+AV: 2 * 2 * B * S * S_eff * H * hd * 3 (fwd+bwd)
    attn = 0.0
    for layer in range(cfg.n_layers):
        w = cfg.layer_window(layer)
        s_eff = min(w, seq) if w > 0 else seq
        attn += 2.0 * 2.0 * batch * seq * (s_eff / (1 if w else 2)) * cfg.n_heads * cfg.d_head
    return base + 3.0 * attn  # fwd + 2x bwd


def decode_step_model_flops(cfg: LMConfig, batch: int, context: int) -> float:
    """One-token decode: 2 * N_active + attention over the cache."""
    base = 2.0 * cfg.n_active_params() * batch
    attn = 0.0
    for layer in range(cfg.n_layers):
        w = cfg.layer_window(layer)
        s_eff = min(w, context) if w > 0 else context
        attn += 2.0 * 2.0 * batch * s_eff * cfg.n_heads * cfg.d_head
    return base + attn
