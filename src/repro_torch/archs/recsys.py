"""The four recsys architectures, DCN-v2, DIN, SASRec and Wide&Deep: the
port of ``repro.archs.recsys``.

Each model is (a large embedding table) -> (feature interaction) -> (a
small MLP). Each kind is an ``nn.Module`` (``DCNv2``, ``DIN``, ``SASRec``,
``WideDeep``) holding the reference's param pytree as a ``ParamTree``
(parameter names are the pytree's paths: ``cross.0.w``), and the model's
functions read that nest as the reference's read theirs:

  * ``init_params(gen, cfg, device)`` / ``abstract_params(cfg)`` (``meta``)
  * ``forward(params, batch, cfg) -> logits [B]``
  * ``loss(params, batch, cfg) -> (bce, metrics)``
  * ``score_candidates(params, batch, cfg) -> scores [n_cand]``: one query
    scored against every candidate as one batched contraction, feeding
    ``retrieve_topk``'s two-stage top-k (``core/topk.py``'s
    ``tiled_topk``, ties to the lowest index).

``recsys_params_from_reference`` and ``recsys_params_to_reference`` carry
the reference's pytree to a ``state_dict`` and back; a ``TrainState`` of a
model is checkpointed in the reference's layout.

Batch layouts (all dense and static):
  dcn-v2     dense [B,13] f32, sparse [B,26] i32, label [B]
  din        hist [B,100] i32, hist_mask [B,100] bool, target [B] i32, label
  sasrec     seq [B,50] i32, pos [B,50] i32, neg [B,50] i32, mask [B,50]
  wide-deep  sparse [B,40] i32, label [B]
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.archs import layers
from repro_torch.archs.embedding import TableSpec, embedding_lookup, fold_ids, init_table
from repro_torch.archs.transformer import model_device
from repro_torch.train.tree import dotted_names, nest_names

# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # dcn-v2 | din | sasrec | wide-deep
    table: TableSpec
    n_dense: int = 0
    mlp_dims: tuple[int, ...] = ()
    # dcn-v2
    n_cross_layers: int = 0
    # din
    attn_mlp_dims: tuple[int, ...] = ()
    seq_len: int = 0
    # sasrec
    n_blocks: int = 0
    n_heads: int = 1
    dtype: object = torch.float32

    @property
    def embed_dim(self) -> int:
        return self.table.dim

    def n_params(self) -> int:
        return int(sum(p.numel() for p in abstract_params(self).parameters()))


def _mlp_params(gen, dims: Sequence[int], dtype, device):
    return [
        {"w": layers.dense_init(gen, dims[i], dims[i + 1], dtype, device=device),
         "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
        for i in range(len(dims) - 1)
    ]


def _mlp_apply(ps, x, final_act: bool = False):
    for i, p in enumerate(ps):
        x = x @ p["w"] + p["b"]
        if i < len(ps) - 1 or final_act:
            x = F.relu(x)
    return x


# --------------------------------------------------------------------------
# init / the modules
# --------------------------------------------------------------------------


def _init_tree(gen, cfg: RecsysConfig, device) -> dict:
    p = {"table": init_table(gen, cfg.table, cfg.dtype, device)}
    d_embed_all = cfg.table.n_slots * cfg.embed_dim

    if cfg.kind == "dcn-v2":
        d0 = cfg.n_dense + d_embed_all
        p["cross"] = [
            {"w": layers.dense_init(gen, d0, d0, cfg.dtype, scale=0.01, device=device),
             "b": torch.zeros((d0,), dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_cross_layers)
        ]
        p["deep"] = _mlp_params(gen, (d0,) + cfg.mlp_dims, cfg.dtype, device)
        p["out"] = _mlp_params(gen, (d0 + cfg.mlp_dims[-1], 1), cfg.dtype, device)
    elif cfg.kind == "din":
        d = cfg.embed_dim
        p["attn"] = _mlp_params(gen, (4 * d,) + cfg.attn_mlp_dims + (1,), cfg.dtype, device)
        p["mlp"] = _mlp_params(gen, (3 * d,) + cfg.mlp_dims + (1,), cfg.dtype, device)
    elif cfg.kind == "sasrec":
        d = cfg.embed_dim
        p["pos_embed"] = layers.embed_init(gen, cfg.seq_len, d, cfg.dtype, device)
        dims = layers.AttnDims(cfg.n_heads, cfg.n_heads, d // cfg.n_heads)
        p["blocks"] = [
            {
                "ln1": layers.layernorm_params(d, cfg.dtype, device),
                "attn": layers.attn_params(gen, d, dims, cfg.dtype, device),
                "ln2": layers.layernorm_params(d, cfg.dtype, device),
                "ffn": _mlp_params(gen, (d, d, d), cfg.dtype, device),
            }
            for _ in range(cfg.n_blocks)
        ]
        p["ln_out"] = layers.layernorm_params(d, cfg.dtype, device)
    elif cfg.kind == "wide-deep":
        p["wide"] = (layers._randn(gen, (cfg.table.total_rows,), device) * 1e-3).to(cfg.dtype)
        p["deep"] = _mlp_params(gen, (d_embed_all,) + cfg.mlp_dims + (1,), cfg.dtype, device)
    else:
        raise ValueError(cfg.kind)
    return p


class RecsysModel(layers.ParamTree):
    """A recsys model's params (the reference's pytree, each leaf a
    parameter named by its path) and its config; ``forward(batch)`` gives
    the per-example logits."""

    def __init__(self, cfg: RecsysConfig, gen: torch.Generator | None = None, device=None):
        super().__init__(_init_tree(gen, cfg, model_device(device)))
        self.cfg = cfg

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, batch, self.cfg)

    def reference_tree(self, named: dict) -> dict:
        """name -> tensor (the params, or a moment keyed as the params) ->
        the reference's param pytree (checkpoints)."""
        return recsys_params_to_reference(named)

    def from_reference_tree(self, tree) -> dict:
        return recsys_params_from_reference(tree)


class DCNv2(RecsysModel):
    """DCN-v2: full-matrix cross layers beside a deep MLP."""


class DIN(RecsysModel):
    """DIN: target attention over the user's history."""


class SASRec(RecsysModel):
    """SASRec: causal self-attention over the item sequence."""


class WideDeep(RecsysModel):
    """Wide&Deep: an additive sparse-linear part beside a deep MLP."""


KINDS = {"dcn-v2": DCNv2, "din": DIN, "sasrec": SASRec, "wide-deep": WideDeep}


def init_params(gen: torch.Generator | None, cfg: RecsysConfig, device=None) -> RecsysModel:
    """The kind's module, drawn from ``gen`` (on the host, or on a CUDA
    generator's card) on ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``:
    shapes only)."""
    if cfg.kind not in KINDS:
        raise ValueError(cfg.kind)
    return KINDS[cfg.kind](cfg, gen, device)


def abstract_params(cfg: RecsysConfig) -> RecsysModel:
    return init_params(None, cfg, "meta")


def recsys_params_from_reference(tree) -> dict:
    """The reference's ``init_params`` pytree (numpy arrays or tensors) ->
    the port's ``state_dict``."""
    return {name: leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
            for name, leaf in dotted_names(tree).items()}


def recsys_params_to_reference(named: dict) -> dict:
    """The inverse of ``recsys_params_from_reference``."""
    return nest_names(named)


def _tree(params) -> dict:
    return params.tree() if isinstance(params, layers.ParamTree) else params


def _take(table, ids, spec: TableSpec):
    """Rows of single-slot ids ``[...]`` (folded into slot 0)."""
    return table[fold_ids(ids[..., None], spec)[..., 0].long()]


# ---- dcn-v2 ----------------------------------------------------------------


def _dcn_forward(p, dense, sparse, cfg: RecsysConfig):
    emb = embedding_lookup(p["table"], sparse, cfg.table)  # [B, S, D]
    x0 = torch.cat([dense.to(cfg.dtype), emb.reshape(emb.shape[0], -1)], dim=-1)
    x = x0
    for cp in p["cross"]:  # DCN-v2 full-matrix cross: x_{l+1} = x0 * (W x_l + b) + x_l
        x = x0 * (x @ cp["w"] + cp["b"]) + x
    deep = _mlp_apply(p["deep"], x0, final_act=True)
    return _mlp_apply(p["out"], torch.cat([x, deep], dim=-1))[:, 0]


# ---- din -------------------------------------------------------------------


def _din_attention(p, hist_e, target_e, mask, cfg: RecsysConfig):
    """Target attention: score each history item against the target."""
    B, L, D = hist_e.shape
    t = target_e[:, None, :].expand(B, L, D)
    feats = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    logits = _mlp_apply(p["attn"], feats)[..., 0]  # [B, L]
    logits = torch.where(mask, logits, -torch.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)  # all-masked rows
    return torch.einsum("bl,bld->bd", w.to(hist_e.dtype), hist_e)


def _din_forward(p, hist, hist_mask, target, cfg: RecsysConfig):
    hist_e = _take(p["table"], hist, cfg.table)  # [B, L, D]
    tgt_e = _take(p["table"], target, cfg.table)  # [B, D]
    user = _din_attention(p, hist_e, tgt_e, hist_mask, cfg)
    x = torch.cat([user, tgt_e, user * tgt_e], dim=-1)
    return _mlp_apply(p["mlp"], x)[:, 0]


# ---- sasrec ----------------------------------------------------------------


def _sasrec_hidden(p, seq, mask, cfg: RecsysConfig):
    B, L = seq.shape
    x = _take(p["table"], seq, cfg.table) + p["pos_embed"][None, :L, :]
    x = torch.where(mask[..., None], x, 0.0)
    positions = torch.arange(L, dtype=torch.int32, device=seq.device)
    dims = layers.AttnDims(cfg.n_heads, cfg.n_heads, cfg.embed_dim // cfg.n_heads)
    pos_b = positions[None, :].expand(B, L)
    for blk in p["blocks"]:
        h = layers.layernorm(blk["ln1"], x)
        # SASRec uses causal self-attention without RoPE (learned positions)
        q = (h @ blk["attn"]["wq"]).reshape(B, L, dims.n_heads, dims.d_head)
        k = (h @ blk["attn"]["wk"]).reshape(B, L, dims.n_kv_heads, dims.d_head)
        v = (h @ blk["attn"]["wv"]).reshape(B, L, dims.n_kv_heads, dims.d_head)
        out = layers._attention_dense(q, k, v, pos_b, pos_b, dims, 0)
        x = x + out.reshape(B, L, -1) @ blk["attn"]["wo"]
        h = layers.layernorm(blk["ln2"], x)
        x = x + _mlp_apply(blk["ffn"], h, final_act=False)
        x = torch.where(mask[..., None], x, 0.0)
    return layers.layernorm(p["ln_out"], x)  # [B, L, D]


def _sasrec_pair_logits(p, seq, mask, pos, neg, cfg: RecsysConfig):
    h = _sasrec_hidden(p, seq, mask, cfg)
    pe = _take(p["table"], pos, cfg.table)
    ne = _take(p["table"], neg, cfg.table)
    return torch.sum(h * pe, -1), torch.sum(h * ne, -1)  # [B, L] each


# ---- wide & deep -----------------------------------------------------------


def _wide_deep_forward(p, sparse, cfg: RecsysConfig):
    rows = fold_ids(sparse, cfg.table).long()  # [B, S]
    wide = p["wide"][rows].sum(dim=-1)  # additive sparse linear
    emb = p["table"][rows]  # [B, S, D]
    deep = _mlp_apply(p["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return wide.float() + deep.float()


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Per-example logits [B] (sasrec: [B, L] positive logits)."""
    p = _tree(params)
    if cfg.kind == "dcn-v2":
        return _dcn_forward(p, batch["dense"], batch["sparse"], cfg)
    if cfg.kind == "din":
        return _din_forward(p, batch["hist"], batch["hist_mask"], batch["target"], cfg)
    if cfg.kind == "sasrec":
        pos_l, _ = _sasrec_pair_logits(p, batch["seq"], batch["mask"], batch["pos"],
                                       batch["neg"], cfg)
        return pos_l
    if cfg.kind == "wide-deep":
        return _wide_deep_forward(p, batch["sparse"], cfg)
    raise ValueError(cfg.kind)


def loss(params, batch, cfg: RecsysConfig):
    """BCE training loss (sasrec: pairwise BCE over pos/neg next items)."""
    if cfg.kind == "sasrec":
        pos_l, neg_l = _sasrec_pair_logits(_tree(params), batch["seq"], batch["mask"],
                                           batch["pos"], batch["neg"], cfg)
        m = batch["mask"].float()
        per = -F.logsigmoid(pos_l) - F.logsigmoid(-neg_l)
        total = (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        return total, {"bce": total}
    logits = forward(params, batch, cfg).float()
    y = batch["label"].float()
    per = torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    total = per.mean()
    return total, {"bce": total, "mean_logit": logits.mean()}


def score_candidates(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """``retrieval_cand``: one query vs ``n_cand`` candidates, f32[n_cand].

    Candidates enter as raw slot-0/item ids; user-side features broadcast.
    Every model reduces to one batched contraction over the candidate axis.
    """
    p = _tree(params)
    cand = batch["candidates"]  # i32[n_cand]
    n = cand.shape[0]
    if cfg.kind == "sasrec":
        h = _sasrec_hidden(p, batch["seq"], batch["mask"], cfg)[:, -1, :]  # [1, D]
        ce = _take(p["table"], cand, cfg.table)
        return (ce @ h[0]).float()  # matvec over every candidate
    if cfg.kind == "din":
        hist_e = _take(p["table"], batch["hist"], cfg.table)  # [1, L, D]
        tgt_e = _take(p["table"], cand, cfg.table)
        hist_b = hist_e.expand((n,) + hist_e.shape[1:])
        mask_b = batch["hist_mask"].expand((n,) + batch["hist_mask"].shape[1:])
        user = _din_attention(p, hist_b, tgt_e, mask_b, cfg)
        x = torch.cat([user, tgt_e, user * tgt_e], dim=-1)
        return _mlp_apply(p["mlp"], x)[:, 0].float()
    if cfg.kind in ("dcn-v2", "wide-deep"):
        sparse = batch["sparse"].expand(n, batch["sparse"].shape[-1]).clone()
        sparse[:, 0] = cand  # slot 0 = item id
        if cfg.kind == "wide-deep":
            return _wide_deep_forward(p, sparse, cfg).float()
        dense = batch["dense"].expand(n, batch["dense"].shape[-1])
        return _dcn_forward(p, dense, sparse, cfg).float()
    raise ValueError(cfg.kind)


def retrieve_topk(params, batch, cfg: RecsysConfig, k: int = 100, num_tiles: int = 64):
    """score_candidates + the shared two-stage top-k (paper's top-k problem)."""
    from repro_torch.core.topk import tiled_topk

    scores = score_candidates(params, batch, cfg)
    return tiled_topk(scores, k, num_tiles)


def train_step_model_flops(cfg: RecsysConfig, batch: int) -> float:
    """6 * active-params-excluding-table + lookup bytes don't count as FLOPs."""
    p = abstract_params(cfg)
    dense_params = sum(x.numel() for name, x in p.named_parameters()
                       if "table" not in name and "wide" not in name)
    seq_mult = cfg.seq_len if cfg.kind in ("din", "sasrec") and cfg.seq_len else 1
    # MLP/cross work is per-example; DIN attention MLP runs per history item
    per_ex = dense_params * (seq_mult if cfg.kind == "din" else 1)
    if cfg.kind == "sasrec":
        per_ex = dense_params * cfg.seq_len
    return 6.0 * per_ex * batch
