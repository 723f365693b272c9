"""Transformer stack: the port of the training forward of
``repro.archs.transformer``.

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
are kept so a config carries over, and they change nothing. The KV cache,
prefill, decode and MoE layers are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.archs import layers
from repro_torch.archs.layers import AttnDims
from repro_torch.device import resolve_device

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
    moe: Optional[Any] = None  # MoE layers are not ported yet: must be None
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
        if self.moe is not None:
            raise NotImplementedError("MoE layers are not ported yet")
        d, hd = self.d_model, self.d_head
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d  # 2 rmsnorm scales
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        return self.n_layers * per_layer + embed + head + d  # final norm

    def n_active_params(self) -> int:
        """Active-per-token params: every param of a dense model."""
        return self.n_params()


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
    """One transformer layer: pre-norm attention and pre-norm SwiGLU."""

    def __init__(self, gen: torch.Generator | None, cfg: LMConfig, device=None):
        super().__init__()
        self.ln_attn = layers.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.ln_ffn = layers.RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
        self.attn = layers.Attention(gen, cfg.d_model, cfg.dims, cfg.dtype, device)
        self.mlp = layers.SwiGLU(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device)


class Transformer(nn.Module):
    """Embedding (tied to the head), ``n_layers`` blocks, final RMSNorm."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator | None = None, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError("MoE layers are not ported yet")
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


def init_lm_params(gen: torch.Generator | None, cfg: LMConfig, device=None) -> Transformer:
    """A ``Transformer`` with the reference's init distributions, drawn from
    ``gen`` on the host and placed on ``device`` (``cuda`` unless
    ``"cpu"``; ``"meta"``: shapes only)."""
    return Transformer(cfg, gen, device)


# --------------------------------------------------------------------------
# reference param pytrees
# --------------------------------------------------------------------------


def _layer_leaves(prefix: str) -> dict:
    """Reference leaf path (within one layer) -> the port's param name."""
    out = {("ln_attn", "scale"): f"{prefix}ln_attn.scale",
           ("ln_ffn", "scale"): f"{prefix}ln_ffn.scale"}
    out.update({("attn", w): f"{prefix}attn.{w}" for w in ("wq", "wk", "wv", "wo")})
    out.update({("mlp", w): f"{prefix}mlp.{w}" for w in ("w_gate", "w_up", "w_down")})
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def lm_params_from_reference(tree, prefix: str = "") -> dict:
    """The reference's ``init_lm_params`` pytree (numpy arrays or tensors)
    -> the port's ``state_dict`` (name -> tensor). Leaves of
    ``tree["blocks"][j]`` carry a leading ``[repeats]`` axis; layer
    ``r * period + j`` takes row ``r`` of block ``j``, and the tail layers
    follow."""
    out = {f"{prefix}embed": _as_tensor(tree["embed"]),
           f"{prefix}ln_out.scale": _as_tensor(tree["ln_out"]["scale"])}
    if "unembed" in tree:
        out[f"{prefix}unembed"] = _as_tensor(tree["unembed"])
    blocks = [b for b in tree["blocks"] if b is not None]
    period = len(blocks)
    repeats = _as_tensor(blocks[0]["ln_attn"]["scale"]).shape[0] if blocks else 0
    for j, block in enumerate(blocks):
        for r in range(repeats):
            for (a, b), name in _layer_leaves(f"{prefix}layers.{r * period + j}.").items():
                out[name] = _as_tensor(block[a][b])[r]
    for t, layer in enumerate(tree["tail"]):
        for (a, b), name in _layer_leaves(f"{prefix}layers.{repeats * period + t}.").items():
            out[name] = _as_tensor(layer[a][b])
    return out


def lm_params_to_reference(named: dict, cfg: LMConfig, prefix: str = "") -> dict:
    """The inverse of ``lm_params_from_reference``: name -> tensor (params,
    or an optimizer moment keyed as the params) -> the reference's pytree,
    each block's leaves stacked over the repeats."""
    def layer(i):
        tree: dict = {}
        for (a, b), name in _layer_leaves(f"{prefix}layers.{i}.").items():
            tree.setdefault(a, {})[b] = named[name]
        return tree

    blocks = []
    for j in range(cfg.period):
        per = [layer(r * cfg.period + j) for r in range(cfg.repeats)]
        blocks.append({a: {b: torch.stack([p[a][b] for p in per]) for b in per[0][a]}
                       for a in per[0]} if per else None)
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


def _block_body(block: Block, x, cfg: LMConfig, window, positions):
    """One transformer block. Returns (y, aux_loss). (The reference's also
    returns the layer's (k, v) for the KV cache, which is not ported yet.)"""
    h = block.ln_attn(x)
    x = x + block.attn(h, positions=positions, window=window, rope_theta=cfg.rope_theta,
                       chunk_size=cfg.attn_chunk)
    h = block.ln_ffn(x)
    return x + block.mlp(h), torch.zeros((), device=x.device)


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
    ``cfg.layer_window(i)``."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = model.embed[tokens].to(cfg.dtype)
    aux = torch.zeros((), device=x.device)
    for i, block in enumerate(model.layers):
        layer = lambda x, _b=block, _w=cfg.layer_window(i): _block_body(  # noqa: E731
            _b, x, cfg, _w, positions)
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
