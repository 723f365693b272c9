"""Shared neural building blocks: the port of ``repro.archs.layers``.

Each layer is a plain function over a dict of tensors in the reference's
layout (weights ``[d_in, d_out]``, applied as ``x @ w``), and an
``nn.Module`` (``RMSNorm``, ``Attention``, ``SwiGLU``) that holds those
tensors as parameters under the reference's names and calls the function.
Initializers take an explicit ``torch.Generator``; they draw from the same
distributions as the reference's, not the same numbers.

Attention is written out as the reference's einsums (``_attention_dense``),
not a fused library call: the encoders feed padding tokens through
attention unmasked, as the reference does, and the fully masked rows of a
window are zeroed, not left as NaN. ``MoEConfig``/``moe`` are not ported
yet (the encoder does not use them).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def _randn(gen: torch.Generator | None, shape: tuple, device) -> torch.Tensor:
    """Standard normals drawn on the host from ``gen`` and moved to
    ``device``, so one seed gives the same weights on every device; on the
    ``meta`` device only the shape."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen).to(device)


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, dtype=torch.float32,
               scale: float | None = None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_randn(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen: torch.Generator | None, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return (_randn(gen, (vocab, d), device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm_params(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_params(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(rmsnorm_params(d, dtype, device)["scale"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm({"scale": self.scale}, x, self.eps)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, n_heads, d_head]; positions: broadcastable to [..., seq]."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)  # [d/2]
    angles = positions[..., :, None].float() * freqs  # [..., seq, d/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA / MQA / sliding-window)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    d_head: int

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def attn_params(gen: torch.Generator, d_model: int, dims: AttnDims, dtype=torch.float32,
                device=None) -> dict:
    return {
        "wq": dense_init(gen, d_model, dims.n_heads * dims.d_head, dtype, device=device),
        "wk": dense_init(gen, d_model, dims.n_kv_heads * dims.d_head, dtype, device=device),
        "wv": dense_init(gen, d_model, dims.n_kv_heads * dims.d_head, dtype, device=device),
        "wo": dense_init(gen, dims.n_heads * dims.d_head, d_model, dtype, device=device),
    }


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """bool[..., q, k]: causality/window mask, over any leading batch dims.

    ``window`` semantics: 0 = global causal; W>0 = causal sliding window W;
    -1 = **bidirectional** (the SPLADE/uniCOIL encoders). Key positions < 0
    denote empty cache slots and are always masked.
    """
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    nonneg = kp >= 0
    if window < 0:
        return nonneg.expand(torch.broadcast_shapes(qp.shape, kp.shape))
    causal = kp <= qp
    in_window = (qp - kp) < (window if window > 0 else 2**30)
    return nonneg & causal & in_window


def multihead_attention(
    params,
    x: torch.Tensor,  # [B, S, D]
    dims: AttnDims,
    *,
    positions: torch.Tensor,  # [B, S] or [S]
    window: int = 0,
    rope_theta: float = 10000.0,
    chunk_size: int = 0,
) -> torch.Tensor:
    """GQA attention of the sequence to itself; ``chunk_size>0`` switches to
    the blockwise online-softmax path. (The reference's ``kv_override``
    serves the KV cache, which is not ported yet.)"""
    B, S, D = x.shape
    q = (x @ params["wq"]).reshape(B, S, dims.n_heads, dims.d_head)
    k = (x @ params["wk"]).reshape(B, S, dims.n_kv_heads, dims.d_head)
    v = (x @ params["wv"]).reshape(B, S, dims.n_kv_heads, dims.d_head)
    if positions.ndim == 1:
        positions = positions[None, :].expand(B, S)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if chunk_size and S > chunk_size:
        out = _attention_chunked(q, k, v, positions, positions, dims, window, chunk_size)
    else:
        out = _attention_dense(q, k, v, positions, positions, dims, window)
    return out.reshape(B, S, dims.n_heads * dims.d_head) @ params["wo"]


def _attention_dense(q, k, v, q_pos, k_pos, dims: AttnDims, window: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    g = dims.group
    qg = q.reshape(B, S, dims.n_kv_heads, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    mask = _causal_window_mask(q_pos, k_pos, window)  # [B, S, T]
    scores = torch.where(mask[:, None, None, :, :], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    # rows with no visible keys (cache padding) give NaN; zero them
    probs = torch.where(torch.isnan(probs), 0.0, probs).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def _attention_chunked(q, k, v, q_pos, k_pos, dims: AttnDims, window: int,
                       chunk: int) -> torch.Tensor:
    """Blockwise online-softmax attention (flash-style), O(S*chunk) memory.

    KV is walked in chunks with a running (max, denominator, numerator);
    each chunk's body is checkpointed, so backward keeps no chunk's
    ``[S, chunk]`` probabilities, as the reference's checkpointed scan.
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    if T % chunk:
        raise ValueError(f"key length {T} is not a multiple of the chunk {chunk}")
    g = dims.group
    qg = q.reshape(B, S, dims.n_kv_heads, g, hd)

    def body(m, denom, num, kc, vc, kpc):
        s = torch.einsum("bskgh,btkh->bkgst", qg, kc).float() / math.sqrt(hd)
        mask = _causal_window_mask(q_pos, kpc, window)
        s = torch.where(mask[:, None, None, :, :], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        denom = denom * alpha + p.sum(dim=-1)
        num = num * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh", p.to(vc.dtype), vc)
        return m_new, denom, num

    m = torch.full((B, dims.n_kv_heads, g, S), -torch.inf, device=q.device)
    denom = torch.zeros((B, dims.n_kv_heads, g, S), device=q.device)
    num = torch.zeros((B, dims.n_kv_heads, g, S, hd), device=q.device)
    for lo in range(0, T, chunk):
        sl = slice(lo, lo + chunk)
        m, denom, num = checkpoint(body, m, denom, num, k[:, sl], v[:, sl], k_pos[:, sl],
                                   use_reentrant=False)
    out = num / torch.clamp(denom[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


class Attention(nn.Module):
    """The projections ``wq``, ``wk``, ``wv``, ``wo`` (reference layout)
    around ``multihead_attention``."""

    def __init__(self, gen: torch.Generator, d_model: int, dims: AttnDims, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dims = dims
        for name, w in attn_params(gen, d_model, dims, dtype, device).items():
            setattr(self, name, nn.Parameter(w))

    def params(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def forward(self, x, *, positions, window: int = 0, rope_theta: float = 10000.0,
                chunk_size: int = 0):
        return multihead_attention(self.params(), x, self.dims, positions=positions,
                                   window=window, rope_theta=rope_theta, chunk_size=chunk_size)


# --------------------------------------------------------------------------
# FFN: SwiGLU
# --------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
               device=None) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


class SwiGLU(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        for name, w in mlp_params(gen, d_model, d_ff, dtype, device).items():
            setattr(self, name, nn.Parameter(w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp({"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}, x)
