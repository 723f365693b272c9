"""Shared neural building blocks: the port of ``repro.archs.layers``.

Each layer is a plain function over a dict of tensors in the reference's
layout (weights ``[d_in, d_out]``, applied as ``x @ w``), and an
``nn.Module`` (``RMSNorm``, ``Attention``, ``SwiGLU``) that holds those
tensors as parameters under the reference's names and calls the function.
Initializers take an explicit ``torch.Generator``; they draw from the same
distributions as the reference's, not the same numbers. A host generator
(the default) gives the same weights on every device; a CUDA generator
draws on its card, which a model of billions of weights needs.

Attention is written out as the reference's einsums (``_attention_dense``),
not a fused library call: the encoders feed padding tokens through
attention unmasked, as the reference does, and the fully masked rows of a
window are zeroed, not left as NaN.

The MoE layer (``MoEConfig``, ``moe_params``, ``moe``, the ``MoE``
module) is the reference's GShard dispatch step for step: groups, the
capacity rounded up to 8, a stable sort of the chosen experts, tokens past
an expert's capacity dropped (their slot aliases slot 0 with a zero
update), the Switch load-balance loss plus the router z-loss.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import ambient_axis_size
from repro_torch.train.tree import nest_names

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def _randn(gen: torch.Generator | None, shape: tuple, device) -> torch.Tensor:
    """Standard normals drawn from ``gen`` where it lives and moved to
    ``device``: a host generator (or ``None``) gives the same weights on
    every device, a CUDA generator draws on its card; on the ``meta``
    device only the shape."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    where = gen.device if gen is not None else "cpu"
    return torch.randn(shape, generator=gen, device=where).to(device)


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
    serves its KV cache; the port's cache is ``archs/transformer.py``'s.)"""
    return _self_attention(params, x, dims, positions, window, rope_theta, chunk_size)[0]


def _project_qkv(params, x: torch.Tensor, dims: AttnDims, positions: torch.Tensor,
                 rope_theta: float):
    """The rope'd q, k and v of ``x`` [B, S, D] at ``positions`` ([B, S] or
    [S]), and the positions as [B, S]."""
    B, S, D = x.shape
    q = (x @ params["wq"]).reshape(B, S, dims.n_heads, dims.d_head)
    k = (x @ params["wk"]).reshape(B, S, dims.n_kv_heads, dims.d_head)
    v = (x @ params["wv"]).reshape(B, S, dims.n_kv_heads, dims.d_head)
    if positions.ndim == 1:
        positions = positions[None, :].expand(B, S)
    return (apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v,
            positions)


def _self_attention(params, x, dims: AttnDims, positions, window: int, rope_theta: float,
                    chunk_size: int):
    """``multihead_attention``'s output and the rope'd (k, v) it attended
    over (a KV cache's entries)."""
    B, S, D = x.shape
    q, k, v, positions = _project_qkv(params, x, dims, positions, rope_theta)
    if chunk_size and S > chunk_size:
        out = _attention_chunked(q, k, v, positions, positions, dims, window, chunk_size)
    else:
        out = _attention_dense(q, k, v, positions, positions, dims, window)
    return out.reshape(B, S, dims.n_heads * dims.d_head) @ params["wo"], (k, v)


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


# --------------------------------------------------------------------------
# MoE: GShard-style top-k dispatch (sort/scatter into capacity slots)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek style
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    # dispatch groups (GShard): tokens split into G groups, each sorted and
    # scattered on its own. 0 = one group a card, so 1 on one card.
    n_groups: int = 0


def moe_params(gen: torch.Generator | None, d_model: int, cfg: MoEConfig, dtype=torch.float32,
               device=None) -> dict:
    E, F = cfg.n_experts, cfg.d_expert_ff
    p = {
        "router": dense_init(gen, d_model, E, torch.float32, device=device),
        "w_gate": (_randn(gen, (E, d_model, F), device) / math.sqrt(d_model)).to(dtype),
        "w_up": (_randn(gen, (E, d_model, F), device) / math.sqrt(d_model)).to(dtype),
        "w_down": (_randn(gen, (E, F, d_model), device) / math.sqrt(F)).to(dtype),
    }
    if cfg.n_shared:
        p["shared"] = mlp_params(gen, d_model, cfg.d_expert_ff * cfg.n_shared, dtype, device)
    return p


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """An expert's slots a group, from Python floats as the reference's."""
    return _round_up(max(int(tokens_per_group * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor), 1), 8)


def _dispatch_one_group(xg: torch.Tensor, logits_g: torch.Tensor, cfg: MoEConfig, C: int,
                        dtype):
    """Local (per-group) top-k sort/scatter dispatch. xg: [Tg, D]. Returns
    the ``[E, C, D]`` buffer and the route ``(gate, keep, slot, tok,
    flat_e)``."""
    Tg, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(logits_g, dim=-1)
    # a stable descending sort: ties go to the lowest expert, as lax.top_k
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[:, :K], choice[:, :K]  # [Tg, K]
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(dtype)
    flat_e = choice.reshape(Tg * K)
    order = torch.sort(flat_e, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(Tg * K, device=xg.device)
    counts = torch.bincount(flat_e, minlength=E)
    expert_base = torch.cumsum(counts, 0) - counts
    pos_in_expert = ranks - expert_base[flat_e]
    keep = pos_in_expert < C
    tok = torch.arange(Tg, device=xg.device).repeat_interleave(K)
    # xg[tok], as a broadcast: its gradient is a sum over K, not a scatter
    updates = xg[:, None, :].expand(Tg, K, D).reshape(Tg * K, D) * keep[:, None].to(dtype)
    # a drop's slot aliases slot 0 with a zero update
    slot = torch.where(keep, flat_e * C + pos_in_expert, 0)
    buf = torch.zeros((E * C, D), dtype=dtype, device=xg.device).index_add(0, slot, updates)
    return buf.reshape(E, C, D), (gate, keep, slot, tok, flat_e)


def _combine_one_group(out_e: torch.Tensor, route, Tg: int, D: int, dtype) -> torch.Tensor:
    gate, keep, slot, _, _ = route
    # slot 0 aliases drops, and the keep mask zeroes them (and their
    # gradients, so the gradient's adds into slot 0 are exact in any order)
    y = torch.index_select(out_e.reshape(-1, D), 0, slot)
    y = y * (gate.reshape(-1, 1) * keep[:, None].to(dtype))
    # a token's K entries are adjacent (tok = repeat(arange(Tg), K)): their
    # sum is a reduction over K, with no atomics on the card
    return y.reshape(Tg, -1, D).sum(dim=1)


def moe(params, x: torch.Tensor, cfg: MoEConfig,
        token_axis: str = "all") -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped top-k MoE (GShard dispatch). Tokens are split into ``G``
    groups (``cfg.n_groups``; 0 means one group a rank of ``token_axis``
    under the ambient mesh, ``repro_torch.distributed.sharding.use_mesh``,
    and one group outside a mesh; a ``T`` that ``G`` does not divide falls
    back to one group); each group sorts
    and scatters its tokens into its ``[E, C, D]`` capacity slice, with
    ``C = round_up(max(int(Tg * K / E * capacity_factor), 1), 8)``, and
    tokens past an expert's capacity are dropped. Returns (output,
    aux_loss): the Switch load-balance loss plus the router z-loss."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"]  # [T, E]

    G = cfg.n_groups or max(ambient_axis_size(token_axis), 1)
    if T % G != 0:
        G = 1
    Tg = T // G
    C = _capacity(Tg, cfg)
    xg = xt.reshape(G, Tg, D)
    lg = logits.reshape(G, Tg, E)
    dispatched = [_dispatch_one_group(xg[g], lg[g], cfg, C, x.dtype) for g in range(G)]
    buf = torch.stack([b for b, _ in dispatched])  # [G, E, C, D]
    a = F.silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"]))
    a = a * torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    out_e = torch.einsum("gecf,efd->gecd", a, params["w_down"])
    y = torch.cat([_combine_one_group(out_e[g], route, Tg, D, x.dtype)
                   for g, (_, route) in enumerate(dispatched)])

    if cfg.n_shared:
        y = y + mlp(params["shared"], xt)

    # load-balance aux loss (Switch) + router z-loss, over every token
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)  # [E]
    flat_e = torch.cat([route[4] for _, route in dispatched])
    ce = torch.bincount(flat_e, minlength=E).float() / (T * K)
    aux = E * torch.sum(me * ce) + cfg.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return y.reshape(B, S, D), aux


class MoE(nn.Module):
    """The router ``[d_model, E]`` (f32), the experts' ``w_gate``/``w_up``
    ``[E, d_model, F]`` and ``w_down`` ``[E, F, d_model]``, and, with
    ``n_shared``, the shared experts as a ``SwiGLU`` (``shared``), around
    ``moe``."""

    def __init__(self, gen: torch.Generator | None, d_model: int, cfg: MoEConfig,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        p = moe_params(gen, d_model, dataclasses.replace(cfg, n_shared=0), dtype, device)
        for name, w in p.items():
            setattr(self, name, nn.Parameter(w))
        if cfg.n_shared:
            self.shared = SwiGLU(gen, d_model, cfg.d_expert_ff * cfg.n_shared, dtype, device)

    def params(self) -> dict:
        p = {"router": self.router, "w_gate": self.w_gate, "w_up": self.w_up,
             "w_down": self.w_down}
        if self.cfg.n_shared:
            p["shared"] = {"w_gate": self.shared.w_gate, "w_up": self.shared.w_up,
                           "w_down": self.shared.w_down}
        return p

    def forward(self, x: torch.Tensor,
                token_axis: str = "all") -> tuple[torch.Tensor, torch.Tensor]:
        return moe(self.params(), x, self.cfg, token_axis)


# --------------------------------------------------------------------------
# a nest of parameters
# --------------------------------------------------------------------------


def _param_node(value):
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, torch.Tensor) for v in value):
            return nn.ParameterList([nn.Parameter(v) for v in value])
        return nn.ModuleList([_param_node(v) for v in value])
    return nn.Parameter(value)


class ParamTree(nn.Module):
    """A nest of dicts and lists of tensors held as parameters, each named by
    its path in the nest (``cross.0.w``): a dict is a module with an
    attribute a key, a list an ``nn.ModuleList``. The GNN and recsys models
    are such nests in the reference's layout; ``tree()`` is the nest of the
    parameters themselves, which the model's functions read."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            setattr(self, key, _param_node(value))

    def tree(self) -> dict:
        return nest_names(dict(self.named_parameters()))
