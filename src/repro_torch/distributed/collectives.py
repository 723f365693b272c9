"""Distributed-optimization primitives: gradient compression, the port of
``repro.distributed.collectives``.

``int8`` block-quantized gradient compression with error feedback: at 1000+
node scale the data-parallel all-reduce of f32 gradients is the dominant
inter-pod collective; quantizing to int8 cuts those bytes 4x. Error feedback
(residual carried into the next step) keeps SGD/Adam convergence.

Two integration modes, as the reference's:
  * **transform mode** (``make_error_feedback_transform``): quantize and
    dequantize each gradient leaf inside the train step (the trainer's
    ``grad_transform``), so the convergence effect is testable on one
    device;
  * **wire mode** (``compressed_psum``): the int8 payload and per-block
    scales cross the group, an ``all_reduce`` MAX of the scales and an
    ``all_reduce`` SUM of the int32 re-quantized payload.

The arithmetic is the reference's in its order, so ``q`` and the scales
come out bit for bit (``torch.round``, like ``jnp.round``, rounds half to
even). In place of the reference's mesh axis name the two collectives take
a group, as ``repro_torch.core.topk``'s merges do: ``group=None`` is the
in-process path, where the caller passes every rank's operand in flat rank
order and gets every rank's result; a ``torch.distributed`` process group
takes this rank's operand and returns this rank's result.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.train.optim import param_tree
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256  # scale granularity (elements)
    enabled: bool = True


def _pad_len(n: int, block: int) -> int:
    return (n + block - 1) // block * block


def quantize_int8(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns (q[i8], scales[f32])."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    padded = torch.zeros((_pad_len(n, block),), dtype=torch.float32, device=x.device)
    padded[:n] = flat
    blocks = padded.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = math.prod(shape)
    deq = (q.to(torch.float32) * scales[:, None]).reshape(-1)[:n]
    return deq.reshape(tuple(shape)).to(dtype)


def compress_decompress(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    q, s = quantize_int8(x, block)
    return dequantize_int8(q, s, x.shape, x.dtype)


def make_error_feedback_transform(cfg: CompressionConfig = CompressionConfig()):
    """Stateful (functional) error-feedback compressor for grad trees
    (``repro_torch.train.tree``; a module's params are read as its
    ``named_parameters()`` dict, the trainer's grads of a module are keyed
    so too).

    Usage::

        compress, init_residual = make_error_feedback_transform()
        residual = init_residual(params)
        grads, residual = compress(grads, residual)
    """

    def init_residual(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        param_tree(params))

    def compress(grads, residual):
        def one(g, r):
            if not cfg.enabled:
                return g, r
            corrected = g.to(torch.float32) + r
            sent = compress_decompress(corrected, cfg.block)
            return sent.to(g.dtype), corrected - sent

        flat, treedef = flatten_with_paths(grads)
        pairs = [one(g, r) for (_, g), r in zip(flat, leaves(residual), strict=True)]
        return (unflatten(treedef, [p[0] for p in pairs]),
                unflatten(treedef, [p[1] for p in pairs]))

    return compress, init_residual


def _requantize(qs: Sequence[torch.Tensor], ss: Sequence[torch.Tensor],
                     s_max: torch.Tensor) -> list[torch.Tensor]:
    """Each rank's int8 payload re-quantized to the shared scale, in int32."""
    return [torch.round(q.to(torch.float32) * (s / torch.clamp_min(s_max, 1e-12))[:, None])
            .to(torch.int32) for q, s in zip(qs, ss)]


def compressed_psum(x, group: Optional[dist.ProcessGroup] = None, block: int = 256):
    """int8-wire psum: quantize -> sum the int32 re-quantized payload ->
    rescale by the group's largest scale of each block.

    The payload crossing the interconnect is int8-worth of mantissa (summed
    in int32 to avoid overflow across ranks) + one f32 scale per block: ~4x
    fewer bytes than an f32 psum for large tensors. The int32 sum is exact,
    so the result does not depend on the order of the ranks.

    ``group=None``: ``x`` is every rank's operand in flat rank order, and
    the result is the list of every rank's (equal) result, one tensor.
    Else ``x`` is this rank's operand and the result this rank's.
    """
    if group is None:
        xs = list(x)
        qs, ss = zip(*(quantize_int8(xi, block) for xi in xs))
        s_max = torch.stack(ss).amax(dim=0)
        total = torch.stack(_requantize(qs, ss, s_max)).sum(dim=0, dtype=torch.int32)
        out = dequantize_int8(total, s_max, xs[0].shape, xs[0].dtype)
        return [out] * len(xs)
    q, s = quantize_int8(x, block)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    (total,) = _requantize([q], [s], s_max)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return dequantize_int8(total, s_max, x.shape, x.dtype)


def reduce_scatter_grads(grads, group: Optional[dist.ProcessGroup] = None):
    """ZeRO-style grad sync: reduce-scatter instead of all-reduce.

    Each rank keeps only its slice of the summed gradient (the slice its
    optimizer partition owns, the tiled split of dim 0); 2x fewer bytes than
    all-reduce.

    ``group=None``: ``grads`` is every rank's grad tree in flat rank order,
    and the result every rank's tree of slices; each sum adds the ranks in
    rank order. Else ``grads`` is this rank's tree and the result this
    rank's slices, from ``reduce_scatter_tensor`` over ``group``, whose
    backend fixes the order of a float sum.
    """
    if group is None:
        trees = list(grads)
        n = len(trees)
        _, treedef = flatten_with_paths(trees[0])
        slices = []
        for gs in zip(*(leaves(t) for t in trees), strict=True):
            _check_split(gs[0].shape[0], n)
            total = gs[0]
            for g in gs[1:]:
                total = total + g
            slices.append(torch.chunk(total, n, dim=0))
        return [unflatten(treedef, [s[r] for s in slices]) for r in range(n)]

    n = dist.get_world_size(group)

    def one(g):
        _check_split(g.shape[0], n)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM, group=group)
        return out

    return tree_map(one, grads)


def _check_split(n: int, ranks: int) -> None:
    if n % ranks:
        raise ValueError(f"dim 0 of {n} does not split into {ranks} equal blocks")
