"""AdamW and LR schedules, from scratch: the port of ``repro.train.optim``.

The reference's arithmetic, step for step: the schedule, the global-norm
clip, the bias correction ``(m / c1) / (sqrt(v / c2) + eps)`` and the
decoupled weight decay. ``torch.optim.AdamW`` is not used: its schedule,
clip and the order of its bias correction differ. Moments are f32 whatever
the params' dtype.

``params`` is a pytree of tensors (``repro_torch.train.tree``) or an
``nn.Module``; for a module, grads and moments are dicts keyed by
``named_parameters()`` names, and ``adamw_update`` writes the new values
into the module's parameters and the moments in place, a leaf at a time
(the reference returns new arrays), and returns the module and the state
holding those moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.train.tree import flatten_with_paths, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    schedule: str = "warmup_cosine"  # constant | warmup_cosine | warmup_linear
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    m: Any  # pytree like params, f32
    v: Any  # pytree like params, f32
    count: torch.Tensor  # i32[]


def param_tree(params):
    """The pytree view of ``params``: a module's ``named_parameters()`` as a
    dict, any other pytree as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _device(tree) -> torch.device:
    flat = leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    tree = param_tree(params)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)
    return AdamWState(m=zeros, v=tree_map(torch.clone, zeros),
                      count=torch.zeros((), dtype=torch.int32, device=_device(tree)))


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.ones((), device=s.device)
    elif cfg.schedule == "warmup_linear":
        t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        frac = 1.0 - (1.0 - cfg.min_lr_frac) * t
    else:  # warmup_cosine
        t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params,
                 cfg: AdamWConfig) -> tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, metrics). Decoupled weight decay."""
    if cfg.grad_clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    lr = schedule_lr(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (step + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m_new, v_new

    p_flat, treedef = flatten_with_paths(param_tree(params))
    others = [leaves(t) for t in (grads, state.m, state.v)]
    if any(len(o) != len(p_flat) for o in others):
        raise ValueError("grads, moments and params differ in structure")
    if isinstance(params, nn.Module):
        # a leaf at a time, in place: a model of billions of params never
        # holds a second copy of its params or moments
        for (_, p), g, m, v in zip(p_flat, *others):
            p_new, m_new, v_new = upd(p, g, m, v)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, AdamWState(state.m, state.v, count), {"lr": lr, "grad_norm": gnorm}
    triples = [upd(p, g, m, v) for (_, p), g, m, v in zip(p_flat, *others)]
    new_p = unflatten(treedef, [t[0] for t in triples])
    new_m = unflatten(treedef, [t[1] for t in triples])
    new_v = unflatten(treedef, [t[2] for t in triples])
    return new_p, AdamWState(new_m, new_v, count), {"lr": lr, "grad_norm": gnorm}
