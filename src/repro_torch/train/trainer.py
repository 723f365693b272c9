"""Generic trainer: ``TrainState`` and the train-step factory, the port of
``repro.train.trainer``.

Autograd (``torch.autograd.grad``) takes the place of ``jax.value_and_grad``;
the step runs eagerly, so there is nothing to jit. Features:

  * gradient accumulation over ``grad_accum`` micro-batches (a Python loop
    for the reference's ``lax.scan``), summed in f32, each divided by
    ``grad_accum``;
  * mixed precision: params may be bf16, moments are f32 (``optim.py``);
  * an optional gradient transform hook (e.g. compression with error
    feedback).

``params`` is a pytree of tensors or an ``nn.Module``. A module's
parameters and moments are updated in place; its grads and moments are
dicts keyed by parameter name. A module that defines
``reference_tree(named)`` and ``from_reference_tree(tree)`` (the sparse
encoder, the LM, GNN and recsys models) is checkpointed in the reference's
param layout, so a checkpoint either package wrote restores in the other.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.train.optim import AdamWConfig, AdamWState, adamw_init, adamw_update, param_tree
from repro_torch.train.tree import flatten_with_paths, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any  # a pytree of tensors, or an nn.Module
    opt: AdamWState
    step: torch.Tensor  # i32[]

    def to_tree(self) -> "TrainState":
        """This state as a pytree of tensors in the reference's layout."""
        conv = getattr(self.params, "reference_tree", None)
        if conv is None:
            return dataclasses.replace(self, params=param_tree(self.params))
        return TrainState(conv(param_tree(self.params)),
                          AdamWState(conv(self.opt.m), conv(self.opt.v), self.opt.count),
                          self.step)

    def from_tree(self, tree: "TrainState") -> "TrainState":
        """The inverse of ``to_tree``, shaped like this (possibly abstract)
        state: a module is copied, given storage on the tree's device and
        loaded with the tree's params."""
        if not isinstance(self.params, nn.Module):
            return tree
        conv = getattr(self.params, "from_reference_tree", lambda t: t)
        device = tree.step.device
        params = copy.deepcopy(self.params).to_empty(device=device)
        params.load_state_dict(conv(tree.params))
        return TrainState(params, AdamWState(conv(tree.opt.m), conv(tree.opt.v), tree.opt.count),
                          tree.step)


def init_train_state(params) -> TrainState:
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt, step=torch.zeros_like(opt.count))


def abstract_train_state(abstract_params) -> TrainState:
    """A ``TrainState`` of tensors on the ``meta`` device (shapes and
    dtypes only) from params on that device: the restore target."""
    return init_train_state(abstract_params)


def _split_microbatches(batch, n: int) -> list:
    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not split into {n} micro-batches")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))

    stacked = tree_map(split, batch)
    return [tree_map(lambda x, _i=i: x[_i], stacked) for i in range(n)]


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    opt_cfg: AdamWConfig,
    *,
    grad_accum: int = 1,
    grad_transform: Optional[Callable[[Any], Any]] = None,
):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (scalar_loss, metrics_dict)``.
    """

    def grads_of(params, batch):
        if isinstance(params, nn.Module):
            call_with, tree = params, param_tree(params)
        else:
            tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
            call_with = tree
        flat, treedef = flatten_with_paths(tree)
        loss, metrics = loss_fn(call_with, batch)
        grads = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(flat, grads)]
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(treedef, grads)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if grad_accum > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           param_tree(state.params))
            loss = torch.zeros((), device=state.step.device)
            for mb in _split_microbatches(batch, grad_accum):
                mb_loss, metrics, g = grads_of(state.params, mb)
                acc = tree_map(lambda a, gi: a + gi.float() / grad_accum, acc, g)
                loss = loss + mb_loss / grad_accum
            grads = acc  # metrics: the last micro-batch's, as the reference's
        else:
            loss, metrics, grads = grads_of(state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        new_state = TrainState(params=new_params, opt=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return step


def train_loop(
    step_fn,
    state: TrainState,
    batches,
    *,
    hooks: Optional[list[Callable[[int, TrainState, dict], None]]] = None,
):
    """Simple host-side loop (examples and integration tests).

    ``batches`` is any iterable of pytrees; hooks receive (step, state,
    metrics): the checkpoint manager's ``every_n_steps_hook`` slots in here.
    The reference's ``jit`` flag has no counterpart: the step runs eagerly.
    Each step's scalar metrics are read to the host.
    """
    history = []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items() if torch.as_tensor(v).ndim == 0}
        history.append(metrics)
        for h in hooks or ():
            h(i, state, metrics)
    return state, history
