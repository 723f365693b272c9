"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, with the same flags plus ``--device``:
it trains on the GPU (``cuda``, the default) and raises when there is none,
unless ``--device cpu`` asks for the plain PyTorch path on the host. Runs
real steps (smoke-scale by default, the published config with ``--full``
where the card can hold it) and wires together the arch registry, the data
pipeline, the train step, the checkpoint manager (every ``--ckpt-every``
steps, at the end, and on SIGTERM; ``--resume`` continues from the latest)
and a metrics log. The weights are drawn from seed 0 by a generator on the
run's device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import signal
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.trainer import abstract_train_state


def _make_loss(spec, cfg):
    if spec.family == "lm":
        from repro_torch.archs.transformer import lm_loss

        return lambda p, b: lm_loss(p, b["tokens"], b["labels"], cfg)
    if spec.family == "gnn":
        from repro_torch.archs.gnn import gnn_loss

        return lambda p, b: gnn_loss(p, b, cfg)
    from repro_torch.archs.recsys import loss as recsys_loss

    return lambda p, b: recsys_loss(p, b, cfg)


def _make_batches(spec, cfg, batch: int, seq: int, device):
    if spec.family == "lm":
        return pipeline.lm_token_batches(cfg.vocab, batch, seq, device=device)
    if spec.family == "gnn":
        readout = getattr(cfg, "graph_readout", False)
        return pipeline.gnn_batches(cfg, n_nodes=max(batch * 4, 64), n_edges=max(batch * 16, 256),
                                    graph_readout_graphs=8 if readout else 0, device=device)
    return pipeline.recsys_batches(cfg, batch, device=device)


def _init_params(spec, cfg, gen, device):
    """The family's model; ``device="meta"`` gives its shapes only."""
    if spec.family == "lm":
        from repro_torch.archs.transformer import init_lm_params

        return init_lm_params(gen, cfg, device)
    if spec.family == "gnn":
        from repro_torch.archs.gnn import init_gnn_params

        return init_gnn_params(gen, cfg, device)
    from repro_torch.archs.recsys import init_params

    return init_params(gen, cfg, device)


def main(argv=None) -> dict:
    """Trains and prints the reference's log. Returns the final train state,
    each step's metrics and its milliseconds (host clock, the device
    synchronized after each step), and the config."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full", action="store_true", help="use the full (not smoke) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = get_arch(args.arch)
    cfg = spec.config_for("train_4k" if "train_4k" in spec.cells else "train_batch") if args.full else spec.smoke_config()
    loss_fn = _make_loss(spec, cfg)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10), total_steps=args.steps)
    step_fn = make_train_step(loss_fn, opt, grad_accum=args.grad_accum)

    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(_init_params(spec, cfg, gen, device))

    cm = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir, keep=2)
        if args.resume and cm.latest_step() is not None:
            abstract = abstract_train_state(_init_params(spec, cfg, None, "meta"))
            state, meta = cm.restore(abstract, device=device)
            print(f"resumed from step {int(state.step)} ({meta})")

        def on_sigterm(signum, frame):  # checkpoint-on-preemption
            cm.save(int(state.step), state, {"reason": "sigterm"})
            cm.wait()
            sys.exit(0)

        signal.signal(signal.SIGTERM, on_sigterm)

    batches = _make_batches(spec, cfg, args.batch, args.seq, device)
    history, ms = [], []
    t0 = time.time()
    for i, batch in enumerate(itertools.islice(batches, args.steps)):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t_step))
        history.append(metrics)
        if cm and (i + 1) % args.ckpt_every == 0:
            cm.save(int(state.step), state, {"metrics": {k: float(v) for k, v in metrics.items()}})
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            m = {k: round(float(v), 4) for k, v in metrics.items() if torch.as_tensor(v).ndim == 0}
            print(f"step {i}: {json.dumps(m)}", flush=True)
    if cm:
        cm.save(int(state.step), state, {"final": True})
        cm.wait()
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.1f} ms/step)")
    return {"state": state, "history": history, "ms": ms, "cfg": cfg, "spec": spec}


if __name__ == "__main__":
    main()
