"""Dry-run: build every (arch x shape x mesh) step plan and account for it,
the port of ``repro.launch.dryrun``.

For every runnable cell the dry-run:
  1. builds the step plan (``launch/steps.py``: ``meta`` tensors only, zero
     allocation) on a production mesh (``launch/mesh.py``: 16x16 or
     2x16x16, a description naming the run's device),
  2. records what each device would hold: ``memory.argument_bytes``, one
     rank's bytes of every input leaf under its sharding (every split dim
     divides, so every rank holds the same), and ``memory.output_bytes``,
     the new state's under the same shardings (the train state of a train
     cell, the KV cache of a decode cell; ``null`` for the other kinds,
     whose outputs have no sharding of their own),
  3. the analytic step FLOPs and HBM bytes (``launch/costs.py``) and a
     roofline under the NVIDIA H100 80GB HBM3 (SXM) spec-sheet peaks:
     989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM a device,
  4. writes one JSON per cell under ``--out``, with the reference's keys.

What only XLA's compiled program gives has no counterpart and stays
``null``: ``memory.temp_bytes`` and ``memory.total_bytes`` (XLA's buffer
assignment), ``cost.flops_per_device_xla_raw`` and
``cost.bytes_per_device_xla_raw`` (HloCostAnalysis), ``collectives`` and
``roofline.collective_s`` (the census of the post-partitioning HLO), and
``hlo_lines``. A cell that fails is recorded with its traceback, as the
reference records one, and the run exits non-zero.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
    (add --device cpu on a machine without a GPU)
"""
import argparse
import dataclasses
import json
import os
import time
import traceback

from torch import nn

from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed.sharding import nbytes
from repro_torch.launch import costs
from repro_torch.launch.mesh import mesh_for, n_chips
from repro_torch.launch.steps import build_cell_plan
from repro_torch.train.optim import param_tree
from repro_torch.train.trainer import TrainState

# NVIDIA H100 80GB HBM3 (SXM) spec-sheet peaks a device (roofline denominators)
PEAK_FLOPS_BF16 = 989e12  # dense bf16 FLOP/s
HBM_BW = 3.35e12  # bytes/s


def plan_values(args) -> tuple:
    """A plan's args as the trees its ``in_shardings`` mirror: a module (or a
    train state's module) as its ``named_parameters()`` dict."""
    def one(a):
        if isinstance(a, nn.Module):
            return param_tree(a)
        if isinstance(a, TrainState):
            return dataclasses.replace(a, params=param_tree(a.params))
        return a

    return tuple(one(a) for a in args)


def run_cell(arch_id: str, shape_name: str, mesh_name: str, device=None) -> dict:
    spec = get_arch(arch_id)
    cell = spec.cells[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "kind": cell.kind}
    if cell.skip is not None:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec
    mesh = mesh_for(mesh_name, device)
    chips = n_chips(mesh)
    t0 = time.time()
    try:
        plan = build_cell_plan(spec, shape_name, mesh)
        values = plan_values(plan.args)
        arg_bytes = nbytes(values, plan.in_shardings)
        out_bytes = None
        if cell.kind == "train":
            out_bytes = nbytes(values[0], plan.in_shardings[0])
        elif cell.kind == "decode":
            out_bytes = nbytes(values[1], plan.in_shardings[1])
        cfg = spec.config_for(shape_name)
        dims = dict(cell.dims)
        if spec.family == "gnn":
            dims["_n_nodes"] = plan.static_meta["n_nodes"]
            dims["_n_edges"] = plan.static_meta["n_edges"]
        an = costs.analytic_costs(spec.family, cell.kind, cfg, dims)
        compute_s = an["flops"] / chips / PEAK_FLOPS_BF16
        memory_s = an["bytes"] / chips / HBM_BW
        terms = {"compute_s": compute_s, "memory_s": memory_s}
        bottleneck = max(terms, key=terms.get)
        rec.update(
            status="ok",
            chips=chips,
            memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes, temp_bytes=None,
                        total_bytes=None),
            cost=dict(
                flops_total_analytic=an["flops"],
                bytes_total_analytic=an["bytes"],
                flops_per_device_xla_raw=None,
                bytes_per_device_xla_raw=None,
            ),
            collectives=None,
            model_flops=plan.model_flops,
            useful_flops_ratio=(plan.model_flops / an["flops"] if an["flops"] else None),
            roofline=dict(
                **terms,
                collective_s=None,
                bottleneck=bottleneck,
                step_time_lower_bound_s=max(terms.values()),
                roofline_fraction=min(1.0, compute_s / max(max(terms.values()), 1e-30)),
            ),
            static_meta=plan.static_meta,
            hlo_lines=None,
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def cell_line(rec: dict) -> str:
    """One printed line for a cell's record."""
    where = f"{rec['arch']}/{rec['shape']}/{rec['mesh']}"
    if rec["status"] == "ok":
        r = rec["roofline"]
        return (f"[ok] {where}: args/device={rec['memory']['argument_bytes'] / 2**30:.3f}GiB "
                f"terms(c/m)={r['compute_s']:.2e}/{r['memory_s']:.2e}s "
                f"bottleneck={r['bottleneck']}")
    if rec["status"] == "skipped":
        return f"[skip] {where}: {rec['skip_reason'][:80]}"
    return f"[FAIL] {where}: {rec['error']}"


def main(argv=None) -> list:
    """Runs the cells, writes their records and prints a line each; returns
    the records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the meshes' device")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    records = []
    for arch_id in archs:
        spec = get_arch(arch_id)
        shapes = sorted(spec.cells) if (args.all or args.shape is None) else [args.shape]
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch_id, shape, mesh_name, args.device)
                with open(os.path.join(args.out, f"{arch_id}__{shape}__{mesh_name}.json"), "w") as f:
                    json.dump(rec, f, indent=1)
                print(cell_line(rec), flush=True)
                records.append(rec)
    failures = sum(r["status"] == "error" for r in records)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return records


if __name__ == "__main__":
    main()
