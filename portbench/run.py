"""Run one cell of the benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's data from the seed, builds the system's
index with the port's ``build_impact_index``, and lets the traffic's driver
build the server and warm up the shapes the cell uses. The window then runs
for ``--seconds``. Afterwards the device's peak memory is read, the
system's state is let go, and a sample of the window's answers is held
against the plain reference (``reference/``). The last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
the device, and a ``checks`` key with each compared number beside its
limit, also printed last on standard error.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2. It never runs on the CPU. The kernels build into the
port's ``build/torch_kernels/``, and every other compile cache goes under
``build/portbench_cache/``, both inside the checkout.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"
CACHE_ENV = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "inductor",
    "CUDA_CACHE_PATH": "cuda",
}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(workload: str, seed: int, seconds: float, trace: bool, device, *, bench=None,
            overrides: dict | None = None, t_start: float | None = None) -> dict:
    """One run; returns the result line's object. ``overrides`` replaces
    keys of the configuration (``"config"``) and traffic (``"traffic"``);
    the tests use it to run a cell small on the CPU."""
    import torch
    from repro_torch.core.impact_index import build_impact_index
    from repro_torch.core.quantization import QuantConfig

    from portbench import correctness
    from portbench.data import make_deployment
    from portbench.harness import Run, driver, load_cell
    from portbench.reference.retrieval import ReferenceIndex
    from portbench.trace import WINDOW_SPAN, Profile, span

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, bench)
    for part, upd in (overrides or {}).items():
        getattr(cell, part).update(upd)
    cuda = device.type == "cuda"
    drv = driver(cell.traffic)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=bool(trace), device=device)
    cfg = cell.config

    # ---- set-up ----
    stages = [("start", time.perf_counter())]
    run.dep = make_deployment(cfg, seed, device)
    enc = run.dep.enc
    if cuda:  # the peak is the system's: the data's sorts on the card are the benchmark's
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    stages.append(("data", time.perf_counter()))
    run.index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, run.dep.n_docs,
                                   enc.n_terms, quant=QuantConfig(bits=int(cfg["index"]["bits"])),
                                   block_size=int(cfg["index"]["block_size"]), device=device)
    stages.append(("index build", time.perf_counter()))
    drv.prepare(run)
    if cuda:
        torch.cuda.synchronize(device)
    stages.append(("server and warm-up", time.perf_counter()))
    run.setup_s = time.perf_counter() - t_start
    print("portbench set-up: " + ", ".join(
        f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(stages, stages[1:]))
        + f" (imports before them {stages[0][1] - t_start:.2f} s); {enc.n_postings} postings, "
        f"{enc.n_terms} terms, index {run.index.nbytes() / 1e9:.3f} GB", file=sys.stderr)

    # ---- the window ----
    with Profile(run.trace) as prof:
        with span(WINDOW_SPAN, run.trace):
            drv.measure(run)
            if cuda:
                torch.cuda.synchronize(device)
    run.trace_summary = prof.summary
    if cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if run.trace and hasattr(drv, "probe"):
        drv.probe(run)

    # ---- the check, with the system's state let go ----
    served, n_missing = drv.collect(run)
    run.index = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = ReferenceIndex(enc.doc_idx, enc.term_idx, enc.weights, run.dep.n_docs, enc.n_terms,
                         bits=int(cfg["index"]["bits"]), block_size=int(cfg["index"]["block_size"]),
                         device=device)
    t = cell.traffic
    numbers = correctness.compare(correctness.sample(served, int(t["sample"]), seed), ref,
                                  enc.query_terms, enc.query_weights, k=int(t["k"]),
                                  rho=drv.reference_rho(run), n_missing=n_missing)
    correct, checks = correctness.judge(numbers, t["limits"])
    if run.trace:
        run.work_bytes = drv.work_bytes(run, ref)

    print(f"portbench after the window: {len(served)} answers, reference and check "
          f"{time.perf_counter() - t_check:.2f} s, window {run.records['window_s']:.2f} s",
          file=sys.stderr)
    metrics = run.read_metrics(cell.per_layer if run.trace else cell.end_to_end)
    dev = {"platform": "gpu" if cuda else device.type, "count": 1,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "memory_peak_bytes": run.memory_peak_bytes or 0}
    result = {"correct": bool(correct), "attempted": int(run.records["attempted"]),
              "failed": int(n_missing), "metrics": metrics, "device": dev}
    if run.trace and run.trace_summary is not None:
        s = run.trace_summary
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["checks"] = checks
    return result


def jax_modules() -> list:
    from portbench.harness import JAX_MODULES

    return sorted({m.split(".")[0] for m in sys.modules} & JAX_MODULES)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    try:
        import repro_torch  # noqa: F401  (the system under test, beside the benchmark)
    except ImportError as e:
        print(f"portbench: the system under test, repro_torch, is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    import torch

    from portbench.correctness import print_checks
    from portbench.harness import load_benchmark, load_cell

    bench = load_benchmark()
    chips = int(load_cell(args.workload, bench).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), bench=bench, t_start=t_start)
    found = jax_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark may load none of them",
              file=sys.stderr)
        return 3
    print_checks(result["correct"], result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
