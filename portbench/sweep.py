"""Find an open-loop cell's knee: the highest offered rate it sustains
without a growing backlog, behind one set-up.

    python3 portbench/sweep.py --workload spladev2-saat-open --seeds <n>,<m> --seconds 10 \
        --rates 2000,3000,4000 [--out chiprun_out/sweep.json]

The data is made from the first seed. For each seed in turn, each rate
runs the cell's own open loop (the traffic file's schedule at that rate,
drawn from that seed) for ``--seconds``, ascending until a rate is not
sustained. A rate is sustained when its backlog stays bounded over the
whole window: the loop sent its requests on time (the generator's lateness
at p95 within the traffic's deadline), the tail did not grow (p95 latency
within ``TAIL_GROWTH`` times the lowest rate's), and the window's last
quarter of requests waited no longer than its first, nor its first longer
than its last, by ``GROWTH_MS`` in the mean (a stall that drains inside
the window shows there). The knee is the highest rate sustained on every
seed, and the cell's rate four fifths of it; the traffic file records
both, by hand, with the sweep's output in ``PERF.md``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROWTH_MS = 5.0  # quarters of the window this far apart in mean latency: not steady
TAIL_GROWTH = 1.5  # a p95 this many times the lowest rate's: the backlog grows


def summarize(records: dict, rate: float) -> dict:
    import numpy as np

    lat = np.asarray(records["latency_ms"])
    q = max(lat.size // 4, 1)
    return {
        "rate_qps": rate, "requests": int(records["attempted"]),
        "answered": int(records["answered"]),
        "latency_mean_ms": float(lat.mean()), "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p95_ms": float(np.percentile(lat, 95)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "first_quarter_mean_ms": float(lat[:q].mean()), "last_quarter_mean_ms": float(lat[-q:].mean()),
        "generator_late_p95_ms": float(np.percentile(records["late_ms"], 95)),
        "flush_size_mean": float(np.mean(records["flush_sizes"])),
        "service_ms_p95": float(np.percentile(records["service_ms"], 95)),
        "window_s": float(records["window_s"]),
    }


def sustained(row: dict, floor_p95: float, deadline_ms: float) -> bool:
    """The backlog stayed bounded over the whole window (see above)."""
    steady = abs(row["last_quarter_mean_ms"] - row["first_quarter_mean_ms"]) < GROWTH_MS
    return (steady and row["generator_late_p95_ms"] <= deadline_ms
            and row["latency_p95_ms"] <= TAIL_GROWTH * floor_p95)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated; the data is the first's")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True, help="comma-separated queries/s, ascending")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from repro_torch.core.impact_index import build_impact_index
    from repro_torch.core.quantization import QuantConfig

    from portbench.data import make_deployment
    from portbench.harness import Run, driver, load_cell

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    drv = driver(cell.traffic)
    if not hasattr(drv, "set_rate"):
        print(f"sweep: {args.workload} is not an open-loop cell", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seeds = [int(x) for x in args.seeds.split(",")]
    run = Run(cell=cell, seed=seeds[0], seconds=args.seconds, trace=False, device=device)
    run.dep = make_deployment(cell.config, seeds[0], device)
    enc, idx = run.dep.enc, cell.config["index"]
    run.index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, run.dep.n_docs,
                                   enc.n_terms, quant=QuantConfig(bits=int(idx["bits"])),
                                   block_size=int(idx["block_size"]), device=device)
    rates = [float(r) for r in args.rates.split(",")]
    drv.prepare(run, rate=rates[0])
    print(f"sweep set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    deadline_ms = float(cell.traffic["deadline_ms"])
    rows, knees = [], []
    for seed in seeds:
        run.seed, knee, floor_p95 = seed, None, None
        for rate in rates:
            drv.set_rate(run, rate)
            run.records = {}
            drv.measure(run)
            row = summarize(run.records, rate)
            floor_p95 = row["latency_p95_ms"] if floor_p95 is None else floor_p95
            row.update(seed=seed, sustained=sustained(row, floor_p95, deadline_ms))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not row["sustained"]:
                break
            knee = rate
        knees.append(knee)
    knee = None if None in knees else min(knees)
    out = {"workload": args.workload, "seeds": seeds, "seconds": args.seconds,
           "growth_ms": GROWTH_MS, "tail_growth": TAIL_GROWTH, "knees": knees, "knee_qps": knee,
           "rate_qps": None if knee is None else 0.8 * knee, "rows": rows,
           "card": torch.cuda.get_device_name(device)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
