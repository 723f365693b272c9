"""The control of each cell's comparison: the plain reference put in the
system's place one precision below the one the configurations state
(bfloat16 contributions and sums for float32), at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--out FILE]

For each seed it makes the cell's data, draws the requests a run would
draw (the open loop's schedule, or the closed loop's first batches), has
the control answer a sample of them as the run samples, and compares those
answers with the reference exactly as ``run.py`` compares the system's.
Every number the control reads sets the upper end of that number's limit
(``PERF.md``); the control has to come out not correct. It needs no
window: a request's answer does not depend on the batch it rode in (the
queue's and the server's padding leave each row's result bit for bit).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, seconds: float, device) -> dict:
    import torch

    from portbench import correctness
    from portbench.data import make_deployment
    from portbench.reference.retrieval import ReferenceIndex

    t = cell.traffic
    dep = make_deployment(cell.config, seed, device)
    enc, idx = dep.enc, cell.config["index"]
    ref = ReferenceIndex(enc.doc_idx, enc.term_idx, enc.weights, dep.n_docs, enc.n_terms,
                         bits=int(idx["bits"]), block_size=int(idx["block_size"]), device=device)
    if t["driver"] == "open_loop":
        from portbench.drivers.open_loop import schedule

        queries = schedule(float(t["rate_qps"]), seconds, seed, dep.pool_size)[1]
        rho = int(t["rho"])
    else:
        from portbench.drivers.closed_batch import batch_order

        n = -(-int(t["sample"]) * 4 // int(t["batch"]))
        queries = batch_order(seed, dep.pool_size, n, int(t["batch"])).reshape(-1)
        rho = None
    k = int(t["k"])
    picked = correctness.sample([correctness.Served(int(q), None, None) for q in queries],
                                int(t["sample"]), seed)
    served = []
    for s in picked:
        a = ref.search(enc.query_terms[s.query], enc.query_weights[s.query], k, rho,
                       precision=torch.bfloat16)
        served.append(correctness.Served(s.query, a.ids, a.scores.astype("float32"), a.processed))
    numbers = correctness.compare(served, ref, enc.query_terms, enc.query_weights, k=k, rho=rho)
    correct, checks = correctness.judge(numbers, t["limits"])
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench.harness import load_benchmark, load_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = load_benchmark()
    seconds = float(bench["run_seconds"])
    cell = load_cell(args.workload, bench)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = control_numbers(cell, seed, seconds, torch.device("cuda", 0))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
