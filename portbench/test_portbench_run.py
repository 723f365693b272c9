"""The harness end to end on the CPU at a small size, and what a run must
refuse: no card, no program beside it, a JAX module loaded, a wrong
answer, half a batch left unserved."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers.closed_batch import batch_order
from portbench.drivers.open_loop import schedule
from portbench.harness import JAX_MODULES, PB, ROOT
from portbench.run import execute

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMALL = {"config": {"n_docs": 2000, "n_queries": 160}}
TRAFFIC = {
    "spladev2-saat-open": {"rate_qps": 1500, "sample": 4096, "rho": 3000},
    "bm25-daat-batch": {"batch": 8, "sample": 4096, "probe_batches": 1},
}


def small_run(cell, seed=2**31 + 3, trace=False, seconds=0.6):
    return execute(cell, seed, seconds, trace, CPU,
                   overrides={**SMALL, "traffic": TRAFFIC[cell]})


def test_open_loop_schedule_from_the_seed():
    a_t, a_q = schedule(400.0, 5.0, 2**31 + 9, 6980)
    b_t, b_q = schedule(400.0, 5.0, 2**31 + 9, 6980)
    np.testing.assert_array_equal(a_t, b_t)
    np.testing.assert_array_equal(a_q, b_q)
    assert a_t.size == 2000 and a_t[-1] == pytest.approx(5.0) and (np.diff(a_t) > 0).all()
    c_t, c_q = schedule(400.0, 5.0, 2**31 + 10, 6980)
    assert not np.array_equal(a_t, c_t) and not np.array_equal(a_q, c_q)
    # every seed sends the same gaps, in another order
    gaps = lambda t: np.sort(np.diff(np.concatenate([[0.0], t])))
    np.testing.assert_allclose(gaps(a_t), gaps(c_t), rtol=1e-9, atol=1e-12)


def test_closed_loop_order_from_the_seed():
    a = batch_order(5, 100, 7, 32)
    np.testing.assert_array_equal(a, batch_order(5, 100, 7, 32))
    flat = a.reshape(-1)
    assert sorted(flat[:100]) == list(range(100))  # each pass covers the pool once
    assert sorted(flat[100:200]) == list(range(100))
    assert not np.array_equal(a, batch_order(6, 100, 7, 32))


@pytest.mark.parametrize("cell", sorted(TRAFFIC))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    r = small_run(cell, trace=trace)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    if not trace:
        assert "setup_s" in r["metrics"]
    else:
        assert "breakdown" in r and r["device"]["window_s"] > 0


def _swap_first_and_last(res):
    ids = res.doc_ids.clone()
    ids[:, 0], ids[:, -1] = res.doc_ids[:, -1], res.doc_ids[:, 0]
    return res._replace(doc_ids=ids)


def _half_the_batch(res):
    """Rows past the first half get the first half's answers."""
    B = res.doc_ids.shape[0]
    src = torch.arange(B) % max(B // 2, 1)
    return type(res)(*(f[src] if f.ndim else f for f in res))


@pytest.mark.parametrize("cell,engine", [("spladev2-saat-open", "saat_search"),
                                         ("bm25-daat-batch", "daat_search_batched")])
@pytest.mark.parametrize("fault", [_swap_first_and_last, _half_the_batch])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, engine, fault):
    from repro_torch.serving import scheduler

    inner = getattr(scheduler, engine)
    monkeypatch.setattr(scheduler, engine, lambda *a, **kw: fault(inner(*a, **kw)))
    r = small_run(cell)
    assert r["correct"] is False, r["checks"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_reference_package():
    for path in PB.rglob("*.py"):
        found = _imports(path) & (JAX_MODULES | {"benchmarks"})
        assert not found, f"{path} imports {found}"
    for path in (PB / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    env.pop("JAX_PLATFORMS", None)
    return env


def test_a_run_loads_no_jax_module():
    code = ("import torch, json; torch.set_num_threads(1)\n"
            "from portbench.test_portbench_run import small_run\n"
            "from portbench.run import jax_modules\n"
            "for cell in ('spladev2-saat-open', 'bm25-daat-batch'):\n"
            "    assert small_run(cell, trace=True, seconds=0.3)['correct']\n"
            "print(json.dumps(jax_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "bm25-daat-batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "CUDA device" in out.stderr


def test_run_fails_beside_no_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bm25-daat-batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "repro_torch" in out.stderr


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in ("bm25-daat-batch", "spladev2-saat-open"):
        out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", cell, "--seed",
                              "2147483659", "--seconds", "2", "--trace", "0"], env=_env(),
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.parametrize("cell", ["spladev2-saat-open", "bm25-daat-batch"])
def test_the_control_is_not_correct(cell):
    """The reference in bfloat16 in the system's place, as ``control.py``
    runs it on the card at the cell's size."""
    from portbench.control import control_numbers
    from portbench.harness import load_cell

    c = load_cell(cell)
    c.config.update(n_docs=1500, n_queries=60)
    c.traffic.update(sample=64, **({"rho": 500} if "saat" in cell else {"batch": 8}))
    row = control_numbers(c, 2**31 + 1, 1.0, CPU)
    assert row["correct"] is False, row["checks"]


def test_sweep_takes_a_stalled_window_as_not_sustained():
    from portbench.sweep import sustained

    steady = {"latency_p95_ms": 39.9, "first_quarter_mean_ms": 24.9,
              "last_quarter_mean_ms": 27.1, "generator_late_p95_ms": 18.9}
    assert sustained(steady, floor_p95=30.7, deadline_ms=25.0)
    # a stall that drained inside the window: late sends, a tail five times the floor
    stalled = {"latency_p95_ms": 169.4, "first_quarter_mean_ms": 80.8,
               "last_quarter_mean_ms": 23.6, "generator_late_p95_ms": 154.3}
    assert not sustained(stalled, floor_p95=30.7, deadline_ms=25.0)
    growing = dict(steady, last_quarter_mean_ms=40.0)
    assert not sustained(growing, floor_p95=30.7, deadline_ms=25.0)
