"""Import hygiene and the no-fallback rule of the PyTorch/CUDA port.

* ``repro_torch`` (every submodule) and ``chip_smoke.py`` import neither JAX
  nor anything of the JAX package ``repro``;
* an entry point called without ``device="cpu"`` on a machine with no GPU
  raises instead of running on the CPU;
* a kernel wrapper that cannot build or launch its CUDA kernel raises
  instead of running the plain version;
* the serving CLI (``python -m repro_torch.launch.serve``) runs end to end
  with ``--device cpu``, directly and through the admission queue with the
  counters endpoint, and raises without ``--device cpu`` when there is no
  GPU.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ARRAY_FIELDS, META_FIELDS, build_impact_index, index_from_numpy
from repro_torch.kernels import common
from repro_torch.kernels.block_prune import ops as dense_prune_ops
from repro_torch.kernels.block_prune_csr import ops as prune_ops
from repro_torch.kernels.block_topk import ops as btopk_ops
from repro_torch.kernels.chunk_step import ops as chunk_ops
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops
from repro_torch.kernels.sparse_score import ops as score_ops

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # runs the imports, not main()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    expected = {
        "repro_torch.core.saat", "repro_torch.core.exhaustive", "repro_torch.core.topk",
        "repro_torch.kernels.common", "repro_torch.kernels.impact_scatter.ops",
        "repro_torch.kernels.impact_scatter_topk.ops", "repro_torch.models.treatments",
        "repro_torch.data.synthetic", "repro_torch.metrics.ir_metrics",
        "repro_torch.core.daat", "repro_torch.kernels.block_prune_csr.ops",
        "repro_torch.kernels.block_prune_csr.ref", "repro_torch.kernels.block_topk.ops",
        "repro_torch.kernels.block_topk.ref", "repro_torch.kernels.sparse_score.ops",
        "repro_torch.kernels.sparse_score.ref", "repro_torch.kernels.chunk_step.ops",
        "repro_torch.kernels.chunk_step.ref", "repro_torch.kernels.block_prune.ops",
        "repro_torch.kernels.block_prune.ref", "repro_torch.core.index_handle",
        "repro_torch.metrics.latency", "repro_torch.serving.bucketing",
        "repro_torch.serving.counters", "repro_torch.serving.scheduler",
        "repro_torch.serving.queue", "repro_torch.serving.lifecycle",
        "repro_torch.launch.serve",
    }
    assert expected <= set(report["modules"])


def test_port_sources_never_name_the_reference():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and not stripped.startswith(("import repro.", "from repro.", "from repro ")), (path, line)


def _tiny_coo():
    rng = np.random.default_rng(0)
    return rng.integers(0, 20, 100), rng.integers(0, 10, 100), rng.gamma(2.0, 1.0, 100)


def test_entry_points_raise_without_a_gpu_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    d, t, w = _tiny_coo()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_impact_index(d, t, w, 20, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_impact_index(d, t, w, 20, 10, device="cuda")
    index = build_impact_index(d, t, w, 20, 10, device="cpu")
    arrays = {f: getattr(index, f).numpy() for f in ARRAY_FIELDS}
    meta = {f: getattr(index, f) for f in META_FIELDS}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_numpy(arrays, meta)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index.to("cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        common.kernel_library("impact_scatter")
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build_kernels()


def test_kernel_wrappers_never_fall_back_to_the_plain_version():
    """Off the CPU a wrapper launches its kernel or raises; it never runs
    the plain version, and no launch is counted. (A ``meta`` tensor stands
    in for a device this build cannot launch on.)"""
    docs = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    c = torch.ones((2, 64), device="meta")
    before = (scatter_ops.LAUNCHES, fused_ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_ops.impact_scatter_batched(docs, c, 100, block_d=64, tile_p=64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.impact_scatter_topk_batched(docs, c, 100, 5, block_d=64, tile_p=64)
    assert (scatter_ops.LAUNCHES, fused_ops.LAUNCHES) == before


def _daat_wrapper_calls(device):
    """One call of each DAAT kernel wrapper on tiny inputs on ``device``."""
    z = dict(device=device)
    i32 = dict(dtype=torch.int32, **z)
    B, nb, bs, tmax, lq, k = 2, 4, 8, 3, 2, 3
    store_t = torch.zeros((nb * bs, tmax), **i32)
    store_w = torch.ones((nb * bs, tmax), **z)
    qt, qw = torch.zeros((B, lq), **i32), torch.ones((B, lq), **z)
    ub, proc = torch.ones((B, nb), **z), torch.zeros((B, nb), dtype=torch.bool, **z)
    ps, pi, th = torch.zeros((B, k), **z), torch.zeros((B, k), **i32), torch.zeros(B, **z)
    chunk_kw = dict(block_budget=2, block_size=bs, n_live=nb * bs)
    dense = torch.ones((B, lq, nb), **z)
    return {
        "block_prune": lambda: dense_prune_ops.block_prune_batched(dense, qw, th),
        "block_prune_single": lambda: dense_prune_ops.block_prune(dense[0], qw[0], th[0]),
        "block_prune_csr": lambda: prune_ops.block_prune_csr_batched(
            torch.zeros(5, **i32), torch.ones(5, **z), torch.zeros((B, lq), **i32),
            torch.ones((B, lq), **i32), qw, th, n_blocks=nb, max_bm_per_term=2),
        "block_topk": lambda: btopk_ops.block_topk_batched(ub, 2),
        "block_topk_single": lambda: btopk_ops.block_topk(ub[0], 2),
        "sparse_score": lambda: score_ops.sparse_score_batched(
            torch.zeros((B, 5, tmax), **i32), torch.ones((B, 5, tmax), **z), qt, qw),
        "sparse_score_single": lambda: score_ops.sparse_score(
            torch.zeros((5, tmax), **i32), torch.ones((5, tmax), **z), qt[0], qw[0]),
        "sparse_score_blocks": lambda: score_ops.sparse_score_blocks_batched(
            store_t, store_w, torch.zeros((B, 2), **i32), qt, qw, block_size=bs, n_live=nb * bs),
        "chunk_step": lambda: chunk_ops.chunk_step_batched(
            store_t, store_w, qt, qw, ub, proc, ps, pi, th, **chunk_kw),
        "chunk_step_multi": lambda: chunk_ops.chunk_step_multi_batched(
            store_t, store_w, qt, qw, ub, proc, ps, pi, th, torch.ones(B, **i32),
            trips_per_launch=2, **chunk_kw),
    }


def _daat_counters():
    return (prune_ops.LAUNCHES, btopk_ops.LAUNCHES, score_ops.LAUNCHES, score_ops.STORE_LAUNCHES,
            chunk_ops.LAUNCHES, chunk_ops.MULTI_LAUNCHES, dense_prune_ops.LAUNCHES)


@pytest.mark.parametrize("wrapper", list(_daat_wrapper_calls("cpu")))
def test_daat_kernel_wrappers_never_fall_back_to_the_plain_version(wrapper):
    """The DAAT wrappers, given tensors off the CPU that no kernel can take,
    raise without running the plain version or counting a launch."""
    call = _daat_wrapper_calls("meta")[wrapper]
    before = _daat_counters()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert _daat_counters() == before


@pytest.mark.cuda
def test_daat_kernel_wrappers_raise_on_cuda_without_a_build(monkeypatch, tmp_path):
    """On a CUDA tensor with no kernel build the wrapper raises (no nvcc),
    rather than running the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to place the inputs on")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "_LIBS", {})
    for name, call in _daat_wrapper_calls("cuda").items():
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


def test_daat_cpu_wrappers_run_the_plain_version_and_count_nothing():
    before = _daat_counters()
    for call in _daat_wrapper_calls("cpu").values():
        call()
    assert _daat_counters() == before


def test_cpu_wrappers_count_no_launches():
    docs = torch.zeros((2, 64), dtype=torch.int32)
    c = torch.ones((2, 64))
    before = (scatter_ops.LAUNCHES, fused_ops.LAUNCHES)
    scatter_ops.impact_scatter_batched(docs, c, 100, block_d=64, tile_p=64)
    fused_ops.impact_scatter_topk_batched(docs, c, 100, 5, block_d=64, tile_p=64)
    assert (scatter_ops.LAUNCHES, fused_ops.LAUNCHES) == before


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "600", "--queries", "24",
          "--batch", "8", "--k", "10"]


def _serve(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(_SERVE + list(extra), capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("mode", ["direct", "queue"])
def test_serve_cli_runs_on_the_cpu_when_asked(mode):
    if mode == "direct":
        out = _serve("--device", "cpu", "--eval-qrels")
    else:
        out = _serve("--device", "cpu", "--queue", "--lq-buckets", "4,8,16", "--degrade-rho",
                     "--counters", "--counters-port", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert 0.0 <= report["rr@10"] <= 1.0
    if mode == "direct":
        assert report["latency"]["n"] == 24
        assert report["rho_within_3pct_mrr_loss"] in [r["rho"] for r in report["effectiveness_by_rho"]]
    else:
        assert report["completed"] == report["requests"] == 24
        assert "counters endpoint: http://127.0.0.1:" in out.stderr
        assert "repro_queue_flush_total" in report["counters"]


def test_serve_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = _serve()
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and out.stdout == ""
