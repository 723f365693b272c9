"""Import hygiene and the no-fallback rule of the PyTorch/CUDA port.

* ``repro_torch`` (every submodule) and ``chip_smoke.py`` import neither JAX
  nor anything of the JAX package ``repro``, and set no environment
  variable when imported;
* an entry point called without ``device="cpu"`` on a machine with no GPU
  raises instead of running on the CPU;
* a kernel wrapper that cannot build or launch its CUDA kernel raises
  instead of running the plain version;
* the serving CLI (``python -m repro_torch.launch.serve``) runs end to end
  with ``--device cpu``, directly and through the admission queue with the
  counters endpoint, and raises without ``--device cpu`` when there is no
  GPU;
* every name the reference's ``repro.metrics``, ``repro.kernels``,
  ``repro.core``, ``repro.serving``, ``repro.distributed``, ``repro.train``
  and ``repro.checkpoint`` export, and every function and class of
  ``repro.core``'s and ``repro.metrics``' modules, of ``serving/sharded.py``,
  ``serving/pod.py`` and ``distributed/sharding.py``, and of the trainable
  encoder's modules (``archs/layers.py``, ``archs/transformer.py``,
  ``models/sparse_encoder.py``, ``train/*``, ``data/pipeline.py``,
  ``checkpoint/manager.py``), and of the model families and their registry
  (``archs/{embedding,gnn,recsys}.py``, ``configs/*``, ``data/graphs.py``,
  ``launch/train.py``), and of the sharding half of the distribution layer
  (``distributed/{collectives,elastic}.py``, ``launch/{mesh,steps,dryrun,
  costs}.py``), and of the static analysis (``analysis/{kernel_contracts,
  hot_path,check}.py``, and ``analysis/jaxpr_walk.py`` against
  ``analysis/op_trace.py``), the port's counterpart has too, but for the
  names of modules not yet ported (``NOT_YET_PORTED``) and the names left
  out with their reason (``NOT_PORTED``); the kernels'
  ``ops`` and ``ref`` modules still import by ``from ... import ops`` after
  the package re-exports the wrappers.
"""
import ast
import importlib
import inspect
import json
import os
import pkgutil
import types
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
import importlib, importlib.util, json, os, pkgutil, sys
env = dict(os.environ)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # runs the imports, not main()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
changed = sorted(k for k in set(env) | set(os.environ) if env.get(k) != os.environ.get(k))
print(json.dumps({"modules": names, "bad": bad, "env_changed": changed}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["env_changed"] == []  # no module sets an environment variable
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
        "repro_torch.launch.serve", "repro_torch.core.wacky", "repro_torch.core.pareto",
        "repro_torch.serving.sharded", "repro_torch.serving.pod",
        "repro_torch.distributed", "repro_torch.distributed.sharding",
        "repro_torch.archs.layers", "repro_torch.archs.transformer",
        "repro_torch.models.sparse_encoder", "repro_torch.train.losses",
        "repro_torch.train.optim", "repro_torch.train.trainer", "repro_torch.train.tree",
        "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
        "repro_torch.launch.train_encoder", "repro_torch.archs.embedding",
        "repro_torch.archs.gnn", "repro_torch.archs.recsys", "repro_torch.configs",
        "repro_torch.configs.base", "repro_torch.configs.lm_archs",
        "repro_torch.configs.gnn_archs", "repro_torch.configs.recsys_archs",
        "repro_torch.data.graphs", "repro_torch.launch.train",
        "repro_torch.distributed.collectives", "repro_torch.distributed.elastic",
        "repro_torch.launch.mesh", "repro_torch.launch.steps", "repro_torch.launch.dryrun",
        "repro_torch.launch.costs",
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


# Names the reference exports (or defines in a module the defines check
# reads) whose modules the port has not ported yet, with their queue item
# (ROADMAP.md, queue A). Empty: queue A's last module, A13 (``analysis/``),
# is ported.
NOT_YET_PORTED: dict = {}
# Names left out of a ported module, with the reason.
_JAXPR = "analysis/jaxpr_walk.py's jaxpr internals: the port records eager ops (op_trace.py)"
NOT_PORTED = {
    "parse_collectives_loop_aware": "launch/costs.py's census of XLA's post-partitioning HLO: "
                                    "the port runs no SPMD partitioner and emits no HLO",
    # analysis/jaxpr_walk.py: walks and Pallas introspection of jaxprs
    "sub_jaxprs": _JAXPR,
    "iter_eqns": _JAXPR + "; op_trace.iter_ops walks a recorded call",
    "find_primitives": _JAXPR,
    "find_pallas_calls": _JAXPR + "; op_trace.find_kernel_calls finds the kernel events",
    "is_ref": _JAXPR,
    "memory_space_of": _JAXPR + ": a CUDA kernel has no VMEM/SMEM/ANY operand spaces",
    "aval_bytes": _JAXPR,
    "KernelOperand": _JAXPR + "; a LaunchPlan names each shared-memory buffer",
    "num_scalar_prefetch_operands": "PrefetchScalarGridSpec has no CUDA counterpart: the port "
                                    "checks that no host read feeds a launch (host_read)",
    "kernel_operands": _JAXPR + "; a LaunchPlan names each shared-memory buffer",
    "PendingDma": "the DMA semaphore walk over a kernel jaxpr: the port reads the CUDA source "
                  "(op_trace.async_copy_report)",
    "DmaReport": "the DMA semaphore walk over a kernel jaxpr: op_trace.AsyncCopyReport",
    "check_dma_discipline": "the DMA semaphore walk over a kernel jaxpr: "
                            "op_trace.async_copy_report reads cp.async, commits and waits",
    # analysis/kernel_contracts.py
    "vmem_footprint": "the double-buffered VMEM budget of a pallas_call: a LaunchPlan states "
                      "its shared memory (the smem check)",
}
KERNEL_PACKAGES = ("block_prune", "block_prune_csr", "block_topk", "chunk_step",
                   "impact_scatter", "impact_scatter_topk", "sparse_score")


def _init_exports(package: str) -> set:
    """The names a reference package's ``__init__.py`` binds: each name it
    imports, and each of its own submodules it imports from."""
    path = ROOT / "src" / Path(*package.split(".")) / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module:
            names.update(a.asname or a.name for a in node.names)
            if node.module.startswith(package + "."):
                names.add(node.module[len(package) + 1:].split(".")[0])
    return names


@pytest.mark.parametrize("package", ["metrics", "kernels", "core", "serving", "distributed",
                                     "train", "checkpoint", "configs", "data", "analysis"])
def test_port_packages_export_what_the_reference_exports(package):
    port = importlib.import_module(f"repro_torch.{package}")
    want = _init_exports(f"repro.{package}")
    assert want, package
    missing = sorted(n for n in want if not hasattr(port, n) and n not in NOT_YET_PORTED)
    assert missing == []


REF_MODULES = ("core.daat", "core.exhaustive", "core.impact_index", "core.index_handle",
               "core.pareto", "core.quantization", "core.saat", "core.topk", "core.wacky",
               "metrics.ir_metrics", "metrics.latency")


def test_ref_modules_list_every_reference_module():
    found = {f"{pkg}.{m.name}" for pkg in ("core", "metrics")
             for m in pkgutil.iter_modules([str(ROOT / "src" / "repro" / pkg)])}
    assert found == set(REF_MODULES)


# Modules of ``repro.serving`` and ``repro.distributed`` that the defines
# check reads too.
SHARDED_MODULES = ("serving.sharded", "serving.pod", "distributed.sharding",
                   "distributed.collectives", "distributed.elastic")
# The trainable encoder's modules (queue A11).
ENCODER_MODULES = ("archs.layers", "archs.transformer", "models.sparse_encoder",
                   "train.losses", "train.optim", "train.trainer", "data.pipeline",
                   "checkpoint.manager")
# The model families, their registry and the arch CLI (the first half of
# queue A12).
ARCH_MODULES = ("archs.embedding", "archs.gnn", "archs.recsys", "configs", "configs.base",
                "configs.lm_archs", "configs.gnn_archs", "configs.recsys_archs", "data.graphs",
                "launch.train")
# The step plans, the dry-run and its costs (the sharding half of A12).
LAUNCH_MODULES = ("launch.mesh", "launch.steps", "launch.dryrun", "launch.costs")
# The static analysis (queue A13); jaxpr_walk's counterpart is op_trace.
ANALYSIS_MODULES = ("analysis.kernel_contracts", "analysis.hot_path", "analysis.check",
                    "analysis.jaxpr_walk")
PORT_MODULE = {"analysis.jaxpr_walk": "analysis.op_trace"}


def _import_reference(module: str):
    """The reference's module. ``repro.launch.dryrun`` sets ``XLA_FLAGS``
    when imported; the variable is put back, so that no later subprocess
    of this worker inherits 512 host devices."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{module}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("module", REF_MODULES + SHARDED_MODULES + ENCODER_MODULES
                         + ARCH_MODULES + LAUNCH_MODULES + ANALYSIS_MODULES)
def test_port_modules_define_what_the_reference_defines(module):
    ref = _import_reference(module)
    port = importlib.import_module(f"repro_torch.{PORT_MODULE.get(module, module)}")
    want = {n for n, obj in vars(ref).items()
            if not n.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == ref.__name__}
    missing = sorted(n for n in want if not hasattr(port, n)
                     and n not in NOT_YET_PORTED and n not in NOT_PORTED)
    assert missing == []
    assert not any(hasattr(port, n) for n in NOT_PORTED), "a name left out is defined"


def test_import_surface_of_the_acceptance_criteria():
    from repro_torch.core import IndexHandle, pareto_frontier
    from repro_torch.kernels import block_prune_batched, impact_scatter_batched
    from repro_torch.metrics import LatencyStats, summarize_latencies

    assert inspect.isclass(IndexHandle) and inspect.isclass(LatencyStats)
    assert all(callable(f) for f in (pareto_frontier, block_prune_batched,
                                     impact_scatter_batched, summarize_latencies))


@pytest.mark.parametrize("kernel", KERNEL_PACKAGES)
@pytest.mark.parametrize("part", ["ops", "ref"])
def test_kernel_modules_still_import_after_the_re_exports(kernel, part):
    import repro_torch.kernels as kernels

    mod = getattr(__import__(f"repro_torch.kernels.{kernel}", fromlist=[part]), part)
    assert isinstance(mod, types.ModuleType)
    assert mod.__name__ == f"repro_torch.kernels.{kernel}.{part}"
    # the package binds the wrapper of the same name, where there is one,
    # as the reference's does
    bound = getattr(kernels, kernel)
    assert callable(bound) or isinstance(bound, types.ModuleType)
