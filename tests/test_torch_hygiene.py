"""Import hygiene and the no-fallback rule of the PyTorch/CUDA port.

* ``repro_torch`` (every submodule) and ``chip_smoke.py`` import neither JAX
  nor anything of the JAX package ``repro``;
* an entry point called without ``device="cpu"`` on a machine with no GPU
  raises instead of running on the CPU;
* a kernel wrapper that cannot build or launch its CUDA kernel raises
  instead of running the plain version.
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
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops

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
