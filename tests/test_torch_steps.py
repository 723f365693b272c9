"""The port's step plans, analytic costs and dry-run
(``repro_torch.launch.{steps,costs,dryrun,mesh}``) against the JAX
reference's, on the CPU.

For every (arch, cell) of the registry on both production meshes (72
plans, 8 skipped cells):

* ``build_cell_plan``: the args' key paths, shapes and dtypes equal to the
  reference's once the port's are put in the reference's layout (a
  module's params and moments stacked by its ``reference_tree``); every
  input sharding's spec equal to the reference's (a per-layer parameter's
  spec with its stack entries restored as ``None``); ``model_flops`` within
  rtol 1e-12 and ``static_meta`` equal;
* ``analytic_costs`` within rtol 1e-12;
* the dry-run's ``memory.argument_bytes`` equal to the sum of the
  reference's ``NamedSharding.shard_shape`` bytes over every input leaf
  (and ``output_bytes`` of a train cell to its state's);
* a skipped cell's reason equal to the reference's, and both packages'
  ``build_cell_plan`` refuse it;
* the CLI (``python -m repro_torch.launch.dryrun --device cpu``) for one
  cell of each family.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from torch import nn

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import costs as ref_costs
from repro.launch.steps import build_cell_plan as ref_build_cell_plan
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import make_production_mesh, mesh_for, n_chips
from repro_torch.launch.steps import build_cell_plan
from repro_torch.train.trainer import TrainState
from repro_torch.train.tree import flatten_with_paths

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 120
RTOL = 1e-12
REF_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
              "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, c, m) for a in sorted(ARCHS) for c in sorted(ARCHS[a].cells) for m in REF_MESHES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a file: the suite's parallel workers would
    otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_grid_is_the_references():
    assert len(CELLS) == 80
    assert sum(ARCHS[a].cells[c].skip is None for a, c, _ in CELLS) == 72
    assert {(a, c) for a, c, _ in CELLS} == {(a, c) for a, s in REF_ARCHS.items() for c in s.cells}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) else str(
        np.dtype(x.dtype))


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefNamedSharding))[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def _reference_layout(arg):
    """A port arg in the reference's layout: a module's params (and a train
    state's moments) stacked by its ``reference_tree``."""
    if isinstance(arg, nn.Module):
        return arg.reference_tree(dict(arg.named_parameters()))
    if isinstance(arg, TrainState):
        return arg.to_tree()
    return arg


_NAMED = re.compile(r"^(\[\d+\](?:\.params|\.opt\.m|\.opt\.v)?)\['([^']+)'\]$")


def _specs_on_reference_paths(plan):
    """reference key path -> the set of specs the port gives the leaves at
    that path, a per-layer parameter's with its stack entries restored."""
    maps = {}
    for i, arg in enumerate(plan.args):
        module = arg.params if isinstance(arg, TrainState) else arg
        if isinstance(module, nn.Module):
            flat, paths = sh.reference_leaf_paths(module)
            maps[i] = (paths, {p: leaf.dim() for p, leaf in flat},
                       {n: p.dim() for n, p in module.named_parameters()})
    out = {}
    for path, s in flatten_with_paths(plan.in_shardings)[0]:
        m = _NAMED.match(path)
        i = int(path[1:path.index("]")])
        if m and i in maps and m.group(2) in maps[i][0]:
            paths, ref_dims, dims = maps[i]
            ref_path = paths[m.group(2)]
            spec = (None,) * (ref_dims[ref_path] - dims[m.group(2)]) + tuple(s.spec)
            path = m.group(1) + ref_path
        else:
            spec = tuple(s.spec)
        out.setdefault(path, set()).add(spec)
    return out


@pytest.fixture(scope="module")
def plans():
    """(arch, cell, mesh) -> (port plan, reference plan), built once."""
    cache = {}

    def get(arch_id, cell, mesh_name):
        key = (arch_id, cell, mesh_name)
        if key not in cache:
            cache[key] = (build_cell_plan(ARCHS[arch_id], cell, mesh_for(mesh_name, "cpu")),
                          ref_build_cell_plan(REF_ARCHS[arch_id], cell, REF_MESHES[mesh_name]))
        return cache[key]

    return get


@pytest.mark.parametrize("arch_id,cell,mesh_name", CELLS)
def test_cell_plan_equals_the_references(arch_id, cell, mesh_name, plans):
    spec, ref_spec = ARCHS[arch_id], REF_ARCHS[arch_id]
    if spec.cells[cell].skip is not None:
        assert spec.cells[cell].skip == ref_spec.cells[cell].skip
        rec = dryrun.run_cell(arch_id, cell, mesh_name, "cpu")
        assert rec["status"] == "skipped" and rec["skip_reason"] == ref_spec.cells[cell].skip
        with pytest.raises(ValueError, match="is skipped"):
            build_cell_plan(spec, cell, mesh_for(mesh_name, "cpu"))
        with pytest.raises(ValueError, match="is skipped"):
            ref_build_cell_plan(ref_spec, cell, REF_MESHES[mesh_name])
        return
    plan, ref = plans(arch_id, cell, mesh_name)
    assert (plan.arch_id, plan.shape_name, plan.kind) == (ref.arch_id, ref.shape_name, ref.kind)
    assert callable(plan.fn)

    # args: key paths, shapes, dtypes
    got = {p: (tuple(x.shape), _dtype(x)) for p, x in flatten_with_paths(
        tuple(_reference_layout(a) for a in plan.args))[0]}
    want = {p: (tuple(x.shape), _dtype(x)) for p, x in _ref_flat(ref.args).items()}
    assert got == want
    assert all(x.device.type == "meta" for x in
               (leaf for _, leaf in flatten_with_paths(dryrun.plan_values(plan.args))[0]))

    # input shardings
    got_specs = _specs_on_reference_paths(plan)
    want_specs = {p: tuple(s.spec) for p, s in _ref_flat(ref.in_shardings).items()}
    assert got_specs.keys() == want_specs.keys()
    for path, specs in got_specs.items():
        assert specs == {want_specs[path]}, path

    np.testing.assert_allclose(plan.model_flops, ref.model_flops, rtol=RTOL)
    assert plan.static_meta == ref.static_meta


@pytest.mark.parametrize("arch_id,cell,mesh_name",
                         [c for c in CELLS if ARCHS[c[0]].cells[c[1]].skip is None])
def test_costs_and_dryrun_bytes_equal_the_references(arch_id, cell, mesh_name, plans):
    spec, ref_spec = ARCHS[arch_id], REF_ARCHS[arch_id]
    plan, ref = plans(arch_id, cell, mesh_name)
    dims = dict(spec.cells[cell].dims)
    if spec.family == "gnn":
        dims["_n_nodes"] = plan.static_meta["n_nodes"]
        dims["_n_edges"] = plan.static_meta["n_edges"]
    got = costs.analytic_costs(spec.family, spec.cells[cell].kind, spec.config_for(cell), dims)
    want = ref_costs.analytic_costs(ref_spec.family, ref_spec.cells[cell].kind,
                                    ref_spec.config_for(cell), dims)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)

    def shard_bytes(args, shardings):
        leaves = jax.tree.leaves(args)
        shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, RefNamedSharding))
        assert len(leaves) == len(shs)
        return sum(int(np.prod(s.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
                   for x, s in zip(leaves, shs))

    rec = dryrun.run_cell(arch_id, cell, mesh_name, "cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == REF_MESHES[mesh_name].size
    assert rec["memory"]["argument_bytes"] == shard_bytes(ref.args, ref.in_shardings)
    if plan.kind == "train":
        assert rec["memory"]["output_bytes"] == shard_bytes(ref.args[0], ref.in_shardings[0])
    assert rec["cost"]["flops_total_analytic"] == got["flops"]
    assert rec["cost"]["bytes_total_analytic"] == got["bytes"]
    r = rec["roofline"]
    assert r["compute_s"] == got["flops"] / rec["chips"] / dryrun.PEAK_FLOPS_BF16
    assert r["memory_s"] == got["bytes"] / rec["chips"] / dryrun.HBM_BW
    assert r["step_time_lower_bound_s"] == max(r["compute_s"], r["memory_s"])
    assert r["bottleneck"] in ("compute_s", "memory_s") and r["collective_s"] is None


def test_production_meshes_are_the_references():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        ref = REF_MESHES["multi" if multi else "single"]
        assert mesh.axis_names == ref.axis_names and mesh.shape == dict(ref.shape)
        assert n_chips(mesh) == ref.size
    with pytest.raises(ValueError, match="unknown mesh"):
        mesh_for("huge", "cpu")


def test_recsys_dense_params_equal_the_references():
    for arch_id in ("dcn-v2", "din", "sasrec", "wide-deep"):
        for cfg, ref_cfg in ((ARCHS[arch_id].smoke_config(), REF_ARCHS[arch_id].smoke_config()),
                             (ARCHS[arch_id].config_for("train_batch"),
                              REF_ARCHS[arch_id].config_for("train_batch"))):
            assert costs.recsys_dense_params(cfg) == ref_costs.recsys_dense_params(ref_cfg)


@pytest.mark.parametrize("arch_id,cell", [("gemma3-1b", "decode_32k"), ("graphcast", "molecule"),
                                          ("wide-deep", "retrieval_cand")])
def test_dryrun_cli_on_the_cpu(arch_id, cell, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_id, "--shape", cell,
         "--mesh", "both", "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=CLI_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"[ok] {arch_id}/{cell}/single",
                                                  f"[ok] {arch_id}/{cell}/multi"]
    for mesh_name in ("single", "multi"):
        with open(tmp_path / f"{arch_id}__{cell}__{mesh_name}.json") as f:
            rec = json.load(f)
        assert rec == json.loads(json.dumps(dryrun.run_cell(arch_id, cell, mesh_name, "cpu"),
                                            default=str)) | {"wall_s": rec["wall_s"]}
        assert rec["memory"]["temp_bytes"] is None and rec["hlo_lines"] is None


def test_dryrun_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("gemma3-1b", "train_4k", "single")
