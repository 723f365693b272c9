"""The port's partition rules (``repro_torch.distributed.sharding``) against
the JAX reference's, on the CPU.

* every case of ``tests/test_sharding.py`` on the port's ``spec_for_path``,
  equal to the reference's ``PartitionSpec`` as tuples, and the rule tables
  equal;
* ``param_specs`` of all 10 archs, at their smoke and full configs, on both
  production meshes (the reference's on a ``jax.sharding.AbstractMesh``):
  the port's specs on its params in the reference's stacked layout equal
  the reference's leaf by leaf, and each of the port's own (per-layer)
  parameters gets the spec of the stacked leaf it is a slice of, the stack
  entries dropped; at smoke size the slicing itself is checked on values;
* ``cache_shardings``, ``batch_shardings`` and ``train_state_shardings``
  equal to the reference's;
* the port's ``block`` of each rank equal to the reference's
  ``NamedSharding.devices_indices_map`` at meshes (2, 4) and (2, 2, 2): the
  reference runs in a subprocess with 8 forced host devices and its own
  timeout.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as RefP

from repro.archs import gnn as ref_gnn
from repro.archs import recsys as ref_recsys
from repro.archs import transformer as ref_tf
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import batch_specs as ref_batch_specs
from repro.distributed import sharding as ref_sh
from repro.train.trainer import abstract_train_state as ref_abstract_train_state
from repro_torch.archs import gnn, recsys, transformer
from repro_torch.configs import ARCHS, batch_specs
from repro_torch.distributed import sharding as sh
from repro_torch.train.trainer import abstract_train_state
from repro_torch.train.tree import flatten_with_paths

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 120
MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite may run test files in parallel workers; one torch thread
    a file keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, names = MESHES[name]
    return sh.make_mesh(shape, names, device="cpu"), AbstractMesh(shape, names)


def _ref_leaves(tree):
    """key path -> leaf of a reference tree whose leaves are specs,
    shardings or arrays."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (RefP, RefNamedSharding)))[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def _spec(x):
    return tuple(x.spec if isinstance(x, (sh.NamedSharding, RefNamedSharding)) else x)


# ---------------------------------------------------------------------------
# the rule functions: every case of tests/test_sharding.py
# ---------------------------------------------------------------------------

AXES = ("data",)
MULTI = ("pod", "data")
MESH = {"data": 16, "model": 16}
MESH_MULTI = {"pod": 2, "data": 16, "model": 16}
BIG = ref_sh.FSDP_MIN_BYTES + 1
RULE_CASES = {
    "lm_column_parallel": (".blocks.0.attn.wq", (7168, 7168), "LM_RULES", AXES, MESH, BIG),
    "lm_row_parallel": (".blocks.0.attn.wo", (7168, 7168), "LM_RULES", AXES, MESH, BIG),
    "lm_small_leaf_drops_fsdp": (".blocks.0.attn.wq", (1152, 1024), "LM_RULES", AXES, MESH, 1024),
    "lm_stacked_leading_axes_unsharded": (".blocks.0.mlp.w_up", (4, 6, 1152, 6912), "LM_RULES",
                                          AXES, MESH, BIG),
    "lm_vocab_sharded_embed": (".embed", (256000, 3072), "LM_RULES", AXES, MESH, BIG),
    "moe_ep_when_divisible": (".blocks.0.moe.w_gate", (64, 2048, 1408), "LM_RULES", AXES, MESH,
                              BIG),
    "moe_fallback_when_not_divisible": (".blocks.0.moe.w_gate", (40, 1536, 512), "LM_RULES", AXES,
                                        MESH, BIG),
    "norms_replicated": (".blocks.0.ln_attn.scale", (7168,), "LM_RULES", AXES, MESH, BIG),
    "recsys_table_all_axes": (".table", (41_943_040, 16), "RECSYS_RULES", AXES, MESH, BIG),
    "recsys_table_fallback_model_only": (".table", (1040, 16), "RECSYS_RULES", AXES, MESH, BIG),
    "recsys_tiny_table_replicated": (".table", (100, 16), "RECSYS_RULES", AXES, MESH, BIG),
    "multipod_data_axes_grouped": (".blocks.0.attn.wq", (7168, 7168), "LM_RULES", MULTI,
                                   MESH_MULTI, BIG),
    "divisibility_partial_degrade": (".embed", (49155, 1536), "LM_RULES", AXES, MESH, BIG),
    "no_rule_replicated": (".unknown.leaf", (64, 64), "GNN_RULES", AXES, MESH, BIG),
    "no_size_given": (".blocks.0.attn.wq", (1152, 1024), "LM_RULES", AXES, MESH, None),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_spec_for_path_equals_the_references(case):
    path, shape, table, data, mesh_shape, nbytes = RULE_CASES[case]
    want = ref_sh.spec_for_path(path, shape, getattr(ref_sh, table), ref_sh.Axes(data=data),
                                mesh_shape, nbytes)
    got = sh.spec_for_path(path, shape, getattr(sh, table), sh.Axes(data=data), mesh_shape,
                           nbytes)
    assert isinstance(got, sh.PartitionSpec)
    assert tuple(got) == tuple(want)


def test_rule_tables_are_the_references():
    assert sh.FSDP_MIN_BYTES == ref_sh.FSDP_MIN_BYTES
    for table in ("LM_RULES", "GNN_RULES", "RECSYS_RULES"):
        assert getattr(sh, table) == getattr(ref_sh, table)
    assert sh.RULES_BY_FAMILY.keys() == ref_sh.RULES_BY_FAMILY.keys()
    for family, rules in sh.RULES_BY_FAMILY.items():
        assert rules == ref_sh.RULES_BY_FAMILY[family]
    assert sh.normalize_path("['blocks'][0]['attn']['wq']") == ref_sh.normalize_path(
        "['blocks'][0]['attn']['wq']") == ".blocks.0.attn.wq"


# ---------------------------------------------------------------------------
# param_specs of every arch
# ---------------------------------------------------------------------------

ABSTRACT = {
    "lm": (transformer.abstract_lm_params, ref_tf.abstract_lm_params),
    "gnn": (gnn.abstract_gnn_params, ref_gnn.abstract_gnn_params),
    "recsys": (recsys.abstract_params, ref_recsys.abstract_params),
}
INIT = {"lm": transformer.init_lm_params, "gnn": gnn.init_gnn_params,
        "recsys": recsys.init_params}


def _configs(arch_id, size):
    """(port config, reference config): the smoke config, or the published
    one of the arch's first cell."""
    spec, ref_spec = ARCHS[arch_id], REF_ARCHS[arch_id]
    if size == "smoke":
        return spec.smoke_config(), ref_spec.smoke_config()
    first = next(iter(spec.cells))
    return spec.config_for(first), ref_spec.config_for(first)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_param_specs_equal_the_references(arch_id, size, mesh_name):
    family = ARCHS[arch_id].family
    cfg, ref_cfg = _configs(arch_id, size)
    mesh, ref_mesh = _meshes(mesh_name)
    port_abs, ref_abs = ABSTRACT[family]
    model = port_abs(cfg)
    want = {p: tuple(s) for p, s in _ref_leaves(
        ref_sh.param_specs(ref_abs(ref_cfg), family, ref_mesh)).items()}

    # the port's rules on its params in the reference's layout
    flat, paths = sh.reference_leaf_paths(model)
    stacked = {p: leaf for p, leaf in flat}
    on_layout = sh.param_specs(model.reference_tree(
        {n: torch.empty_like(p, device="meta") for n, p in model.named_parameters()}),
        family, mesh)
    assert {p: tuple(s) for p, s in flatten_with_paths(on_layout)[0]} == want

    # each of the port's parameters: the stacked leaf's spec, stack entries dropped
    specs = sh.param_specs(model, family, mesh)
    named = dict(model.named_parameters())
    assert specs.keys() == named.keys()
    assert set(paths.values()) == set(want)
    for name, p in named.items():
        ref_spec, ref_shape = want[paths[name]], tuple(stacked[paths[name]].shape)
        drop = len(ref_shape) - p.dim()
        assert ref_shape[drop:] == tuple(p.shape), name
        assert all(e is None for e in ref_spec[:drop]), name
        assert tuple(specs[name]) == ref_spec[drop:], name
    if size == "smoke":  # the slicing, on values
        real = INIT[family](torch.Generator().manual_seed(0), cfg, "cpu")
        real_named = dict(real.named_parameters())
        ref_layout = dict(flatten_with_paths(real.reference_tree(real_named))[0])
        for name, p in real_named.items():
            leaf = ref_layout[paths[name]]
            drop = leaf.dim() - p.dim()
            rows = leaf.reshape((-1,) + tuple(p.shape)) if drop else leaf[None]
            assert any(torch.equal(r, p) for r in rows), name


# ---------------------------------------------------------------------------
# cache, batch and train-state shardings
# ---------------------------------------------------------------------------

DECODE_CELLS = [(a, c) for a, spec in sorted(ARCHS.items()) for c, cell in spec.cells.items()
                if cell.kind == "decode" and cell.skip is None]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id,cell", DECODE_CELLS)
def test_cache_shardings_equal_the_references(arch_id, cell, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    got = sh.cache_shardings(batch_specs(ARCHS[arch_id], cell)["cache"], mesh)
    want = _ref_leaves(ref_sh.cache_shardings(ref_batch_specs(REF_ARCHS[arch_id], cell)["cache"],
                                              ref_mesh))
    assert {p: _spec(s) for p, s in flatten_with_paths(got)[0]} == {
        p: _spec(s) for p, s in want.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fully", [False, True])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_batch_shardings_equal_the_references(arch_id, fully, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    for cell in ARCHS[arch_id].cells:
        batch = {k: v for k, v in batch_specs(ARCHS[arch_id], cell).items() if k != "cache"}
        ref_batch = {k: v for k, v in ref_batch_specs(REF_ARCHS[arch_id], cell).items()
                     if k != "cache"}
        got = sh.batch_shardings(batch, mesh, fully_shard=fully)
        want = _ref_leaves(ref_sh.batch_shardings(ref_batch, ref_mesh, fully_shard=fully))
        assert {p: _spec(s) for p, s in flatten_with_paths(got)[0]} == {
            p: _spec(s) for p, s in want.items()}, cell
    assert _spec(sh.batch_dim_sharding(mesh, 2)) == _spec(ref_sh.batch_dim_sharding(ref_mesh, 2))
    assert _spec(sh.fully_sharded_dim(mesh, 1)) == _spec(ref_sh.fully_sharded_dim(ref_mesh, 1))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", ["gemma3-1b", "granite-moe-3b-a800m", "graphcast", "dcn-v2",
                                     "sasrec"])
def test_train_state_shardings_equal_the_references(arch_id, mesh_name):
    """On the state of the module (moments keyed by parameter name) and on
    the state of its params in the reference's layout (key paths equal to
    the reference's)."""
    family = ARCHS[arch_id].family
    mesh, ref_mesh = _meshes(mesh_name)
    cfg, ref_cfg = _configs(arch_id, "full")
    port_abs, ref_abs = ABSTRACT[family]
    model = port_abs(cfg)
    want = {p: _spec(s) for p, s in _ref_leaves(ref_sh.train_state_shardings(
        ref_abstract_train_state(ref_abs(ref_cfg)), family, ref_mesh)).items()}
    layout = model.reference_tree(
        {n: torch.empty_like(p, device="meta") for n, p in model.named_parameters()})
    got = sh.train_state_shardings(abstract_train_state(layout), family, mesh)
    assert {p: _spec(s) for p, s in flatten_with_paths(got)[0]} == want

    state_sh = sh.train_state_shardings(abstract_train_state(model), family, mesh)
    specs = sh.param_specs(model, family, mesh)
    for tree in (state_sh.params, state_sh.opt.m, state_sh.opt.v):
        assert {n: _spec(s) for n, s in tree.items()} == {n: tuple(s) for n, s in specs.items()}
    assert _spec(state_sh.step) == _spec(state_sh.opt.count) == ()


def test_specs_and_shardings_are_tree_leaves():
    mesh = sh.make_mesh((2, 4), ("data", "model"), device="cpu")
    tree = {"a": sh.P("data", None), "b": [sh.NamedSharding(mesh, sh.P(None, "model"))]}
    flat, _ = flatten_with_paths(tree)
    assert [p for p, _ in flat] == ["['a']", "['b'][0]"]
    assert sh.P(("pod", "data"), "model") == (("pod", "data"), "model")
    assert sh.P() == () and sh.P(None) != sh.P()
    with pytest.raises(ValueError, match="names axis 'pod'"):
        sh.NamedSharding(mesh, sh.P("pod"))


# ---------------------------------------------------------------------------
# blocks against the reference's devices_indices_map
# ---------------------------------------------------------------------------

BLOCK_SPECS = [
    ((), (8, 6)),
    (("data",), (8, 6)),
    (("model",), (8, 6)),
    ((None, "model"), (6, 8)),
    (("data", "model"), (4, 8)),
    (("model", "data"), (8, 4)),
    ((("data", "model"),), (16, 3)),
    ((("model", "data"), None), (16, 3)),
    ((None, ("data", "model"), None), (2, 8, 3)),
]
BLOCK_SPECS_3D = [
    ((("pod", "data"), "model"), (8, 4)),
    ((("pod", "data", "model"), None), (16, 2)),
    (("pod", None, "model"), (2, 3, 4)),
    ((("data", "pod"),), (8,)),
    ((None, ("model", "pod")), (3, 8)),
    (("data",), (4, 2)),
]

_REF_BLOCKS = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
shape, names, cases = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(names))
flat = list(mesh.devices.flat)
out = []
for spec, arr_shape in cases:
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(arr_shape))
    out.append([[[s.start or 0, arr_shape[d] if s.stop is None else s.stop]
                 for d, s in enumerate(idx[dev])] for dev in flat])
print(json.dumps(out))
"""


@pytest.mark.parametrize("mesh_shape,names,cases", [
    ((2, 4), ("data", "model"), BLOCK_SPECS),
    ((2, 2, 2), ("pod", "data", "model"), BLOCK_SPECS_3D),
])
def test_blocks_equal_the_references_devices_indices_map(mesh_shape, names, cases):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([mesh_shape, names, [[list(s), list(a)] for s, a in cases]])
    out = subprocess.run([sys.executable, "-c", _REF_BLOCKS, arg], capture_output=True, text=True,
                         env=env, timeout=SUBPROCESS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    mesh = sh.make_mesh(mesh_shape, names, device="cpu")
    for (spec, arr_shape), ranks in zip(cases, ref):
        x = torch.arange(int(np.prod(arr_shape))).reshape(arr_shape)
        sharding = sh.NamedSharding(mesh, spec)
        blocks = [sharding.block(x, r) for r in range(mesh.size)]
        for r, bounds in enumerate(ranks):
            want = x[tuple(slice(a, b) for a, b in bounds)]
            assert torch.equal(blocks[r], want), (spec, r)
            assert tuple(blocks[r].shape) == sharding.shard_shape(arr_shape)
        assert torch.equal(sharding.assemble(blocks), x)
