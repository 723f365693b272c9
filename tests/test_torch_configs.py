"""The port's arch registry (``repro_torch.configs``) against the
reference's (``repro.configs``), on the CPU.

* 10 archs, 40 cells, 4 documented skips, each cell's kind, dims and skip
  reason, each spec's family and source;
* every ``config_for(cell)`` and ``smoke_config()`` equal field by field
  (dtypes through ``torch_dtype``, nested ``MoEConfig`` and ``TableSpec``
  too);
* ``n_params`` (and ``n_active_params``) equal;
* ``batch_specs`` equal in key paths, shapes and dtypes (the port's are
  ``meta`` tensors, the reference's ``ShapeDtypeStruct``s; decode cells
  include the KV cache);
* ``train_step_model_flops`` of all three families and
  ``decode_step_model_flops`` equal.

Every comparison is exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.archs import gnn as ref_gnn
from repro.archs import recsys as ref_recsys
from repro.archs import transformer as ref_tf
from repro_torch import configs
from repro_torch.archs import gnn, recsys, transformer
from repro_torch.train.tree import flatten_with_paths

pytestmark = pytest.mark.torch_port


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a reference (JAX or numpy) dtype, by name:
    ``jnp.bfloat16`` -> ``torch.bfloat16``, ``jnp.float32`` ->
    ``torch.float32``. The port's tests share it to compare configs."""
    return getattr(torch, np.dtype(dtype).name)


def port_config(ref_cfg):
    """A reference config (``LMConfig``, ``GNNConfig``, ``RecsysConfig``,
    with nested ``MoEConfig``/``TableSpec``) as the port's, field by field."""
    from repro_torch.archs.embedding import TableSpec
    from repro_torch.archs.layers import MoEConfig

    classes = {"LMConfig": transformer.LMConfig, "GNNConfig": gnn.GNNConfig,
               "RecsysConfig": recsys.RecsysConfig, "MoEConfig": MoEConfig,
               "TableSpec": TableSpec}
    kw = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = port_config(v)
        elif f.name == "dtype":
            v = torch_dtype(v)
        kw[f.name] = v
    return classes[type(ref_cfg).__name__](**kw)


def assert_same_config(got, ref_cfg):
    assert type(got).__name__ == type(ref_cfg).__name__
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref_cfg)]
    for f in dataclasses.fields(ref_cfg):
        a, b = getattr(got, f.name), getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(b):
            assert_same_config(a, b)
        elif f.name == "dtype":
            assert a == torch_dtype(b), (got.name if hasattr(got, "name") else got, f.name)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


ARCH_IDS = sorted(ref_configs.ARCHS)


def test_registry_counts_and_cells():
    assert sorted(configs.ARCHS) == ARCH_IDS and len(ARCH_IDS) == 10
    cells, ref_cells = configs.all_cells(), ref_configs.all_cells()
    assert len(cells) == len(ref_cells) == 40
    assert sum(c.skip is not None for _, c in cells) == 4
    for (aid, c), (raid, rc) in zip(cells, ref_cells):
        assert aid == raid and dataclasses.asdict(c) == dataclasses.asdict(rc)
    for aid in ARCH_IDS:
        spec, ref = configs.get_arch(aid), ref_configs.get_arch(aid)
        assert (spec.arch_id, spec.family, spec.source) == (ref.arch_id, ref.family, ref.source)
        assert [c.name for c in spec.runnable_cells()] == [c.name for c in ref.runnable_cells()]
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")
    assert configs.LM_SHAPES == ref_configs.LM_SHAPES
    assert configs.GNN_SHAPES == ref_configs.GNN_SHAPES
    assert configs.RECSYS_SHAPES == ref_configs.RECSYS_SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference_field_by_field(arch):
    spec, ref = configs.get_arch(arch), ref_configs.get_arch(arch)
    assert_same_config(spec.smoke_config(), ref.smoke_config())
    assert port_config(ref.smoke_config()) == spec.smoke_config()
    assert spec.smoke_config().n_params() == ref.smoke_config().n_params()
    for shape in ref.cells:
        if spec.family == "recsys" and shape != "train_batch":
            continue  # one config for every recsys cell
        cfg, ref_cfg = spec.config_for(shape), ref.config_for(shape)
        assert_same_config(cfg, ref_cfg)
        assert cfg.n_params() == ref_cfg.n_params()
        if spec.family == "lm":
            assert cfg.n_active_params() == ref_cfg.n_active_params()


def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(x.shape), torch_dtype(x.dtype)) for p, x in leaves]


def _port_specs(tree):
    return [(k, tuple(x.shape), x.dtype) for k, x in flatten_with_paths(tree)[0]]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch):
    spec = configs.get_arch(arch)
    for shape in spec.cells:
        got = configs.batch_specs(spec, shape)
        assert all(x.device.type == "meta" for _, x in flatten_with_paths(got)[0])
        assert _port_specs(got) == _ref_specs(ref_configs.batch_specs(ref_configs.get_arch(arch),
                                                                      shape)), shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    spec, ref = configs.get_arch(arch), ref_configs.get_arch(arch)
    for name, cell in spec.cells.items():
        cfg, ref_cfg, d = spec.config_for(name), ref.config_for(name), cell.dims
        if spec.family == "lm":
            B, S = d["global_batch"], d["seq_len"]
            assert transformer.train_step_model_flops(cfg, B, S) == \
                ref_tf.train_step_model_flops(ref_cfg, B, S)
            assert transformer.decode_step_model_flops(cfg, B, S) == \
                ref_tf.decode_step_model_flops(ref_cfg, B, S)
        elif spec.family == "gnn":
            assert gnn.train_step_model_flops(cfg, d["n_nodes"], d["n_edges"]) == \
                ref_gnn.train_step_model_flops(ref_cfg, d["n_nodes"], d["n_edges"])
        else:
            assert recsys.train_step_model_flops(cfg, d["batch"]) == \
                ref_recsys.train_step_model_flops(ref_cfg, d["batch"])
