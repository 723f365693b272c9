"""The port's top-k utilities against the JAX reference, ties included.

Every tie must go to the lowest index, as ``lax.top_k`` breaks them; the
inputs are built to be full of ties (all equal, all ``-inf``, quantized
scores) and ragged (tiles that do not divide, k past the tile and past n).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (their packages re-export a function of the same name)
ref_topk_mod = importlib.import_module("repro.core.topk")
port_topk_mod = importlib.import_module("repro_torch.core.topk")

pytestmark = pytest.mark.torch_port


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "all_equal": np.full((3, 37), 2.5, np.float32),
        "all_neginf": np.full((3, 37), -np.inf, np.float32),
        "quantized": rng.integers(0, 4, (4, 101)).astype(np.float32),
        "mixed_neginf": np.where(rng.random((2, 64)) < 0.5, -np.inf,
                                 rng.integers(0, 3, (2, 64))).astype(np.float32),
        "distinct": rng.standard_normal((2, 50)).astype(np.float32),
    }


INPUTS = _inputs()


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]).astype(np.int64), np.asarray(want[1]).astype(np.int64))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("k", [1, 5, 37, 200])
def test_topk(name, k):
    x = INPUTS[name]
    _eq(port_topk_mod.topk(torch.as_tensor(x), k), ref_topk_mod.topk(jnp.asarray(x), k))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("k,num_tiles", [(1, 1), (4, 3), (10, 4), (30, 7), (200, 5), (6, 37)])
def test_tiled_topk(name, k, num_tiles):
    x = INPUTS[name]
    _eq(port_topk_mod.tiled_topk(torch.as_tensor(x), k, num_tiles),
        ref_topk_mod.tiled_topk(jnp.asarray(x), k, num_tiles))


def _pools(seed, n_a=9, n_b=7):
    rng = np.random.default_rng(seed)
    sa = rng.integers(0, 3, (2, n_a)).astype(np.float32)
    sb = rng.integers(0, 3, (2, n_b)).astype(np.float32)
    sb[:, -2:] = -np.inf
    ids = rng.permutation(200)[: n_a + n_b].astype(np.int32)
    ia = np.tile(ids[:n_a], (2, 1))
    ib = np.tile(ids[n_a:], (2, 1))
    return sa, ia, sb, ib


@pytest.mark.parametrize("fn", ["merge_topk", "merge_pools_by_id"])
@pytest.mark.parametrize("k", [1, 6, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges(fn, k, seed):
    sa, ia, sb, ib = _pools(seed)
    got = getattr(port_topk_mod, fn)(*map(torch.as_tensor, (sa, ia, sb, ib)), k)
    want = getattr(ref_topk_mod, fn)(*map(jnp.asarray, (sa, ia, sb, ib)), k)
    _eq(got, want)


def test_merge_all_equal_scores_canonical_ids():
    s = np.zeros((1, 4), np.float32)
    a, b = np.array([[9, 3, 7, 1]], np.int32), np.array([[8, 2, 6, 0]], np.int32)
    got = port_topk_mod.merge_pools_by_id(torch.as_tensor(s), torch.as_tensor(a),
                                          torch.as_tensor(s), torch.as_tensor(b), 5)
    np.testing.assert_array_equal(got[1].numpy(), [[0, 1, 2, 3, 6]])
