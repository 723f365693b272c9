"""The port's elastic meshes, state placement, batch sharding and the
ambient mesh (``repro_torch.distributed.elastic``, ``shard_batch``,
``use_mesh``) against the JAX reference, on the CPU.

* ``best_effort_mesh``'s shape and axis names for every device count from 1
  to 600, with and without ``multi_pod``, equal to what the reference's
  function asks ``jax.make_mesh`` for given that many devices; a process
  group's size is the count while one is up;
* ``reshard_state`` of a trained smoke LM's state onto a (2, 4) mesh and
  from its reassembled blocks onto (4, 2) and (1, 1): every rank's bytes
  what ``train_state_shardings`` gives, the blocks reassembled bit for bit;
  over a gloo world of one, this rank's blocks;
* ``shard_batch`` of an LM and a recsys batch: each rank's rows, and the
  blocks reassembled bit for bit;
* ``moe`` under ``use_mesh`` at data sizes 2 and 8 (``n_groups`` 0) equal
  to the reference's ``moe`` with that ``n_groups``: every group's chosen
  experts, ``keep``, ``slot`` and token order equal, output and aux loss
  within rtol 1e-5 (atol 1e-6); outside a mesh one group; a dp-layout
  Transformer's block groups over every mesh axis, a decode step too.
"""
import dataclasses
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.archs import layers as ref_layers
from repro.distributed import elastic as ref_elastic
from repro_torch.archs import layers, transformer
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import lm_token_batches, recsys_batches, shard_batch
from repro_torch.distributed import elastic, sharding as sh
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.tree import flatten_with_paths

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a file: the suite's parallel workers would
    otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# best_effort_mesh
# ---------------------------------------------------------------------------

TOPOLOGIES = [(2, 16, 16), (1, 2, 4), (3, 5, 7), (1, 1, 1)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_best_effort_mesh_equals_the_references_rule(topo, multi_pod, monkeypatch):
    asked = []
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names: asked.append(
        (tuple(shape), tuple(names))))
    for n in range(1, 601):
        monkeypatch.setattr(jax, "devices", lambda n=n: [object()] * n)
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        ref_elastic.best_effort_mesh(ref_elastic.MeshTopology(*topo), multi_pod=multi_pod)
        mesh = elastic.best_effort_mesh(elastic.MeshTopology(*topo), multi_pod=multi_pod,
                                        device="cpu")
        assert (mesh.axis_sizes, mesh.axis_names) == asked[-1], n
        assert mesh.device == torch.device("cpu")


def test_best_effort_mesh_counts_the_process_group(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 64)
    topo = elastic.MeshTopology(pods=1, data=2, model=4)
    assert elastic.best_effort_mesh(topo, device="cpu").axis_sizes == (2, 4)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=30))
    try:
        assert elastic.best_effort_mesh(topo, device="cpu").axis_sizes == (1, 4)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# reshard_state and shard_batch
# ---------------------------------------------------------------------------


def _trained_lm_state():
    """gemma3-1b's smoke config after one step (moments not zero)."""
    cfg = ARCHS["gemma3-1b"].smoke_config()
    model = transformer.init_lm_params(torch.Generator().manual_seed(0), cfg, "cpu")
    step = make_train_step(lambda p, b: transformer.lm_loss(p, b["tokens"], b["labels"], cfg),
                           AdamWConfig(warmup_steps=1))
    state, _ = step(init_train_state(model), next(lm_token_batches(cfg.vocab, 8, 16,
                                                                   device="cpu")))
    return state


def _leaves(tree):
    return [leaf for _, leaf in flatten_with_paths(tree)[0]]


def _check_placed(placed, values, shardings, n_ranks):
    """Every rank's bytes what the shardings give; every rank's tree of the
    values' structure; reassembled bit for bit."""
    assert len(placed) == n_ranks
    want = sh.nbytes(values, shardings)
    paths = [p for p, _ in flatten_with_paths(values)[0]]
    for tree in placed:
        assert [p for p, _ in flatten_with_paths(tree)[0]] == paths
        blocks = _leaves(tree)
        assert sum(b.numel() * b.element_size() for b in blocks) == want
        assert all(b.is_contiguous() for b in blocks)
    for got, x in zip(_leaves(sh.assemble_tree(placed, shardings)), _leaves(values)):
        assert got.dtype == x.dtype and torch.equal(got, x)


def test_reshard_state_round_trip_between_meshes(tmp_path):
    state = _trained_lm_state()
    values = dataclasses.replace(state, params=dict(state.params.named_parameters()))
    mesh_a = sh.make_mesh((2, 4), ("data", "model"), device="cpu")
    placed = elastic.reshard_state(state, "lm", mesh_a)
    sh_a = sh.train_state_shardings(state, "lm", mesh_a)
    _check_placed(placed, values, sh_a, 8)
    assert any(len(s.spec) and any(e is not None for e in s.spec) for s in _leaves(sh_a))
    # recovery: reassemble on the host, place on other meshes
    host = sh.assemble_tree(placed, sh_a)
    for shape in ((4, 2), (1, 1)):
        mesh_b = sh.make_mesh(shape, ("data", "model"), device="cpu")
        again = elastic.reshard_state(dataclasses.replace(state, params=host.params), "lm", mesh_b)
        _check_placed(again, values, sh.train_state_shardings(state, "lm", mesh_b), mesh_b.size)
    # over a process group: this rank's blocks
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=30))
    try:
        one = sh.make_mesh((1, 1), ("data", "model"), device="cpu")
        mine = elastic.reshard_state(state, "lm", one, group=dist.group.WORLD)
        for got, x in zip(_leaves(mine), _leaves(values)):
            assert torch.equal(got, x)
        with pytest.raises(ValueError, match="the process group has 1 ranks, the mesh 8"):
            elastic.reshard_state(state, "lm", mesh_a, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", ["lm", "recsys"])
def test_shard_batch_gives_each_rank_its_rows(family):
    if family == "lm":
        batch = next(lm_token_batches(1000, 8, 16, device="cpu"))
    else:
        batch = next(recsys_batches(ARCHS["dcn-v2"].smoke_config(), 8, device="cpu"))
    mesh = sh.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    placed = shard_batch(batch, mesh)
    shardings = sh.batch_shardings(batch, mesh)
    _check_placed(placed, batch, shardings, 8)
    for r, rank_batch in enumerate(placed):
        drank = r // 2  # (pod, data) position: the model rank holds the same rows
        for key, b in rank_batch.items():
            assert torch.equal(b, batch[key][drank * 2:(drank + 1) * 2])
    fully = shard_batch(batch, mesh, sh.batch_shardings(batch, mesh, fully_shard=True))
    for key, x in batch.items():
        assert torch.equal(torch.cat([rank_batch[key] for rank_batch in fully]), x)


# ---------------------------------------------------------------------------
# MoE groups under the ambient mesh
# ---------------------------------------------------------------------------


def _recorded_groups(monkeypatch):
    """Records each group's route as the port's moe dispatches it."""
    seen = []
    dispatch = layers._dispatch_one_group

    def recording(*args):
        out = dispatch(*args)
        seen.append(out[1])
        return out

    monkeypatch.setattr(layers, "_dispatch_one_group", recording)
    return seen


@pytest.mark.parametrize("data", [2, 8])
def test_moe_under_a_mesh_forms_the_references_groups(data, monkeypatch):
    rng = np.random.default_rng(data)
    B, S, D, E, K = 8, 32, 32, 4, 2
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, d_expert_ff=16, capacity_factor=1.0)
    cfg = layers.MoEConfig(**kw, n_groups=0)
    rcfg = ref_layers.MoEConfig(**kw, n_groups=data)
    rp = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape) / np.sqrt(s.shape[-2]),
                                            jnp.float32),
                      jax.eval_shape(lambda: ref_layers.moe_params(jax.random.PRNGKey(0), D, rcfg)))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax.device_get(rp))
    seen = _recorded_groups(monkeypatch)
    mesh = sh.make_mesh((data, 1), ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        assert sh.ambient_axis_size("all") == sh.ambient_axis_size("data") == data
        y, aux = layers.moe(p, torch.from_numpy(x), cfg)
    assert sh.current_axes() is None and sh.ambient_axis_size("all") == 1
    assert len(seen) == data

    T, G = B * S, data
    Tg = T // G
    C = layers._capacity(Tg, cfg)

    @jax.jit
    def ref_route(xr, router):
        logits = xr.reshape(T, D) @ router
        return jax.vmap(lambda a, b: ref_layers._dispatch_one_group(a, b, rcfg, C, jnp.float32))(
            xr.reshape(G, Tg, D), logits.reshape(G, Tg, E))[1]

    route_r = ref_route(jnp.asarray(x), rp["router"])
    for g, (gate, keep, slot, tok, flat_e) in enumerate(seen):
        np.testing.assert_array_equal(flat_e.numpy(), np.asarray(route_r[4][g]))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(route_r[1][g]))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(route_r[2][g]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(route_r[3][g]))
    assert not bool(np.asarray(route_r[1]).all())  # capacity 1.0: some tokens drop
    y_r, aux_r = jax.jit(lambda pp, xx: ref_layers.moe(pp, xx, rcfg))(rp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    seen.clear()
    layers.moe(p, torch.from_numpy(x), cfg)  # outside a mesh: one group
    assert len(seen) == 1


def test_transformer_blocks_group_over_the_mesh(monkeypatch):
    """A dp-layout MoE model groups its tokens over every axis (``"all"``),
    a TP-layout one over the data axes; decode groups over every axis."""
    cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"].smoke_config(), n_layers=1)
    model = transformer.init_lm_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(1))
    seen = _recorded_groups(monkeypatch)
    mesh = sh.make_mesh((2, 2), ("data", "model"), device="cpu")
    with sh.use_mesh(mesh):
        for dp, want in ((True, 4), (False, 2)):
            seen.clear()
            transformer.lm_hidden_states(model, tokens, dataclasses.replace(cfg, dp_layout=dp))
            assert len(seen) == want * cfg.n_layers, dp
        seen.clear()
        cache = transformer.init_cache(transformer.CacheSpec(cfg, 4, 8), device="cpu")
        transformer.lm_decode_step(model, cache, tokens[:, :1], torch.zeros(4, dtype=torch.int32),
                                   cfg)
        assert len(seen) == 4 * cfg.n_layers  # 4 tokens over 4 ranks: a token a group
    assert sh.constraint(tokens, mesh, "data") is tokens and sh.act(tokens, "data", None) is tokens
