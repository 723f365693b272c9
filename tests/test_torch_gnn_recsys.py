"""The port's GNN and recsys families (``archs/gnn.py``,
``archs/recsys.py``, ``archs/embedding.py``), their batches
(``data/pipeline.py``) and the graph substrate (``data/graphs.py``)
against the JAX reference's, on the CPU.

Params in the reference's layout are drawn with numpy from a seed and
carried into the port (``gnn_params_from_reference``,
``recsys_params_from_reference``); the reference's functions run under
``jax.jit``. Both compute in f32 on the host, their products and segment
sums adding in other orders, so:

* GraphCast (sum, mean and max aggregators, masked edges, a node with no
  in-edge, graph readout): forward within rtol 1e-5 (atol 1e-5), gradients
  within rtol 1e-4 and an atol of 1e-5 times the leaf's largest gradient,
  or 1e-8 times the model's largest where that is larger (a leaf whose
  gradient is 0 in exact arithmetic, as the last bias of DIN's attention
  MLP, which the softmax cancels, holds rounding noise only);
  the max aggregate of a node with no in-edge is ``-inf``, as the
  reference's ``segment_max`` leaves it;
* the four recsys kinds: forward, loss and ``score_candidates`` within rtol
  1e-5 (atol 1e-5), gradients as above, ``retrieve_topk`` ids equal;
* ``embedding_bag`` (sum and mean, with and without weights) within rtol
  1e-6;
* ``recsys_batches``, ``gnn_batches`` and every ``data/graphs.py``
  function: array-equal, same dtypes.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import embedding as ref_emb
from repro.archs import gnn as ref_gnn
from repro.archs import recsys as ref_recsys
from repro.configs import get_arch as ref_get_arch
from repro.data import graphs as ref_graphs
from repro.data import pipeline as ref_pipeline
from repro_torch.archs import embedding, gnn, recsys
from repro_torch.configs import get_arch
from repro_torch.data import graphs, pipeline
from test_torch_configs import torch_dtype

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite may run test files in parallel workers (pytest-xdist);
    torch's intra-op threads in each of them would contend for the cores,
    so this file's many small products run on one thread, restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-5
RECSYS = ("dcn-v2", "din", "sasrec", "wide-deep")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def ref_params_like(abstract, seed):
    """Params in the reference's layout for the ``jax.eval_shape`` tree
    ``abstract``, drawn with numpy: matrices at the init's scale (over the
    second-to-last axis), tables at 0.1, vectors (biases, norm offsets) at
    0.1, norm scales about 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape)
        if "scale" in name:
            x = 1.0 + 0.1 * x
        elif "table" in name or "embed" in name or "wide" in name or leaf.ndim == 1:
            x = 0.1 * x
        elif leaf.ndim >= 2:
            x = x / np.sqrt(leaf.shape[-2])
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _grads_close(got_tree, want_tree, what):
    flat, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    got = jax.tree.leaves(jax.tree.map(_np, got_tree))
    assert len(got) == len(flat)
    largest = max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
    for (path, w), g in zip(flat, got):
        w = np.asarray(w)
        atol = GRAD_ATOL_FRAC * max(np.abs(w).max(), 1e-3 * largest)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------
# GraphCast
# --------------------------------------------------------------------------


def _graph(n_nodes, n_edges, seed, *, masked, isolated, readout_graphs=0, d_feat=16,
           n_vars=5):
    """A graph batch (numpy): random edges, the last ``n_edges // 8``
    masked out as padding (pointing anywhere), node ``n_nodes - 1`` with
    no real in-edge when ``isolated``, and every other node with one."""
    rng = np.random.default_rng(seed)
    hi = n_nodes - 1 if isolated else n_nodes
    dst = np.concatenate([np.arange(hi), rng.integers(0, hi, n_edges - hi)]).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    b = {"node_feats": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
         "edge_src": src, "edge_dst": dst,
         "edge_feats": rng.normal(size=(n_edges, 4)).astype(np.float32),
         "node_mask": (rng.random(n_nodes) > 0.1).astype(np.float32)}
    if masked:
        mask = np.ones(n_edges, bool)
        mask[-(n_edges // 8):] = False
        b["edge_mask"] = mask
        b["edge_dst"][-(n_edges // 8):] = rng.integers(0, n_nodes, n_edges // 8)
    if readout_graphs:
        b["graph_ids"] = np.sort(rng.integers(0, readout_graphs, n_nodes)).astype(np.int32)
        b["targets"] = rng.normal(size=(readout_graphs, n_vars)).astype(np.float32)
        b.pop("node_mask")
    else:
        b["targets"] = rng.normal(size=(n_nodes, n_vars)).astype(np.float32)
    return b


GNN_CASES = {
    "sum": dict(aggregator="sum", isolated=True),
    "mean": dict(aggregator="mean", isolated=True),
    "max": dict(aggregator="max", isolated=False),
    "sum_readout": dict(aggregator="sum", isolated=True, readout=True),
}


@pytest.mark.parametrize("case", sorted(GNN_CASES))
def test_graphcast_forward_and_gradients(case):
    kw = GNN_CASES[case]
    readout = kw.get("readout", False)
    cfg = dataclasses.replace(get_arch("graphcast").smoke_config(), aggregator=kw["aggregator"],
                              graph_readout=readout)
    rcfg = dataclasses.replace(ref_get_arch("graphcast").smoke_config(),
                               aggregator=kw["aggregator"], graph_readout=readout)
    rp = ref_params_like(ref_gnn.abstract_gnn_params(rcfg), seed=len(case))
    model = gnn.init_gnn_params(None, cfg, device="meta")
    # n_params is the reference's formula, which leaves out the second
    # layer of the encoders' and processor's MLPs: equal to it, not to a count
    assert cfg.n_params() == rcfg.n_params()
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(rp))
    model = gnn.GNN(cfg, device="cpu")
    model.load_state_dict(gnn.gnn_params_from_reference(jax.device_get(rp)))
    b = _graph(40, 120, seed=3, masked=True, isolated=kw["isolated"],
               readout_graphs=4 if readout else 0)
    batch = {k: _t(v) for k, v in b.items()}
    rb = {k: jnp.asarray(v) for k, v in b.items()}

    out = gnn.gnn_forward(model, batch["node_feats"], batch["edge_src"], batch["edge_dst"], cfg,
                          edge_feats=batch["edge_feats"], edge_mask=batch["edge_mask"],
                          graph_ids=batch.get("graph_ids"), n_graphs=4 if readout else 0)
    out_r = jax.jit(lambda p, bb: ref_gnn.gnn_forward(
        p, bb["node_feats"], bb["edge_src"], bb["edge_dst"], rcfg, edge_feats=bb["edge_feats"],
        edge_mask=bb["edge_mask"], graph_ids=bb.get("graph_ids"),
        n_graphs=4 if readout else 0))(rp, rb)
    assert np.isfinite(np.asarray(out_r)).all()
    _close(out, out_r, what=f"{case} forward")

    (loss_r, _), grads_r = jax.jit(jax.value_and_grad(
        lambda p, bb: ref_gnn.gnn_loss(p, bb, rcfg), has_aux=True))(rp, rb)
    loss, met = gnn.gnn_loss(model, batch, cfg)
    _close(loss.detach(), loss_r, what=f"{case} loss")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _grads_close(model.reference_tree(dict(zip(names, grads))), grads_r, f"{case} gradient")


def test_max_aggregate_of_a_node_with_no_in_edge_is_minus_inf():
    cfg = dataclasses.replace(get_arch("graphcast").smoke_config(), aggregator="max")
    rcfg = dataclasses.replace(ref_get_arch("graphcast").smoke_config(), aggregator="max")
    rng = np.random.default_rng(0)
    msgs = rng.normal(size=(30, 8)).astype(np.float32)
    dst = rng.integers(0, 9, 30).astype(np.int32)  # nodes 9 and 10 get nothing
    got = gnn._aggregate(cfg, _t(msgs), _t(dst), 11)
    want = ref_gnn._aggregate(rcfg, jnp.asarray(msgs), jnp.asarray(dst), 11)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert np.isneginf(_np(got)[9:]).all()
    for agg in ("sum", "mean"):
        c = dataclasses.replace(cfg, aggregator=agg)
        rc = dataclasses.replace(rcfg, aggregator=agg)
        _close(gnn._aggregate(c, _t(msgs), _t(dst), 11),
               ref_gnn._aggregate(rc, jnp.asarray(msgs), jnp.asarray(dst), 11), rtol=1e-6,
               atol=1e-6)


def test_refined_mesh_equals_the_reference():
    for r in (0, 1, 2):
        got, want = gnn.build_refined_mesh(r), ref_gnn.build_refined_mesh(r)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the four recsys kinds
# --------------------------------------------------------------------------


def _retrieval_batch(batch, kind, n_cand, seed):
    """The user-side features of the batch's first row and ``n_cand`` raw
    candidate ids (the ``retrieval_cand`` layout)."""
    drop = {"label", "pos", "neg", "target"}
    out = {k: v[:1] for k, v in batch.items() if k not in drop or (kind == "sasrec"
                                                                   and k in ("pos", "neg"))}
    if kind == "sasrec":
        out = {k: out[k] for k in ("seq", "mask")}
    out["candidates"] = np.random.default_rng(seed).integers(0, 1 << 30, n_cand).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_forward_loss_gradients_and_retrieval(arch):
    cfg, rcfg = get_arch(arch).smoke_config(), ref_get_arch(arch).smoke_config()
    rp = ref_params_like(ref_recsys.abstract_params(rcfg), seed=RECSYS.index(arch))
    model = recsys.init_params(None, cfg, device="cpu")
    assert type(model) is recsys.KINDS[cfg.kind]
    model.load_state_dict(recsys.recsys_params_from_reference(jax.device_get(rp)))
    assert cfg.n_params() == rcfg.n_params() == sum(p.numel() for p in model.parameters())
    b = next(ref_pipeline.recsys_batches(rcfg, 16, seed=2))
    b = {k: np.asarray(v) for k, v in b.items()}
    batch, rb = {k: _t(v) for k, v in b.items()}, {k: jnp.asarray(v) for k, v in b.items()}

    out = recsys.forward(model, batch, cfg)
    _close(out, jax.jit(lambda p, bb: ref_recsys.forward(p, bb, rcfg))(rp, rb), what="forward")
    torch.testing.assert_close(model(batch), out, rtol=0, atol=0)
    (loss_r, met_r), grads_r = jax.jit(jax.value_and_grad(
        lambda p, bb: ref_recsys.loss(p, bb, rcfg), has_aux=True))(rp, rb)
    loss, met = recsys.loss(model, batch, cfg)
    _close(loss.detach(), loss_r, what="loss")
    assert set(met) == set(met_r)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _grads_close(model.reference_tree(dict(zip(names, grads))), grads_r, f"{arch} gradient")

    rq = _retrieval_batch(b, cfg.kind, 3000, seed=4)
    scores = recsys.score_candidates(model, {k: _t(v) for k, v in rq.items()}, cfg)
    rq_j = {k: jnp.asarray(v) for k, v in rq.items()}
    _close(scores, jax.jit(lambda p, q: ref_recsys.score_candidates(p, q, rcfg))(rp, rq_j),
           what="score_candidates")
    s, ids = recsys.retrieve_topk(model, {k: _t(v) for k, v in rq.items()}, cfg, k=50)
    s_r, ids_r = jax.jit(lambda p, q: ref_recsys.retrieve_topk(p, q, rcfg, k=50))(rp, rq_j)
    np.testing.assert_array_equal(_np(ids), np.asarray(ids_r))
    _close(s, s_r, what="retrieve_topk scores")


def test_recsys_abstract_params_are_meta_and_match_the_reference():
    for arch in RECSYS:
        cfg, rcfg = get_arch(arch).config_for("train_batch"), ref_get_arch(arch).config_for(
            "train_batch")
        meta = recsys.abstract_params(cfg)
        shapes = {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}
        assert all(p.device.type == "meta" for p in meta.parameters())
        flat, _ = jax.tree_util.tree_flatten_with_path(ref_recsys.abstract_params(rcfg))
        ref_shapes = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                      (tuple(x.shape), torch_dtype(x.dtype)) for path, x in flat}
        assert shapes == ref_shapes, arch


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------


@pytest.mark.parametrize("combiner,weighted", list(itertools.product(("sum", "mean"),
                                                                     (False, True))))
def test_embedding_bag_equals_the_reference(combiner, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    seg = np.sort(rng.integers(0, 9, 40)).astype(np.int32)  # bags 0..9, some empty
    w = rng.random(40).astype(np.float32) if weighted else None
    got = embedding.embedding_bag(_t(table), _t(ids), _t(seg), 10,
                                  weights=None if w is None else _t(w), combiner=combiner)
    want = ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 10,
                                 weights=None if w is None else jnp.asarray(w), combiner=combiner)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not _np(got)[9].any()  # an empty bag
    with pytest.raises(ValueError):
        embedding.embedding_bag(_t(table), _t(ids), _t(seg), 10, combiner="max")


def test_lookup_fold_and_table_helpers():
    spec = embedding.TableSpec((7, 1024, 5), 4)
    ref_spec = ref_emb.TableSpec((7, 1024, 5), 4)
    assert spec.total_rows == ref_spec.total_rows and spec.nbytes(2) == ref_spec.nbytes(2)
    np.testing.assert_array_equal(spec.offsets, ref_spec.offsets)
    ids = np.random.default_rng(0).integers(0, 1 << 30, (6, 3)).astype(np.int32)
    folded = embedding.fold_ids(_t(ids), spec)
    assert folded.dtype == torch.int32
    np.testing.assert_array_equal(_np(folded), np.asarray(ref_emb.fold_ids(jnp.asarray(ids),
                                                                           ref_spec)))
    table = np.random.default_rng(1).normal(size=(spec.total_rows, 4)).astype(np.float32)
    np.testing.assert_array_equal(_np(embedding.embedding_lookup(_t(table), _t(ids), spec)),
                                  np.asarray(ref_emb.embedding_lookup(jnp.asarray(table),
                                                                      jnp.asarray(ids), ref_spec)))
    vecs = np.random.default_rng(2).normal(size=(3, 5, 4)).astype(np.float32)
    mask = np.random.default_rng(3).random((3, 5)) > 0.4
    mask[2] = False
    _close(embedding.masked_mean_bag(_t(vecs), _t(mask)),
           ref_emb.masked_mean_bag(jnp.asarray(vecs), jnp.asarray(mask)), rtol=1e-6, atol=1e-7)
    for kw in (dict(big=10_000_000, medium=1_000_000, small=100_000),
               dict(big=5000, medium=3000, small=100, seed=4)):
        assert embedding.criteo_like_rows(26, **kw) == ref_emb.criteo_like_rows(26, **kw)


# --------------------------------------------------------------------------
# batches and graphs
# --------------------------------------------------------------------------


def _equal_batches(got, want, dtypes):
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == dtypes[np.asarray(b[key]).dtype.name], key
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)


DTYPES = {"float32": torch.float32, "int32": torch.int32, "bool": torch.bool}


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_batches_equal_the_reference(arch):
    cfg, rcfg = get_arch(arch).smoke_config(), ref_get_arch(arch).smoke_config()
    got = list(itertools.islice(pipeline.recsys_batches(cfg, 12, seed=5, device="cpu"), 3))
    want = list(itertools.islice(ref_pipeline.recsys_batches(rcfg, 12, seed=5), 3))
    _equal_batches(got, want, DTYPES)


@pytest.mark.parametrize("readout", [0, 6])
def test_gnn_batches_equal_the_reference(readout):
    cfg, rcfg = get_arch("graphcast").smoke_config(), ref_get_arch("graphcast").smoke_config()
    got = list(itertools.islice(pipeline.gnn_batches(cfg, 50, 200, seed=3,
                                                     graph_readout_graphs=readout,
                                                     device="cpu"), 3))
    want = list(itertools.islice(ref_pipeline.gnn_batches(rcfg, 50, 200, seed=3,
                                                          graph_readout_graphs=readout), 3))
    _equal_batches(got, want, DTYPES)


def test_graph_functions_equal_the_reference():
    src, dst = graphs.random_power_law_graph(300, 2000, seed=2)
    r_src, r_dst = ref_graphs.random_power_law_graph(300, 2000, seed=2)
    for a, b in ((src, r_src), (dst, r_dst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    g, rg = graphs.edges_to_csr(src, dst, 300), ref_graphs.edges_to_csr(r_src, r_dst, 300)
    assert g.n_nodes == rg.n_nodes and g.n_edges == rg.n_edges
    np.testing.assert_array_equal(g.ptr, rg.ptr)
    np.testing.assert_array_equal(g.col, rg.col)
    budget = graphs.sampling_budget(16, (5, 3))
    assert budget == ref_graphs.sampling_budget(16, (5, 3))
    seeds = np.arange(16)
    sub = graphs.sample_neighbors(g, seeds, (5, 3), rng=np.random.default_rng(9),
                                  pad_nodes=budget[0], pad_edges=budget[1])
    rsub = ref_graphs.sample_neighbors(rg, seeds, (5, 3), rng=np.random.default_rng(9),
                                       pad_nodes=budget[0], pad_edges=budget[1])
    for f in dataclasses.fields(rsub):
        np.testing.assert_array_equal(getattr(sub, f.name), getattr(rsub, f.name), err_msg=f.name)
    with pytest.raises(ValueError, match="padding"):
        graphs.sample_neighbors(g, seeds, (5, 3), rng=np.random.default_rng(9), pad_nodes=20,
                                pad_edges=20)
    got = graphs.block_diagonal_batch(8, 5, 7, 3, seed=1)
    want = ref_graphs.block_diagonal_batch(8, 5, 7, 3, seed=1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
