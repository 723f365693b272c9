"""The port's ``CheckpointManager`` (``checkpoint/manager.py``): the cases of
``tests/test_train_ckpt.py`` on the port, the on-disk layout against the
reference's, and encoder train states carried between the two packages.

A checkpoint restores bit for bit (array-equal, same dtypes). The
continued training runs compare losses within rtol 1e-5 and params within
rtol 1e-5, atol 1e-6 (the two packages' f32 matrix products sum in other
orders).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as ref_train
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data.synthetic import CorpusConfig as RefCorpusConfig
from repro.data.synthetic import generate_corpus as ref_generate_corpus
from repro.data.pipeline import TripleSampler as RefSampler
from repro.models import sparse_encoder as ref_enc
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TripleSampler
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.models import sparse_encoder as enc
from repro_torch.train import (
    AdamWConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
    train_loop,
)

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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _abstract(state):
    """A state of ``meta`` tensors shaped like ``state`` (any pytree)."""
    from repro_torch.train.tree import tree_map

    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), state)


def _assert_trees_equal(got, want):
    from repro_torch.train.tree import flatten_with_paths

    a, _ = flatten_with_paths(got)
    b, _ = flatten_with_paths(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape), k
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=k)


def _same_array(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the cases of tests/test_train_ckpt.py
# --------------------------------------------------------------------------


def _quadratic_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(4, 3)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        out.append({"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)})
    return out


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    params = {"w": torch.arange(12.0).reshape(3, 4), "nested": {"b": torch.ones((2,))}}
    state = init_train_state(params)
    for s in (1, 2, 3):
        cm.save(s, state)
    assert cm.available_steps() == [2, 3]  # keep=2 GC'd step 1
    restored, _ = cm.restore(_abstract(state), device="cpu")
    _assert_trees_equal(restored, state)


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_writes=False)
    cm.save(1, init_train_state({"w": torch.ones((2, 2))}))
    bad = init_train_state({"w": torch.ones((2, 2)), "extra": torch.ones((1,))})
    with pytest.raises(ValueError, match="mismatch"):
        cm.restore(_abstract(bad), device="cpu")


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_writes=False)
    cm.save(1, init_train_state({"w": torch.ones((2, 2))}))
    bad = init_train_state({"w": torch.ones((3, 2))})
    with pytest.raises(ValueError, match="shape"):
        cm.restore(_abstract(bad), device="cpu")


def test_checkpoint_atomicity_tmp_dirs_invisible(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_writes=False)
    # a crashed writer leaves a tmp dir: it is not listed as a checkpoint
    os.makedirs(tmp_path / "step_000000007.tmp-dead")
    cm.save(9, init_train_state({"w": torch.ones((2,))}))
    assert cm.available_steps() == [9]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"), async_writes=False).restore({}, device="cpu")


def test_checkpoint_async_writer(tmp_path):
    """``save`` snapshots now: an in-place change after it is not written."""
    cm = CheckpointManager(str(tmp_path), async_writes=True)
    w = torch.ones((64, 64))
    state = init_train_state({"w": w})
    cm.save(5, state)
    w.add_(1.0)
    cm.wait()
    assert cm.latest_step() == 5
    restored, _ = cm.restore(_abstract(state), device="cpu")
    assert bool((restored.params["w"] == 1.0).all())


def test_checkpoint_resume_training(tmp_path):
    """Save mid-run, restore, continue: matches an uninterrupted run."""
    params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
    step = make_train_step(_quadratic_loss, AdamWConfig(lr=0.05, warmup_steps=1))
    batches = _batches(10)
    state_a, _ = train_loop(step, init_train_state(params), batches)
    state_b, _ = train_loop(step, init_train_state(params), batches[:5])
    cm = CheckpointManager(str(tmp_path), async_writes=False)
    cm.save(5, state_b, {"note": "mid-run"})
    restored, meta = cm.restore(_abstract(state_b), device="cpu")
    assert meta == {"note": "mid-run"} and int(restored.step) == 5
    state_c, _ = train_loop(step, restored, batches[5:])
    for key in ("w", "b"):
        np.testing.assert_allclose(_np(state_a.params[key]), _np(state_c.params[key]),
                                   rtol=1e-5, atol=1e-6)


def test_every_n_steps_hook(tmp_path):
    """The trainer's hook saves after every n-th step, with its metrics in
    the manifest's meta, and ``keep`` collects the older ones."""
    params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
    step = make_train_step(_quadratic_loss, AdamWConfig(lr=0.05, warmup_steps=1))
    cm = CheckpointManager(str(tmp_path), keep=2)
    state, hist = train_loop(step, init_train_state(params), _batches(7),
                             hooks=[cm.every_n_steps_hook(2, {"run": "q"})])
    cm.wait()
    assert cm.available_steps() == [4, 6]
    restored, meta = cm.restore(_abstract(state), device="cpu")
    assert int(restored.step) == 6 and meta == {"run": "q", "metrics": hist[5]}


def test_restore_raises_without_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cm = CheckpointManager(str(tmp_path), async_writes=False)
    state = init_train_state({"w": torch.ones((2,))})
    cm.save(1, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.restore(_abstract(state))


def test_manifest_and_shards_match_the_reference(tmp_path):
    """The same state written by both packages: equal manifests (paths in
    JAX's order, shards, leaf names, shapes, dtypes) and equal arrays,
    packed over several shards."""
    rng = np.random.default_rng(0)
    tree = {"z": rng.normal(size=(300, 300)).astype(np.float32),
            "a": [rng.normal(size=(200, 400)).astype(np.float32), np.arange(5, dtype=np.int32)],
            "m": {"k": rng.normal(size=(500, 600)).astype(np.float32)}}
    ours = CheckpointManager(str(tmp_path / "port"), shard_mb=1, async_writes=False)
    ref = RefCheckpointManager(str(tmp_path / "ref"), shard_mb=1, async_writes=False)
    ours.save(3, init_train_state({k: jax.tree.map(torch.from_numpy, v) for k, v in tree.items()}))
    ref.save(3, ref_train.init_train_state(jax.tree.map(jnp.asarray, tree)))
    m_port = json.loads((tmp_path / "port" / "step_000000003" / "manifest.json").read_text())
    m_ref = json.loads((tmp_path / "ref" / "step_000000003" / "manifest.json").read_text())
    assert m_port == m_ref
    assert max(leaf["shard"] for leaf in m_ref["leaves"]) >= 2
    for si in range(max(leaf["shard"] for leaf in m_ref["leaves"]) + 1):
        with np.load(tmp_path / "port" / "step_000000003" / f"shard_{si:03d}.npz") as a, \
                np.load(tmp_path / "ref" / "step_000000003" / f"shard_{si:03d}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for name in a.files:
                np.testing.assert_array_equal(a[name], b[name])


# --------------------------------------------------------------------------
# encoder train states across the two packages
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_run():
    """The reference trains a small SPLADE encoder (2 layers: a stacked
    block of 2) for 2 steps; the fixture keeps its state, config, and the
    batch of step 3."""
    kw = dict(n_docs=120, n_queries=30, n_concepts=20, seed=3)
    corpus = generate_corpus(CorpusConfig(**kw))
    ref_corpus = ref_generate_corpus(RefCorpusConfig(**kw))
    vocab = corpus.config.n_surface_terms
    rcfg = ref_enc.SparseEncoderConfig(ref_enc.encoder_backbone(32, 2, vocab))
    pcfg = enc.SparseEncoderConfig(enc.encoder_backbone(32, 2, vocab))
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    ref_batches = [b for _, b in zip(range(3), RefSampler(ref_corpus, 8, 24).batches(8))]
    batches = [b for _, b in zip(range(3), TripleSampler(corpus, 8, 24, device="cpu").batches(8))]
    ref_step = jax.jit(ref_train.make_train_step(lambda p, b: ref_enc.encoder_loss(p, b, rcfg),
                                                 ref_train.AdamWConfig(**opt)))
    state = ref_train.init_train_state(
        jax.jit(ref_enc.init_encoder_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg))
    for b in ref_batches[:2]:
        state, _ = ref_step(state, b)
    step = make_train_step(lambda p, b: enc.encoder_loss(p, b, pcfg), AdamWConfig(**opt))
    return dict(rcfg=rcfg, pcfg=pcfg, ref_state=state, ref_step=ref_step, step=step,
                ref_batch=ref_batches[2], batch=batches[2])


def _abstract_encoder_state(cfg):
    return abstract_train_state(enc.init_encoder_params(None, cfg, device="meta"))


def test_reference_checkpoint_of_an_encoder_restores_in_the_port(tmp_path, encoder_run):
    """Params, both moments, count and step restore bit for bit into the
    port's ``TrainState`` (a ``SparseEncoder`` module), and the next step's
    loss equals the reference's."""
    r = encoder_run
    RefCheckpointManager(str(tmp_path), async_writes=False).save(2, r["ref_state"], {"by": "ref"})
    state, meta = CheckpointManager(str(tmp_path), async_writes=False).restore(
        _abstract_encoder_state(r["pcfg"]), device="cpu")
    assert meta == {"by": "ref"}
    assert isinstance(state.params, enc.SparseEncoder)
    assert int(state.step) == int(state.opt.count) == 2
    assert state.step.shape == state.opt.count.shape == ()
    assert state.step.dtype == state.opt.count.dtype == torch.int32
    got = state.to_tree()
    for part, want in (("params", r["ref_state"].params), ("m", r["ref_state"].opt.m),
                       ("v", r["ref_state"].opt.v)):
        have = got.params if part == "params" else getattr(got.opt, part)
        jax.tree.map(_same_array, have, want)
    _, met = r["step"](state, r["batch"])
    _, met_ref = r["ref_step"](r["ref_state"], r["ref_batch"])
    for key in ("loss", "rank_loss", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(float(met_ref[key]), rel=1e-5), key
    assert int(met["doc_nnz"]) == int(met_ref["doc_nnz"])


def test_port_checkpoint_of_an_encoder_restores_in_both(tmp_path, encoder_run):
    """A port state written by the port restores bit for bit in the port
    (module and moments) and in the reference (its stacked pytree)."""
    r = encoder_run
    RefCheckpointManager(str(tmp_path / "a"), async_writes=False).save(2, r["ref_state"])
    state, _ = CheckpointManager(str(tmp_path / "a"), async_writes=False).restore(
        _abstract_encoder_state(r["pcfg"]), device="cpu")
    state, _ = r["step"](state, r["batch"])  # the port's own step 3
    cm = CheckpointManager(str(tmp_path / "b"), async_writes=True)
    cm.save(3, state)
    cm.wait()
    again, _ = cm.restore(_abstract_encoder_state(r["pcfg"]), device="cpu")
    _assert_trees_equal(again.to_tree(), state.to_tree())
    for (n, a), (m, b) in zip(again.params.named_parameters(), state.params.named_parameters()):
        assert n == m and torch.equal(a, b)
    abstract_ref = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), r["ref_state"])
    ref_restored, _ = RefCheckpointManager(str(tmp_path / "b"), async_writes=False).restore(
        abstract_ref)
    assert int(ref_restored.step) == 3
    jax.tree.map(_same_array, state.to_tree().params, ref_restored.params)


# --------------------------------------------------------------------------
# bf16 train states across the two packages
# --------------------------------------------------------------------------


def _bf16_lm_state():
    """A granite-style (MoE) LM at smoke size in bf16, after one step: bf16
    params, f32 moments, and the port's config."""
    import dataclasses

    from repro_torch.archs import transformer
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_token_batches

    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke_config(),
                              dtype=torch.bfloat16)
    model = transformer.init_lm_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    step = make_train_step(lambda m, b: transformer.lm_loss(m, b["tokens"], b["labels"], cfg),
                           AdamWConfig(lr=1e-2, warmup_steps=1))
    state, _ = step(init_train_state(model), next(lm_token_batches(cfg.vocab, 2, 16, seed=1,
                                                                   device="cpu")))
    return cfg, state


def _to_jax(x):
    """A port tensor as the reference's array, bf16 bit for bit (ml_dtypes
    is the reference's dependency, not the port's)."""
    import ml_dtypes

    x = x.detach()
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(x.numpy())


def _bits(x):
    """A leaf's bits as an unsigned array: 2-byte leaves (bf16, |V2) as uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().view(torch.int16) if x.dtype == torch.bfloat16 else x
    a = _np(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_bf16_train_state_crosses_between_the_packages(tmp_path):
    """A bf16 ``TrainState`` written by the port restores in the reference
    bit for bit, and one written by the reference restores in the port; both
    write the same manifest (dtype ``"bfloat16"``) and npz records (``|V2``).
    The reference's own ``restore`` has no cast from ``|V2`` to its
    bfloat16, so its abstract state names those leaves ``|V2`` and the test
    views the records as bfloat16."""
    cfg, state = _bf16_lm_state()
    tree = state.to_tree()
    bf16 = [k for k, x in _flatten(tree) if x.dtype == torch.bfloat16]
    assert bf16 and all("params" in k for k in bf16)
    CheckpointManager(str(tmp_path / "port"), async_writes=False).save(1, state, {"by": "port"})
    ref_state = ref_train.TrainState(
        params=jax.tree.map(_to_jax, tree.params),
        opt=ref_train.AdamWState(*(jax.tree.map(_to_jax, t) for t in tree.opt)),
        step=_to_jax(tree.step))
    RefCheckpointManager(str(tmp_path / "ref"), async_writes=False).save(1, ref_state,
                                                                         {"by": "port"})
    d_port, d_ref = tmp_path / "port" / "step_000000001", tmp_path / "ref" / "step_000000001"
    m_port = json.loads((d_port / "manifest.json").read_text())
    assert m_port == json.loads((d_ref / "manifest.json").read_text())
    assert {leaf["path"] for leaf in m_port["leaves"] if leaf["dtype"] == "bfloat16"} == set(bf16)
    with np.load(d_port / "shard_000.npz") as a, np.load(d_ref / "shard_000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(_bits(a[name]), _bits(b[name]))

    # the reference restores the port's checkpoint
    abstract_ref = jax.tree.map(
        lambda x: np.empty(x.shape, "V2") if x.dtype == jnp.bfloat16
        else jax.ShapeDtypeStruct(x.shape, x.dtype), ref_state)
    restored_ref, meta = RefCheckpointManager(str(tmp_path / "port"),
                                              async_writes=False).restore(abstract_ref)
    assert meta == {"by": "port"}
    for (k, want), got in zip(_flatten(tree), jax.tree.leaves(restored_ref)):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)

    # the port restores the reference's checkpoint
    from repro_torch.archs import transformer

    abstract = abstract_train_state(transformer.abstract_lm_params(cfg))
    restored, meta = CheckpointManager(str(tmp_path / "ref"), async_writes=False).restore(
        abstract, device="cpu")
    assert meta == {"by": "port"} and isinstance(restored.params, transformer.Transformer)
    _assert_trees_equal(restored.to_tree(), tree)
    for (n, a), (_, b) in zip(restored.params.named_parameters(),
                              state.params.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n  # the MoE router is f32


def _flatten(tree):
    from repro_torch.train.tree import flatten_with_paths

    return flatten_with_paths(tree)[0]
