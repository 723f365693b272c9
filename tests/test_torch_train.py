"""The port's training substrate (``train/losses.py``, ``train/optim.py``,
``train/trainer.py``, ``data/pipeline.py`` and the ``train_encoder`` CLI)
against the JAX reference's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Tolerances:

* losses, the LR schedule, global norms and clipped grads: rtol 1e-6 (f32
  arithmetic in the same order; reductions may sum in another order);
* ``adamw_update`` over 5 steps: params and both moments rtol 1e-5, atol
  1e-7 (``pow`` and ``sqrt`` of the bias correction may differ by an ulp);
* ``make_train_step`` on the quadratic loss: params rtol 1e-5, atol 1e-6;
  at ``grad_accum`` 2 against 1: rtol 1e-4, atol 1e-5 (the reference's own
  tolerance in ``tests/test_train_ckpt.py``);
* the pipeline: array-equal, same dtypes.
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as ref_train
from repro.data.pipeline import TripleSampler as RefSampler
from repro.data.pipeline import lm_token_batches as ref_lm_token_batches
from repro.data.synthetic import CorpusConfig as RefCorpusConfig
from repro.data.synthetic import generate_corpus as ref_generate_corpus
from repro_torch import train
from repro_torch.data.pipeline import TripleSampler, lm_token_batches
from repro_torch.data.synthetic import CorpusConfig, generate_corpus

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

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def test_all_five_losses():
    rng = np.random.default_rng(0)
    s = [rng.normal(size=16).astype(np.float32) for _ in range(4)]
    reps = np.abs(rng.normal(size=(8, 40))).astype(np.float32) * (rng.random((8, 40)) < 0.3)
    for name, args in (("pairwise_hinge", s[:2]), ("pairwise_softmax", s[:2]),
                       ("margin_mse", s), ("flops_regularizer", [reps]),
                       ("l1_regularizer", [reps])):
        got = getattr(train, name)(*map(_t, args))
        want = getattr(ref_train, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(_np(train.pairwise_hinge(_t(s[0]), _t(s[1]), margin=0.3)),
                               np.asarray(ref_train.pairwise_hinge(jnp.asarray(s[0]),
                                                                   jnp.asarray(s[1]), margin=0.3)),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine", "warmup_linear"])
def test_schedule_lr(schedule):
    kw = dict(lr=0.7, warmup_steps=10, total_steps=100, min_lr_frac=0.1, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 37, 50, 99, 100, 140):
        got = float(train.schedule_lr(train.AdamWConfig(**kw), torch.tensor(step)))
        want = float(ref_train.schedule_lr(ref_train.AdamWConfig(**kw), jnp.asarray(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), (schedule, step)


def test_lr_schedule_shapes():
    cfg = train.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(train.schedule_lr(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4] >= 0.1 * (1 - 1e-6)


def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32) * 3,
            "b": {"c": rng.normal(size=7).astype(np.float32),
                  "d": [rng.normal(size=2).astype(np.float32)]}}
    return jax.tree.map(_t, tree), jax.tree.map(jnp.asarray, tree)


def test_global_norm_and_clip():
    g, g_ref = _grad_trees(1)
    norm = float(train.global_norm(g))
    assert norm == pytest.approx(float(ref_train.global_norm(g_ref)), rel=1e-6)
    for max_norm in (1.0, 1e3):
        clipped, n = train.clip_by_global_norm(g, max_norm)
        clipped_ref, n_ref = ref_train.clip_by_global_norm(g_ref, max_norm)
        assert float(n) == pytest.approx(float(n_ref), rel=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6),
                     clipped, clipped_ref)
    big = {"a": torch.full((100,), 10.0)}
    clipped, norm = train.clip_by_global_norm(big, 1.0)
    assert float(norm) == pytest.approx(100.0)
    assert float(train.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_adamw_matches_reference_step():
    """One AdamW step against a hand-computed reference."""
    cfg = train.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                            grad_clip_norm=0.0, schedule="constant", warmup_steps=0)
    p = {"w": torch.tensor([2.0])}
    new_p, _, _ = train.adamw_update({"w": torch.tensor([0.5])}, train.adamw_init(p), p, cfg)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    step = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(float(new_p["w"][0]), 2.0 - 0.1 * step, rtol=1e-5)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_over_several_steps(clip):
    """Five updates with fresh gradients each step, weight decay on, the
    warm-up cosine schedule: params, both moments, count and metrics."""
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip_norm=clip, warmup_steps=2, total_steps=10)
    cfg, cfg_ref = train.AdamWConfig(**kw), ref_train.AdamWConfig(**kw)
    p, p_ref = _grad_trees(2)
    st, st_ref = train.adamw_init(p), ref_train.adamw_init(p_ref)
    for i in range(5):
        g, g_ref = _grad_trees(10 + i)
        p, st, met = train.adamw_update(g, st, p, cfg)
        p_ref, st_ref, met_ref = ref_train.adamw_update(g_ref, st_ref, p_ref, cfg_ref)
        for got, want in ((p, p_ref), (st.m, st_ref.m), (st.v, st_ref.v)):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                _np(a), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=f"step {i}"), got, want)
        assert int(st.count) == int(st_ref.count) == i + 1
        assert st.m["a"].dtype == torch.float32
        for key in ("lr", "grad_norm"):
            assert float(met[key]) == pytest.approx(float(met_ref[key]), rel=1e-6)


def test_adamw_on_a_module_updates_its_parameters_in_place():
    mod = torch.nn.Linear(4, 3)
    before = {n: p.detach().clone() for n, p in mod.named_parameters()}
    st = train.adamw_init(mod)
    assert set(st.m) == set(before) and st.m["weight"].dtype == torch.float32
    grads = {n: torch.ones_like(p) for n, p in mod.named_parameters()}
    tree = {n: p.clone() for n, p in before.items()}
    new, st2, _ = train.adamw_update(grads, st, mod, train.AdamWConfig(lr=0.1, warmup_steps=1))
    want, _, _ = train.adamw_update(grads, train.adamw_init(tree), tree,
                                    train.AdamWConfig(lr=0.1, warmup_steps=1))
    assert new is mod
    for n, p in mod.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=0)
        assert not torch.equal(p.detach(), before[n])


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------


def _quadratic_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _ref_quadratic_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(4, 3)).astype(np.float32)
    for _ in range(n):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        yield {"x": x, "y": x @ w_true}


def _torch_batches(n, seed=0):
    return [{k: _t(v) for k, v in b.items()} for b in _batches(n, seed)]


def test_train_loss_decreases():
    params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
    step = train.make_train_step(_quadratic_loss,
                                 train.AdamWConfig(lr=0.05, warmup_steps=1, weight_decay=0.0))
    _, hist = train.train_loop(step, train.init_train_state(params), _torch_batches(60))
    assert hist[-1]["loss"] < 0.1 * hist[0]["loss"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_make_train_step_against_the_reference(grad_accum):
    """Three steps at ``grad_accum`` 1 and 2, from the same params on the
    same batches: params, moments, step and every metric."""
    init = {"w": np.ones((4, 3), np.float32) * 0.5, "b": np.zeros(3, np.float32)}
    kw = dict(lr=1e-2, warmup_steps=1)
    step = train.make_train_step(_quadratic_loss, train.AdamWConfig(**kw), grad_accum=grad_accum)
    step_ref = jax.jit(ref_train.make_train_step(_ref_quadratic_loss, ref_train.AdamWConfig(**kw),
                                                 grad_accum=grad_accum))
    st = train.init_train_state(jax.tree.map(_t, init))
    st_ref = ref_train.init_train_state(jax.tree.map(jnp.asarray, init))
    for b in _batches(3, seed=4):
        st, met = step(st, {k: _t(v) for k, v in b.items()})
        st_ref, met_ref = step_ref(st_ref, {k: jnp.asarray(v) for k, v in b.items()})
        for key in met_ref:
            assert float(met[key]) == pytest.approx(float(met_ref[key]), rel=1e-5), key
    jax.tree.map(lambda a, b: np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                                         atol=1e-6),
                 (st.params, st.opt.m, st.opt.v), (st_ref.params, st_ref.opt.m, st_ref.opt.v))
    assert int(st.step) == int(st_ref.step) == 3


def test_grad_accum_equivalence():
    """accum=4 over one batch == accum=1 over the same batch (mean loss)."""
    params = {"w": torch.ones((4, 3)), "b": torch.zeros((3,))}
    batch = _torch_batches(1)[0]
    s1 = train.make_train_step(_quadratic_loss, train.AdamWConfig(lr=1e-2, warmup_steps=1))
    s4 = train.make_train_step(_quadratic_loss, train.AdamWConfig(lr=1e-2, warmup_steps=1),
                               grad_accum=4)
    st1, _ = s1(train.init_train_state(params), batch)
    st4, _ = s4(train.init_train_state(params), batch)
    for key in ("w", "b"):
        torch.testing.assert_close(st1.params[key], st4.params[key], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="micro-batches"):
        train.make_train_step(_quadratic_loss, train.AdamWConfig(), grad_accum=3)(
            train.init_train_state(params), batch)


def test_grad_transform_hook():
    """The hook sees the (accumulated) grads before the update, as in the
    reference: halving them changes the clipped-norm metric by half and
    the update exactly as the reference's with the same hook."""
    init = {"w": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    seen = []

    def half(grads):
        seen.append(sorted(grads))
        return {k: v * 0.5 for k, v in grads.items()}

    kw = dict(lr=0.05, warmup_steps=1, weight_decay=0.0, grad_clip_norm=0.0)
    step = train.make_train_step(_quadratic_loss, train.AdamWConfig(**kw), grad_accum=2,
                                 grad_transform=half)
    step_ref = ref_train.make_train_step(
        _ref_quadratic_loss, ref_train.AdamWConfig(**kw), grad_accum=2,
        grad_transform=lambda g: jax.tree.map(lambda x: x * 0.5, g))
    st, hist = train.train_loop(step, train.init_train_state(jax.tree.map(_t, init)),
                                _torch_batches(4, seed=7))
    st_ref, hist_ref = ref_train.train_loop(
        step_ref, ref_train.init_train_state(jax.tree.map(jnp.asarray, init)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches(4, seed=7)])
    assert seen == [["b", "w"]] * 4
    for a, b in zip(hist, hist_ref):
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    for key in ("w", "b"):
        np.testing.assert_allclose(_np(st.params[key]), np.asarray(st_ref.params[key]),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------


def test_lm_token_batches_equal_the_reference():
    got = list(itertools.islice(lm_token_batches(300, 4, 9, seed=3, device="cpu"), 3))
    want = list(itertools.islice(ref_lm_token_batches(300, 4, 9, seed=3), 3))
    for a, b in zip(got, want):
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_triple_sampler_equals_the_reference():
    kw = dict(n_docs=150, n_queries=30, n_concepts=20, seed=4)
    corpus = generate_corpus(CorpusConfig(**kw))
    ref_corpus = ref_generate_corpus(RefCorpusConfig(**kw))
    sampler = TripleSampler(corpus, q_len=6, d_len=20, seed=9, device="cpu")
    ref_sampler = RefSampler(ref_corpus, q_len=6, d_len=20, seed=9)
    for a, b in zip(itertools.islice(sampler.batches(7), 4),
                    itertools.islice(ref_sampler.batches(7), 4)):
        assert set(a) == set(b)
        for key in a:
            assert a[key].dtype == (torch.bool if key.endswith("mask") else torch.int32)
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]), err_msg=key)
    docs = list(sampler.doc_token_batches(64))
    ref_docs = list(ref_sampler.doc_token_batches(64))
    assert [n for *_, n in docs] == [n for *_, n in ref_docs] == [64, 64, 22]
    for (t, m, _), (rt, rm, _) in zip(docs, ref_docs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


def test_pipeline_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    corpus = generate_corpus(CorpusConfig(n_docs=50, n_queries=5, n_concepts=20, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(TripleSampler(corpus).batches(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(lm_token_batches(10, 2, 3))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _train_encoder(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train_encoder", *extra],
                          capture_output=True, text=True, env=env, timeout=300)


def test_train_encoder_cli_on_the_cpu(tmp_path):
    """The example's loop at a tiny size: trains, encodes, indexes and
    serves; its checkpoint hook (every 100 steps) writes nothing in 3."""
    out = _train_encoder("--device", "cpu", "--steps", "3", "--batch", "2", "--docs", "120",
                         "--queries", "12", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("encoder params: 1,")
    assert lines[1].startswith("training: rank_loss ")
    rr = [line for line in lines if line.startswith("RR@10: trained sparse encoder = ")]
    assert len(rr) == 1 and "| bm25 = " in rr[0]
    assert any(line.startswith("index postings: learned = ") for line in lines)
    assert os.listdir(tmp_path) == []


def test_train_encoder_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = _train_encoder("--steps", "1")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and out.stdout == ""


# --------------------------------------------------------------------------
# the arch CLI (launch/train.py)
# --------------------------------------------------------------------------


def _train(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *extra],
                          capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "graphcast", "dcn-v2"])
def test_train_cli_runs_and_resumes_on_the_cpu(arch, tmp_path):
    """Three steps of an arch of each family (an MoE LM, the GNN, a recsys
    model) with a checkpoint at the end, then two more resumed from it: the
    reference's log, the step count carried across, ``keep=2``."""
    out = _train("--device", "cpu", "--arch", arch, "--steps", "3", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert [line.split(":")[0] for line in lines[:3]] == ["step 0", "step 1", "step 2"]
    metrics = [json.loads(line.split(": ", 1)[1]) for line in lines[:3]]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics)
    assert lines[3].startswith("done: 3 steps in ")
    assert sorted(os.listdir(tmp_path)) == ["step_000000003"]
    out = _train("--device", "cpu", "--arch", arch, "--steps", "2", "--ckpt-dir", str(tmp_path),
                 "--resume")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0].startswith("resumed from step 3 ({'final': True})")
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000005"]
    manifest = json.loads((tmp_path / "step_000000005" / "manifest.json").read_text())
    assert manifest["step"] == 5 and manifest["meta"] == {"final": True}


def test_train_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    out = _train("--arch", "dcn-v2", "--steps", "1")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and out.stdout == ""
