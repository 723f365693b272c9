"""The port's LM family (``archs/layers.py`` MoE, ``archs/transformer.py``
with MoE layers, the KV cache, prefill and decode) against the JAX
reference's, on the CPU.

Params in the reference's layout are drawn with numpy from a seed and
carried into the port by ``lm_params_from_reference``; batches come from
the reference's ``lm_token_batches``. The reference's functions run under
``jax.jit``. Both compute in f32 on the host, their products summing in
other orders, so:

* the loss of each of the five LM smoke configs within rtol 1e-5, its
  gradients within rtol 1e-4 and an atol of 1e-5 times the leaf's largest
  gradient, and the params after one trainer step within rtol 1e-5 (atol
  1e-7) of the reference's AdamW update applied to the port's gradients
  (AdamW's first step moves a weight by lr times ``g / (|g| + eps)``, which
  turns a gradient's last bits into a weight's leading ones where ``|g|``
  is near eps, so the step is held on the same gradients, and the
  gradients are held to the reference's);
* ``moe`` at G = 1, 2 and 8, at capacity factor 8 and at 1.0 (tokens
  drop), with and without a shared expert: the chosen experts, ``keep``
  and ``slot`` equal; output and aux loss within rtol 1e-5 (atol 1e-6);
* prefill and decode on a config whose windows bite (``n_layers=8``,
  ``window_pattern=(4, 4, 0)``: the ring wraps, two tail layers) and on the
  MoE smoke config: logits within rtol 1e-5 (atol 1e-5), the cache's
  ``k``/``v`` within rtol 1e-5 (atol 1e-5) and ``pos`` equal, after the
  prefill and after each decode step.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as ref_train
from repro.archs import layers as ref_layers
from repro.archs import transformer as ref_tf
from repro.configs import get_arch as ref_get_arch
from repro.data.pipeline import lm_token_batches as ref_lm_token_batches
from repro_torch import train
from repro_torch.archs import layers, transformer
from repro_torch.configs import get_arch

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


LM_ARCHS = ("minitron-4b", "yi-34b", "gemma3-1b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def ref_lm_params(cfg, seed):
    """Params in the reference's pytree layout for ``cfg``, its structure from
    ``jax.eval_shape`` and its values drawn with numpy: matrices at the
    init's scale (over the second-to-last axis), embeddings at 0.02, norm
    scales about 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape)
        if "scale" in name:
            x = 1.0 + 0.1 * x
        elif "embed" in name:
            x = 0.02 * x
        else:
            x = x / np.sqrt(leaf.shape[-2])
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, ref_tf.abstract_lm_params(cfg))


def port_model(cfg, ref_params):
    model = transformer.Transformer(cfg, device="cpu")
    model.load_state_dict(transformer.lm_params_from_reference(jax.device_get(ref_params)))
    return model


def _smoke(arch):
    return get_arch(arch).smoke_config(), ref_get_arch(arch).smoke_config()


def _ref_tree_of(model, named):
    """name -> tensor or array, in the reference's layout, as numpy."""
    named = {n: torch.as_tensor(v) for n, v in named.items()}
    return jax.tree.map(_np, transformer.lm_params_to_reference(named, model.cfg))


def _close_trees(got, want, rtol, atol_frac=0.0, atol=0.0, what=""):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for (path, w), g in zip(flat, jax.tree.leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=max(atol, atol_frac * np.abs(w).max()),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# --------------------------------------------------------------------------
# the five LM smoke configs: loss, gradients, one trainer step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_loss_gradients_and_step(arch):
    cfg, rcfg = _smoke(arch)
    rp = ref_lm_params(rcfg, seed=LM_ARCHS.index(arch))
    model = port_model(cfg, rp)
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params() == rcfg.n_params()
    meta = transformer.abstract_lm_params(cfg)
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in model.named_parameters()]
    assert _ref_tree_of(model, dict(model.named_parameters())).keys() == rp.keys()
    b = next(ref_lm_token_batches(cfg.vocab, 2, 32, seed=3))
    batch = {k: _t(v) for k, v in b.items()}

    def ref_loss(p, bt):
        return ref_tf.lm_loss(p, bt["tokens"], bt["labels"], rcfg)

    (loss_r, met_r), grads_r = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(rp, b)
    loss, met = transformer.lm_loss(model, batch["tokens"], batch["labels"], cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-5)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(float(met[key].detach()), float(met_r[key]), rtol=1e-5,
                                   atol=1e-7)
    if cfg.moe is not None:
        assert float(met["aux"].detach()) > 0
    _close_trees(_ref_tree_of(model, dict(zip(names, map(_np, grads)))), grads_r, GRAD_RTOL,
                 GRAD_ATOL_FRAC, what=f"{arch} gradient")

    opt = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    step = train.make_train_step(lambda m, bt: transformer.lm_loss(m, bt["tokens"], bt["labels"],
                                                                   cfg),
                                 train.AdamWConfig(**opt))
    port_grads = jax.tree.map(jnp.asarray, _ref_tree_of(model, dict(zip(names, grads))))
    state, met_s = step(train.init_train_state(model), batch)
    new_r, _, met_ru = jax.jit(ref_train.adamw_update, static_argnums=3)(
        port_grads, ref_train.adamw_init(rp), rp, ref_train.AdamWConfig(**opt))
    assert float(met_s["loss"]) == pytest.approx(float(loss_r), rel=1e-5)
    assert float(met_s["grad_norm"]) == pytest.approx(float(met_ru["grad_norm"]), rel=1e-5)
    got = state.to_tree()
    assert int(got.step) == 1
    _close_trees(jax.tree.map(_np, got.params), new_r, 1e-5, atol=1e-7,
                 what=f"{arch} params after a step")


# --------------------------------------------------------------------------
# MoE dispatch
# --------------------------------------------------------------------------

MOE_CASES = [(g, cf, 0) for g, cf in itertools.product((1, 2, 8), (8.0, 1.0))] + [(2, 1.0, 1)]


@pytest.mark.parametrize("groups,cf,shared", MOE_CASES)
def test_moe_dispatch_and_output(groups, cf, shared):
    rng = np.random.default_rng(groups)
    B, S, D = 8, 32, 32  # at capacity factor 1.0 some experts overflow at every G
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(n_experts=4, top_k=2, d_expert_ff=16, capacity_factor=cf, n_groups=groups,
              n_shared=shared)
    cfg, rcfg = layers.MoEConfig(**kw), ref_layers.MoEConfig(**kw)
    rp = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape) / np.sqrt(s.shape[-2]),
                                            jnp.float32),
                      jax.eval_shape(lambda: ref_layers.moe_params(jax.random.PRNGKey(0), D, rcfg)))
    p = jax.tree.map(_t, jax.device_get(rp))
    T, G = B * S, groups
    Tg = T // G
    C = layers._capacity(Tg, cfg)
    assert C == ref_layers._round_up(max(int(Tg * 2 / 4 * cf), 1), 8)  # the reference's moe

    @jax.jit
    def ref_route(xr, router):
        logits = xr.reshape(T, D) @ router
        return jax.vmap(lambda a, b: ref_layers._dispatch_one_group(a, b, rcfg, C, jnp.float32))(
            xr.reshape(G, Tg, D), logits.reshape(G, Tg, 4))

    buf_r, route_r = ref_route(jnp.asarray(x), rp["router"])
    xt, logits = _t(x).reshape(T, D), _t(x).reshape(T, D) @ p["router"]
    for g in range(G):
        buf, (gate, keep, slot, tok, flat_e) = layers._dispatch_one_group(
            xt.reshape(G, Tg, D)[g], logits.reshape(G, Tg, 4)[g], cfg, C, torch.float32)
        np.testing.assert_array_equal(_np(flat_e), np.asarray(route_r[4][g]))
        np.testing.assert_array_equal(_np(keep), np.asarray(route_r[1][g]))
        np.testing.assert_array_equal(_np(slot), np.asarray(route_r[2][g]))
        np.testing.assert_array_equal(_np(tok), np.asarray(route_r[3][g]))
        np.testing.assert_allclose(_np(gate), np.asarray(route_r[0][g]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(_np(buf), np.asarray(buf_r[g]), rtol=1e-5, atol=1e-6)
    if cf == 1.0:
        assert not bool(np.asarray(route_r[1]).all())  # some tokens drop
    else:
        assert bool(np.asarray(route_r[1]).all())
    y, aux = layers.moe(p, _t(x), cfg)
    y_r, aux_r = jax.jit(lambda pp, xx: ref_layers.moe(pp, xx, rcfg))(rp, jnp.asarray(x))
    np.testing.assert_allclose(_np(y), np.asarray(y_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    mod = layers.MoE(None, D, cfg, device="cpu")
    mod.load_state_dict({n: _t(v) for n, v in
                         transformer.dotted_names(jax.device_get(rp)).items()})
    torch.testing.assert_close(mod(_t(x))[0], y, rtol=0, atol=0)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------


def _window4(cfg):
    """gemma3's smoke config with 8 layers and windows of 4: with a prompt
    of 11 tokens the rings wrap, the sliding mask bites, and layers 6 and 7
    are tail layers."""
    return dataclasses.replace(cfg, n_layers=8, window_pattern=(4, 4, 0))


DECODE_CASES = {"gemma3-w4": ("gemma3-1b", _window4), "granite-moe": ("granite-moe-3b-a800m", None)}


def _cache_close(cache, cache_r, what):
    for part in ("blocks", "tail"):
        for j, (e, er) in enumerate(zip(cache[part], cache_r[part])):
            for key in ("k", "v"):
                np.testing.assert_allclose(_np(e[key]), np.asarray(er[key]), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{what} {part}[{j}] {key}")
            np.testing.assert_array_equal(_np(e["pos"]), np.asarray(er["pos"]),
                                          err_msg=f"{what} {part}[{j}] pos")


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_equal_the_reference(case):
    arch, change = DECODE_CASES[case]
    cfg, rcfg = _smoke(arch)
    if change is not None:
        cfg, rcfg = change(cfg), change(rcfg)
    rp = ref_lm_params(rcfg, seed=7)
    model = port_model(cfg, rp)
    B, prompt, total, cache_len = 2, 11, 15, 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, total)).astype(np.int32)
    logits, cache = transformer.lm_prefill(model, _t(toks[:, :prompt]), cfg, cache_len)
    logits_r, cache_r = jax.jit(ref_tf.lm_prefill, static_argnums=(2, 3))(
        rp, jnp.asarray(toks[:, :prompt]), rcfg, cache_len)
    np.testing.assert_allclose(_np(logits), np.asarray(logits_r), rtol=1e-5, atol=1e-5)
    _cache_close(cache, cache_r, f"{case} prefill")
    spec = transformer.CacheSpec(cfg, B, cache_len)
    assert [x.shape for x in jax.tree.leaves(cache)] == \
        [tuple(x.shape) for x in jax.tree.leaves(cache_r)]
    abstract = transformer.abstract_cache(spec)
    assert all(x.device.type == "meta" for e in abstract["blocks"] + abstract["tail"]
               for x in e.values())
    ref_step = jax.jit(ref_tf.lm_decode_step, static_argnums=4)
    full = transformer.lm_logits(model, _t(toks), cfg)
    for i in range(prompt, total):
        pos = np.full(B, i, np.int32)
        logits, cache = transformer.lm_decode_step(model, cache, _t(toks[:, i:i + 1]), _t(pos),
                                                   cfg)
        logits_r, cache_r = ref_step(rp, cache_r, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(pos), rcfg)
        np.testing.assert_allclose(_np(logits), np.asarray(logits_r), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{case} decode at {i}")
        _cache_close(cache, cache_r, f"{case} decode at {i}")
        if cfg.moe is None:  # decode continues the full forward (MoE capacity differs)
            np.testing.assert_allclose(_np(logits), _np(full[:, i]), rtol=1e-4, atol=1e-5)
    if change is not None:
        ring = cache["blocks"][0]["pos"]
        assert ring.shape[-1] == 4 and sorted(_np(ring[0, 0]).tolist()) == [11, 12, 13, 14]
