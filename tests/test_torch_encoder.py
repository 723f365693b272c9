"""The port's transformer layers, stack and sparse encoders
(``archs/layers.py``, ``archs/transformer.py``, ``models/sparse_encoder.py``)
against the JAX reference's, on the CPU.

Inputs, and params in the reference's layout, are made with numpy from a
seed and fed to both packages; the params are carried into the port by
``encoder_params_from_reference`` / ``lm_params_from_reference``. Both
packages compute in f32 on the host, but their matrix products sum in
other orders, so:

* activations (norms, rope, attention, MLP, hidden states, sparse reps)
  agree within rtol 1e-5, atol 1e-5 (a few ulps of the largest value);
* losses and metrics within rtol 1e-5; nonzero counts equal;
* gradients within rtol 1e-4 and an atol of 1e-5 times the leaf's largest
  gradient (the embedding's gradient sums over every position of the
  batch);
* ``encode_corpus_to_coo``: the same postings but where a weight lies
  within 1e-5 of the threshold, and those weights as the activations.

The reference's functions run under ``jax.jit`` (its op-by-op dispatch
would take most of the file's time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import layers as ref_layers
from repro.archs import transformer as ref_tf
from repro.data.synthetic import CorpusConfig as RefCorpusConfig
from repro.data.synthetic import generate_corpus as ref_generate_corpus
from repro.models import sparse_encoder as ref_enc
from repro_torch.archs import layers, transformer
from repro_torch.data.pipeline import TripleSampler
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.models import sparse_encoder as enc
from repro_torch.train import AdamWConfig, init_train_state, make_train_step, train_loop

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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def ref_params_like(init, cfg, seed):
    """Params in the reference's pytree layout for ``init(key, cfg)``, its
    structure from ``jax.eval_shape`` (nothing compiled) and its values
    drawn with numpy: matrices at the init's scale, embeddings at 0.02,
    norm scales about 1."""
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

    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(draw, shapes)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rmsnorm_layernorm_and_mlp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    _close(layers.rmsnorm({"scale": _t(scale)}, _t(x)),
           ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    norm = layers.RMSNorm(16)
    norm.scale.data.copy_(_t(scale))
    _close(norm(_t(x)), ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(layers.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           ref_layers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x)))
    w = {k: rng.normal(size=s).astype(np.float32) / 4
         for k, s in (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    _close(layers.mlp({k: _t(v) for k, v in w.items()}, _t(x)),
           ref_layers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x)))


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos)),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    _close(layers.apply_rope(_t(x), _t(pos[0]), theta=500.0),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), theta=500.0))


_ref_attention = jax.jit(ref_layers.multihead_attention, static_argnums=2,
                         static_argnames=("window", "chunk_size"))


def _attn_inputs(seed, d_model=32, dims=layers.AttnDims(4, 2, 8), B=2, S=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d_model)).astype(np.float32)
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (d_model, dims.n_heads * dims.d_head)),
                      ("wk", (d_model, dims.n_kv_heads * dims.d_head)),
                      ("wv", (d_model, dims.n_kv_heads * dims.d_head)),
                      ("wo", (dims.n_heads * dims.d_head, d_model)))}
    return x, w, dims


@pytest.mark.parametrize("window", [-1, 0, 4])
@pytest.mark.parametrize("chunk", [0, 4])
def test_attention_at_each_window(window, chunk):
    """Dense and chunked (online-softmax) attention, GQA, bidirectional,
    causal and sliding, against the reference's; the chunked path also
    against the port's dense."""
    x, w, dims = _attn_inputs(window + 10)
    pos = np.arange(16, dtype=np.int32)
    want = _ref_attention({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                          ref_layers.AttnDims(4, 2, 8), positions=jnp.asarray(pos),
                          window=window, chunk_size=chunk)
    got = layers.multihead_attention({k: _t(v) for k, v in w.items()}, _t(x), dims,
                                     positions=_t(pos), window=window, chunk_size=chunk)
    _close(got, want, what=f"window {window} chunk {chunk}")
    if chunk:
        dense = layers.multihead_attention({k: _t(v) for k, v in w.items()}, _t(x), dims,
                                           positions=_t(pos), window=window)
        _close(got, dense)


def test_attention_module_and_fully_masked_rows():
    """``Attention`` holds the reference's projections; a query that sees no
    key (every key position < 0, an empty cache) gives zeros, not NaN, in
    both packages, through both the dense and the chunked path."""
    x, w, dims = _attn_inputs(3)
    mod = layers.Attention(torch.Generator().manual_seed(0), 32, dims)
    for k, v in w.items():
        getattr(mod, k).data.copy_(_t(v))
    pos = np.arange(16, dtype=np.int32)
    _close(mod(_t(x), positions=_t(pos), window=-1),
           _ref_attention({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                          ref_layers.AttnDims(4, 2, 8), positions=jnp.asarray(pos), window=-1))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 3, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 8, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 8, 2, 8)).astype(np.float32)
    q_pos = np.array([[0, 1, 2]], np.int32)
    k_pos = np.array([[-1] * 8], np.int32)
    k_pos_half = np.array([[0, 1, -1, -1, -1, -1, -1, -1]], np.int32)
    for kp in (k_pos, k_pos_half):
        want = jax.jit(ref_layers._attention_dense, static_argnums=(5, 6))(
            *map(jnp.asarray, (q, k, v, q_pos, kp)), ref_layers.AttnDims(4, 2, 8), 0)
        got = layers._attention_dense(*map(_t, (q, k, v, q_pos, kp)), dims, 0)
        chunked = layers._attention_chunked(*map(_t, (q, k, v, q_pos, kp)), dims, 0, 4)
        assert not torch.isnan(got).any() and not torch.isnan(chunked).any()
        _close(got, want)
        _close(chunked, want)
    assert float(got[0, 0].abs().max()) > 0 and float(
        layers._attention_dense(*map(_t, (q, k, v, q_pos, k_pos)), dims, 0).abs().max()) == 0


# --------------------------------------------------------------------------
# the transformer stack
# --------------------------------------------------------------------------


def _lm_cfgs(**kw):
    """A stack of 3 layers over a period of 2 windows (one scanned repeat
    of 2 and one tail layer in the reference), f32."""
    common = dict(name="t", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                  d_ff=64, vocab=97, window_pattern=(0, 4), **kw)
    return (ref_tf.LMConfig(dtype=jnp.float32, **common),
            transformer.LMConfig(dtype=torch.float32, **common))


def _port_lm(ref_params, cfg):
    model = transformer.init_lm_params(None, cfg, device="meta").to_empty(device="cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    model.load_state_dict(transformer.lm_params_from_reference(tree))
    return model


def test_lm_params_round_trip_and_counts():
    rcfg, pcfg = _lm_cfgs(tie_embeddings=False)
    ref_params = ref_params_like(ref_tf.init_lm_params, rcfg, 0)
    model = _port_lm(ref_params, pcfg)
    assert pcfg.n_params() == rcfg.n_params() == sum(p.numel() for p in model.parameters())
    back = transformer.lm_params_to_reference(dict(model.named_parameters()), pcfg)
    want, _ = jax.tree_util.tree_flatten_with_path(ref_params)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(jax.tree.map(_np, back))[0]}
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in want}
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], np.asarray(leaf))
    for b, s in ((4, 16), (2, 64)):
        assert (transformer.train_step_model_flops(pcfg, b, s)
                == ref_tf.train_step_model_flops(rcfg, b, s))


@pytest.mark.parametrize("vocab_chunk", [0, 4])
def test_lm_hidden_states_and_loss(vocab_chunk):
    rcfg, pcfg = _lm_cfgs(vocab_chunk=vocab_chunk, remat="none")
    ref_params = ref_params_like(ref_tf.init_lm_params, rcfg, 1)
    model = _port_lm(ref_params, pcfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 97, size=(2, 12)).astype(np.int32)
    labels = rng.integers(-1, 97, size=(2, 12)).astype(np.int32)
    if not vocab_chunk:  # the forward does not read the loss's chunk
        h_ref, _ = jax.jit(ref_tf.lm_hidden_states, static_argnums=2)(
            ref_params, jnp.asarray(toks), rcfg)
        h, aux = transformer.lm_hidden_states(model, _t(toks), pcfg)
        _close(h, h_ref)
        assert float(aux) == 0.0
        # the tied head over the hidden states just compared
        torch.testing.assert_close(transformer.lm_logits(model, _t(toks), pcfg),
                                   h @ model.embed.T, rtol=0, atol=0)
    loss_ref, m_ref = jax.jit(ref_tf.lm_loss, static_argnums=3)(
        ref_params, jnp.asarray(toks), jnp.asarray(labels), rcfg)
    loss, m = transformer.lm_loss(model, _t(toks), _t(labels), pcfg)
    _close(loss, loss_ref)
    _close(m["xent"], m_ref["xent"])
    assert int(m["tokens"]) == int(m_ref["tokens"])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_unchecked_gradients(remat):
    """``remat`` changes what backward recomputes, not what it computes."""
    grads = {}
    for policy in ("none", remat):
        _, pcfg = _lm_cfgs(remat=policy)
        model = transformer.init_lm_params(torch.Generator().manual_seed(3), pcfg, device="cpu")
        toks = torch.as_tensor(np.random.default_rng(3).integers(0, 97, size=(2, 12)))
        loss, _ = transformer.lm_loss(model, toks, toks, pcfg)
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads["none"], grads[remat]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the sparse encoders
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpora():
    kw = dict(n_docs=300, n_queries=60, n_concepts=40, seed=1)
    return ref_generate_corpus(RefCorpusConfig(**kw)), generate_corpus(CorpusConfig(**kw))


def _enc_cfgs(head, vocab, d_model=64, n_layers=2, **kw):
    return (ref_enc.SparseEncoderConfig(ref_enc.encoder_backbone(d_model, n_layers, vocab),
                                        head=head, **kw),
            enc.SparseEncoderConfig(enc.encoder_backbone(d_model, n_layers, vocab), head=head,
                                    **kw))


def _port_encoder(ref_params, cfg):
    model = enc.init_encoder_params(None, cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(enc.encoder_params_from_reference(jax.tree.map(np.asarray, ref_params)))
    return model


@pytest.fixture(scope="module", params=["splade", "unicoil"])
def setup(request, corpora):
    ref_corpus, corpus = corpora
    rcfg, pcfg = _enc_cfgs(request.param, corpus.config.n_surface_terms)
    ref_params = ref_params_like(ref_enc.init_encoder_params, rcfg, 0)
    model = _port_encoder(ref_params, pcfg)
    batch = next(TripleSampler(corpus, q_len=8, d_len=32, device="cpu").batches(16))
    return rcfg, pcfg, ref_params, model, batch


def test_encoder_params_round_trip(setup):
    rcfg, pcfg, ref_params, model, _ = setup
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref_params))
    back = enc.encoder_params_to_reference(dict(model.named_parameters()), pcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_np(a), np.asarray(b)),
                 back, ref_params)


def test_encode_both_heads(setup):
    """Queries and docs of a batch, plus rows of repeated tokens and a row
    that is all padding (its rep is all zeros in both)."""
    rcfg, pcfg, ref_params, model, batch = setup
    toks = np.concatenate([batch["pos"].numpy(),
                           np.array([[7, 7, 9, 7, 9, 3] + [0] * 26, [0] * 32], np.int32)])
    mask = np.concatenate([batch["pos_mask"].numpy(),
                           np.array([[True] * 6 + [False] * 26, [False] * 32])])
    ref_encode = jax.jit(ref_enc.encode, static_argnums=3)
    want = ref_encode(ref_params, jnp.asarray(toks), jnp.asarray(mask), rcfg)
    with torch.no_grad():
        got = enc.encode(model, _t(toks), _t(mask), pcfg)
    _close(got, want)
    assert not got[-1].any()
    if pcfg.head == "unicoil":
        assert set(torch.nonzero(got[-2]).flatten().tolist()) <= {3, 7, 9}
    with torch.no_grad():
        _close(enc.encode(model, batch["query"], batch["query_mask"], pcfg),
               ref_encode(ref_params, jnp.asarray(batch["query"].numpy()),
                          jnp.asarray(batch["query_mask"].numpy()), rcfg))


def test_encoder_loss_metrics_and_gradients(setup):
    rcfg, pcfg, ref_params, model, batch = setup
    rb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (loss_ref, m_ref), g_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_enc.encoder_loss(p, rb, rcfg), has_aux=True))(ref_params)
    loss, m = enc.encoder_loss(model, batch, pcfg)
    _close(loss, loss_ref, atol=0)
    for key in ("rank_loss", "flops_reg"):
        _close(m[key], m_ref[key], atol=0, what=key)
    for key in ("pair_acc", "doc_nnz", "query_nnz"):
        assert float(m[key]) == float(m_ref[key]), key
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    g_port = enc.encoder_params_to_reference(dict(zip(names, grads)), pcfg)
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(g_ref)
    flat_port = jax.tree.leaves(jax.tree.map(_np, g_port))
    assert len(flat_ref) == len(flat_port)
    for (path, want), got in zip(flat_ref, flat_port):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_score_and_train_loop_five_steps(corpora):
    """5 steps of ``train_loop`` from the same params on the same batches:
    each step's loss, grad norm and metrics against the reference's, on the
    SPLADE head (uniCOIL's ReLU head goes dead after one step at this size,
    in both; its first step is the gradient test's). AdamW's first steps
    move every weight with a nonzero gradient by about lr, so the losses
    are held to rtol 1e-4, not bit for bit."""
    from repro.data.pipeline import TripleSampler as RefSampler
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import init_train_state as ref_init_state
    from repro.train import make_train_step as ref_make_step
    from repro.train import train_loop as ref_train_loop

    ref_corpus, corpus = corpora
    rcfg, pcfg = _enc_cfgs("splade", corpus.config.n_surface_terms)
    ref_params = ref_params_like(ref_enc.init_encoder_params, rcfg, 0)
    rq = np.random.default_rng(5).random((4, 50)).astype(np.float32)
    rd = np.random.default_rng(6).random((4, 50)).astype(np.float32)
    _close(enc.score(_t(rq), _t(rd)), ref_enc.score(jnp.asarray(rq), jnp.asarray(rd)))
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=40)
    n = 5
    ref_batches = [b for _, b in zip(range(n), RefSampler(ref_corpus, 8, 32).batches(16))]
    batches = [b for _, b in zip(range(n), TripleSampler(corpus, 8, 32, device="cpu").batches(16))]
    _, h_ref = ref_train_loop(ref_make_step(lambda p, b: ref_enc.encoder_loss(p, b, rcfg),
                                            RefAdamW(**opt)),
                              ref_init_state(ref_params), ref_batches)
    port = _port_encoder(ref_params, pcfg)
    step = make_train_step(lambda p, b: enc.encoder_loss(p, b, pcfg), AdamWConfig(**opt))
    _, h = train_loop(step, init_train_state(port), batches)
    assert len(h) == len(h_ref) == n
    for i, (a, b) in enumerate(zip(h, h_ref)):
        assert set(a) == set(b)
        for key in ("loss", "rank_loss", "flops_reg", "grad_norm", "lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=f"step {i} {key}")
        for key in ("pair_acc", "doc_nnz", "query_nnz"):
            assert a[key] == b[key], (i, key)


def test_encode_corpus_to_coo(setup, corpora):
    rcfg, pcfg, ref_params, model, _ = setup
    _, corpus = corpora
    sampler = TripleSampler(corpus, q_len=8, d_len=32, device="cpu")
    toks, masks = zip(*[(t, m) for t, m, _ in sampler.doc_token_batches(64)])
    d, t, w, n = enc.encode_corpus_to_coo(model, toks, masks, pcfg)
    rd, rt, rw, rn = ref_enc.encode_corpus_to_coo(
        ref_params, [jnp.asarray(x.numpy()) for x in toks], [jnp.asarray(x.numpy()) for x in masks],
        rcfg)
    assert n == rn == 320
    assert d.dtype == rd.dtype and t.dtype == rt.dtype and w.dtype == rw.dtype == np.float64
    thr = 1e-4
    got = dict(zip(zip(d.tolist(), t.tolist()), w.tolist()))
    want = dict(zip(zip(rd.tolist(), rt.tolist()), rw.tolist()))
    for key in set(got) ^ set(want):  # present in one: must be at the threshold
        assert abs(got.get(key, want.get(key)) - thr) <= 1e-5, key
    common = sorted(set(got) & set(want))
    assert len(common) > 0.99 * len(want)
    np.testing.assert_allclose([got[k] for k in common], [want[k] for k in common], rtol=RTOL,
                               atol=ATOL)
    # the reference's order: row-major over (doc, term)
    assert np.all(np.diff(d * pcfg.vocab + t) > 0)


# --------------------------------------------------------------------------
# the encoder tests of tests/test_e2e.py, on the port
# --------------------------------------------------------------------------


def test_sparse_encoder_learns_ranking(corpora):
    _, corpus = corpora
    _, cfg = _enc_cfgs("splade", corpus.config.n_surface_terms, flops_weight=1e-5,
                       query_flops_weight=1e-5)
    params = enc.init_encoder_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sampler = TripleSampler(corpus, q_len=8, d_len=32, device="cpu")
    step = make_train_step(lambda p, b: enc.encoder_loss(p, b, cfg),
                           AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40))
    batches = [next(sampler.batches(16)) for _ in range(40)]
    _, hist = train_loop(step, init_train_state(params), batches)
    assert hist[-1]["pair_acc"] > max(hist[0]["pair_acc"], 0.6)
    assert hist[-1]["rank_loss"] < hist[0]["rank_loss"]


def test_sparse_encoder_flops_reg_sparsifies():
    corpus = generate_corpus(CorpusConfig(n_docs=200, n_queries=40, n_concepts=30, seed=2))
    sampler = TripleSampler(corpus, q_len=8, d_len=32, device="cpu")
    batches = [next(sampler.batches(8)) for _ in range(25)]
    nnz = {}
    for w in (1e-6, 3e-2):
        _, cfg = _enc_cfgs("splade", corpus.config.n_surface_terms, d_model=48, n_layers=1,
                           flops_weight=w, query_flops_weight=w)
        params = enc.init_encoder_params(torch.Generator().manual_seed(3), cfg, device="cpu")
        step = make_train_step(lambda p, b, _c=cfg: enc.encoder_loss(p, b, _c),
                               AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=25))
        _, hist = train_loop(step, init_train_state(params), batches)
        nnz[w] = hist[-1]["doc_nnz"]
    assert nnz[3e-2] < nnz[1e-6], nnz


def test_unicoil_head_no_expansion():
    _, cfg = _enc_cfgs("unicoil", 256, d_model=32, n_layers=1)
    params = enc.init_encoder_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.tensor([[5, 9, 11, 0]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False]])
    with torch.no_grad():
        rep = enc.encode(params, toks, mask, cfg)
    assert set(torch.nonzero(rep[0]).flatten().tolist()) <= {5, 9, 11}


def test_encoder_needs_bidirectional_attention():
    with pytest.raises(ValueError, match="bidirectional"):
        enc.SparseEncoderConfig(transformer.LMConfig(
            name="x", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4, d_head=8, d_ff=64,
            vocab=64, window_pattern=(0,)))


def test_models_are_built_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, cfg = _enc_cfgs("splade", 64, d_model=32, n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enc.init_encoder_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_lm_params(None, cfg.backbone)
    assert enc.init_encoder_params(None, cfg, device="meta").backbone.embed.is_meta
