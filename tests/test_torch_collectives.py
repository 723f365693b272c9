"""The port's gradient compression and collectives
(``repro_torch.distributed.collectives``, ``elastic.data_parallel_liveness``)
against the JAX reference's, on the CPU.

* ``quantize_int8``'s ``q`` and scales and ``compress_decompress`` bit for
  bit equal to the reference's, on edge cases (ragged tails, zero blocks,
  ties at half a step, bf16) and on the int8 properties of
  ``tests/test_props.py`` run on both packages with the same inputs;
* the two error-feedback tests of ``tests/test_train_ckpt.py``, each run on
  both packages with the same inputs: the sent gradients and residuals bit
  for bit over 20 rounds; the compressed trainer's losses within rtol 1e-4
  (atol 1e-5, the last losses being near 1e-2 of the first) of the
  reference's over 60 steps (the two trainers' f32 products sum in other
  orders, and AdamW carries a difference on), both converging;
* ``compressed_psum``, ``reduce_scatter_grads`` and
  ``data_parallel_liveness`` on the in-process path against the reference
  under ``shard_map`` on 4 forced host devices (a subprocess with its own
  timeout): the compressed sum and the reduce-scatter within rtol 1e-6
  (atol 1e-6 times the largest): inside that program XLA computes the
  scales' division by 127 otherwise than the reference's own eager run
  (1 ulp apart), and may add the 4 ranks in another order; the compressed
  sum bit for bit equal to the reference run eagerly (``jax.vmap`` over a
  named axis); the liveness count equal; the compressed sum within its
  int8 bound of the exact sum;
* gloo at worlds 2 and 4 (a process a rank, each with its own timeout)
  equal to the in-process path bit for bit: the compressed sum and the
  liveness count on any data, the reduce-scatter on gradients whose every
  partial sum is exact in f32 (multiples of 2^-6 under 2^10), since gloo
  fixes its own order of a float sum.
"""
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import train as ref_train
from repro.distributed import collectives as ref_coll
from repro_torch import train
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import make_mesh
from repro_torch.distributed.elastic import data_parallel_liveness

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
PROCESS_TIMEOUT_S = 120
N_RANKS = 4
GRAD_SHAPES = {"w": (8, 300), "b": (12,), "e": (4, 3, 5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a file: the suite's parallel workers would
    otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# quantization, bit for bit
# ---------------------------------------------------------------------------


def _quant_case(name):
    rng = np.random.default_rng(QUANT_CASES.index(name))
    if name == "ragged":
        return rng.normal(size=1000).astype(np.float32) * 3, 256
    if name == "zero_block":
        x = rng.normal(size=(3, 64)).astype(np.float32)
        x[1] = 0.0
        return x, 64
    if name == "half_steps":  # ratios of exactly k + 0.5: round half to even
        x = (np.arange(-127, 128, dtype=np.float32) + 0.5) / 127.5
        return x, 255
    if name == "tiny":
        return (rng.normal(size=50) * 1e-30).astype(np.float32), 16
    if name == "bf16":
        return rng.normal(size=(5, 7)).astype(np.float32), 8
    return rng.normal(size=(2, 3, 40)).astype(np.float32) * 100, 32


QUANT_CASES = ["ragged", "zero_block", "half_steps", "tiny", "bf16", "wide_3d"]


@pytest.mark.parametrize("name", QUANT_CASES)
def test_quantize_int8_is_bit_for_bit_the_references(name):
    x, block = _quant_case(name)
    if name == "bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        ref_x = jnp.asarray(x, dtype=jnp.bfloat16)
    else:
        t, ref_x = torch.from_numpy(x), jnp.asarray(x)
    q, s = coll.quantize_int8(t, block)
    ref_q, ref_s = ref_coll.quantize_int8(ref_x, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _bits_equal(q, ref_q)
    _bits_equal(s, ref_s)
    _bits_equal(coll.dequantize_int8(q, s, t.shape, t.dtype),
                ref_coll.dequantize_int8(ref_q, ref_s, ref_x.shape, ref_x.dtype))
    _bits_equal(coll.compress_decompress(t, block), ref_coll.compress_decompress(ref_x, block))


# the int8 properties of tests/test_props.py, on both packages

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3000))
def test_int8_compression_bounded_error(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32) * 10
    xc = coll.compress_decompress(torch.from_numpy(x), block=256)
    _bits_equal(xc, ref_coll.compress_decompress(jnp.asarray(x), block=256))
    # error bounded by half a quantization step per block
    err = np.abs(xc.numpy() - x)
    step = np.abs(x).max() / 127
    assert err.max() <= step + 1e-6


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_int8_roundtrip_shape_dtype(seed):
    rng = np.random.default_rng(seed)
    shape = (rng.integers(1, 20), rng.integers(1, 20))
    x = rng.normal(size=shape).astype(np.float32)
    q, s = coll.quantize_int8(torch.from_numpy(x), block=64)
    y = coll.dequantize_int8(q, s, x.shape, torch.float32)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    ref_q, ref_s = ref_coll.quantize_int8(jnp.asarray(x), block=64)
    _bits_equal(q, ref_q)
    _bits_equal(s, ref_s)


# ---------------------------------------------------------------------------
# the error-feedback tests of tests/test_train_ckpt.py, on both packages
# ---------------------------------------------------------------------------


def test_error_feedback_compensates():
    """With error feedback, the SUM of sent grads converges to the true sum;
    every round's sent grads and residual are the reference's."""
    compress, init_res = coll.make_error_feedback_transform(coll.CompressionConfig(block=64))
    ref_compress, ref_init = ref_coll.make_error_feedback_transform(
        ref_coll.CompressionConfig(block=64))
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=256).astype(np.float32)
    g, ref_g = {"w": torch.from_numpy(g_np)}, {"w": jnp.asarray(g_np)}
    res, ref_res = init_res(g), ref_init(ref_g)
    sent_total = np.zeros(256, np.float32)
    for _ in range(20):
        sent, res = compress(g, res)
        ref_sent, ref_res = ref_compress(ref_g, ref_res)
        _bits_equal(sent["w"], ref_sent["w"])
        _bits_equal(res["w"], ref_res["w"])
        sent_total += sent["w"].numpy()
    np.testing.assert_allclose(sent_total / 20, g_np, atol=0.02)


def _quadratic_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    l = torch.mean((pred - batch["y"]) ** 2)
    return l, {"mse": l}


def _ref_quadratic_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    l = jnp.mean((pred - batch["y"]) ** 2)
    return l, {"mse": l}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(4, 3)).astype(np.float32)
    for _ in range(n):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        yield {"x": x, "y": x @ w_true}


def _compressed_run(pkg):
    """The test's trainer on one package: 60 steps with the error-feedback
    transform as its ``grad_transform``."""
    if pkg == "port":
        c, lib, loss, arr = coll, train, _quadratic_loss, torch.from_numpy
        params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
    else:
        c, lib, loss, arr = ref_coll, ref_train, _ref_quadratic_loss, jnp.asarray
        params = {"w": jnp.zeros((4, 3)), "b": jnp.zeros((3,))}
    compress, init_res = c.make_error_feedback_transform(c.CompressionConfig(block=32))
    residual = {"holder": init_res(params)}

    def transform(grads):
        sent, residual["holder"] = compress(grads, residual["holder"])
        return sent

    step = lib.make_train_step(loss, lib.AdamWConfig(lr=0.05, warmup_steps=1, weight_decay=0.0),
                               grad_transform=transform)
    batches = [{k: arr(v) for k, v in b.items()} for b in _batches(60)]
    kw = {} if pkg == "port" else {"jit": False}
    _, hist = lib.train_loop(step, lib.init_train_state(params), batches, **kw)
    return [h["loss"] for h in hist]


def test_compressed_grads_still_converge():
    got, want = _compressed_run("port"), _compressed_run("reference")
    assert got[-1] < 0.2 * got[0] and want[-1] < 0.2 * want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_disabled_compression_passes_grads_through():
    compress, init_res = coll.make_error_feedback_transform(coll.CompressionConfig(enabled=False))
    g = {"a": torch.randn(5), "b": [torch.randn(3, 2)]}
    res = init_res(g)
    sent, res2 = compress(g, res)
    assert sent["a"] is g["a"] and sent["b"][0] is g["b"][0] and res2["a"] is res["a"]


# ---------------------------------------------------------------------------
# the collectives: in process against the reference's shard_map, and gloo
# ---------------------------------------------------------------------------


def _rank_inputs(n_ranks, dyadic=False):
    """Every rank's operand of ``compressed_psum`` and grad tree, from a seed."""
    rng = np.random.default_rng(7 + n_ranks)
    xs = [(rng.normal(size=(6, 100)) * (1 + r)).astype(np.float32) for r in range(n_ranks)]
    xs[0][0, :] = 0.0  # a zero block on one rank only
    grads = []
    for r in range(n_ranks):
        tree = {}
        for k, shape in GRAD_SHAPES.items():  # dim 0 splits over 2 and 4 ranks
            if dyadic:
                tree[k] = (rng.integers(-2**15, 2**15, size=shape) / 64).astype(np.float32)
            else:
                tree[k] = rng.normal(size=shape).astype(np.float32)
        grads.append(tree)
    return xs, grads


_REF_SHARD_MAP = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import compressed_psum, reduce_scatter_grads
from repro.distributed.elastic import data_parallel_liveness
inp = dict(np.load(sys.argv[1]))
n = int(inp["n"])
mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
keys = sorted(k[2:] for k in inp if k.startswith("g_"))

def body(x, *gs):
    psum = compressed_psum(x[0], "data", block=int(inp["block"]))
    rs = reduce_scatter_grads({k: g[0] for k, g in zip(keys, gs)}, "data")
    live = data_parallel_liveness("data")
    return (psum[None], *(rs[k][None] for k in keys), live[None])

f = shard_map(body, mesh=mesh, in_specs=(P("data"),) * (1 + len(keys)),
              out_specs=(P("data"),) * (2 + len(keys)), check_rep=False)
out = jax.jit(f)(inp["x"], *(inp["g_" + k] for k in keys))
np.savez(sys.argv[2], psum=np.asarray(out[0]), live=np.asarray(out[-1]),
         **{"rs_" + k: np.asarray(o) for k, o in zip(keys, out[1:-1])})
"""


def _in_process(n_ranks, dyadic=False, block=64):
    xs, grads = _rank_inputs(n_ranks, dyadic)
    psum = coll.compressed_psum([torch.from_numpy(x) for x in xs], block=block)
    rs = coll.reduce_scatter_grads([{k: torch.from_numpy(v) for k, v in g.items()}
                                    for g in grads])
    return xs, grads, psum, rs


def test_collectives_equal_the_references_shard_map(tmp_path):
    block = 64
    xs, grads, psum, rs = _in_process(N_RANKS, block=block)
    np.savez(tmp_path / "in.npz", n=N_RANKS, block=block, x=np.stack(xs),
             **{"g_" + k: np.stack([g[k] for g in grads]) for k in GRAD_SHAPES})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    out = subprocess.run([sys.executable, "-c", _REF_SHARD_MAP, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=PROCESS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = dict(np.load(tmp_path / "out.npz"))
    for r in range(N_RANKS):
        np.testing.assert_allclose(psum[r].numpy(), ref["psum"][r], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref["psum"]).max())
        for k in GRAD_SHAPES:
            np.testing.assert_allclose(rs[r][k].numpy(), ref["rs_" + k][r], rtol=1e-6,
                                       atol=1e-6 * np.abs(ref["rs_" + k]).max())
    # the reference run eagerly (op by op under vmap's named axis): bit for bit
    eager = jax.vmap(lambda x: ref_coll.compressed_psum(x, "data", block), axis_name="data")(
        jnp.asarray(np.stack(xs)))
    for r in range(N_RANKS):
        _bits_equal(psum[r], eager[r])
    mesh = make_mesh((N_RANKS, 1), ("data", "model"), device="cpu")
    assert int(data_parallel_liveness(mesh)) == N_RANKS == int(ref["live"][0])
    # within the int8 bound of the exact sum: each rank's two roundings
    # (quantize, re-quantize to the shared scale) of half a shared step each
    exact = np.sum(xs, axis=0, dtype=np.float64)
    q, s = coll.quantize_int8(torch.from_numpy(np.abs(np.stack(xs)).max(0)), block)
    bound = N_RANKS * s.numpy().repeat(block)[:exact.size].reshape(exact.shape)
    assert (np.abs(psum[0].numpy() - exact) <= bound + 1e-6).all()
    for r, slices in enumerate(rs):
        for k in GRAD_SHAPES:
            total = sum(torch.from_numpy(g[k]) for g in grads)
            assert torch.equal(slices[k], torch.chunk(total, N_RANKS)[r])


def run_rank(store_path, rank, world, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        res = {}
        for dyadic in (False, True):
            xs, grads = _rank_inputs(world, dyadic)
            res[f"psum_{dyadic}"] = coll.compressed_psum(torch.from_numpy(xs[rank]), group,
                                                         block=64).numpy()
            rs = coll.reduce_scatter_grads({k: torch.from_numpy(v) for k, v in
                                            grads[rank].items()}, group)
            res.update({f"rs_{dyadic}_{k}": v.numpy() for k, v in rs.items()})
        mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
        res["live"] = data_parallel_liveness(mesh, group=group).numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_equals_the_in_process_path(tmp_path, world):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        out = tmp_path / f"rank{rank}.npz"
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / "store"), str(rank), str(world), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    try:
        for rank, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=PROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {world} ran past {PROCESS_TIMEOUT_S} s")
            assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    got = [dict(np.load(o)) for o in outs]
    for dyadic in (False, True):
        _, _, psum, rs = _in_process(world, dyadic)
        for rank in range(world):
            np.testing.assert_array_equal(got[rank][f"psum_{dyadic}"], psum[rank].numpy())
            for k in GRAD_SHAPES:
                want = rs[rank][k].numpy()
                if dyadic:
                    np.testing.assert_array_equal(got[rank][f"rs_{dyadic}_{k}"], want)
                else:
                    np.testing.assert_allclose(got[rank][f"rs_{dyadic}_{k}"], want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max())
    assert [int(g["live"]) for g in got] == [world] * world


if __name__ == "__main__":
    store_path, rank, world, out_path = sys.argv[1:5]
    run_rank(store_path, int(rank), int(world), out_path)
