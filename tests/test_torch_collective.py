"""The collective path of the port's sharded and pod serve steps, on gloo.

Each test starts one process a rank (``sys.executable`` running this file),
which joins a gloo process group through a ``FileStore`` under the test's
``tmp_path``, holds only its own block of every operand (``rank_block``:
its shard rows, its tombstone rows, its query rows), and serves:

* at world 2, layout (1, 2), and at world 4, layout (2, 2): the sharded
  step on a ``("data", "model")`` mesh (SAAT fused, live-masked) and the
  pod step on a ``("pod", "model")`` mesh (SAAT sort, SAAT under a budget
  and live-masked, DAAT fused), each over 2 shards a rank of the ragged
  37-doc corpus;
* ``canonical_topk_merge`` and ``sharded_topk_merge`` over the group, on
  pools with ``-inf`` rows, sentinels and ties.

Every rank's answer must equal its block of the in-process path's answer
bit for bit. Every process has its own timeout and is killed when it runs
out; a timeout fails the test.
"""
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import canonical_topk_merge, sharded_topk_merge
from repro_torch.distributed import make_mesh
from repro_torch.serving import (
    make_pod_serve_step,
    make_sharded_serve_step,
    rank_block,
    shard_corpus,
    shard_live_stack,
    stack_indexes,
)

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120
I32_MAX = np.iinfo(np.int32).max


def _corpus(n_shards):
    """The reference's ragged 37-doc corpus (``tests/test_pod.py``), its
    stack over ``n_shards``, a tombstone stack and a query batch."""
    rng = np.random.default_rng(0)
    n_docs, n_terms, nnz = 37, 24, 300
    d = rng.integers(0, n_docs, nnz).astype(np.int32)
    t = rng.integers(0, n_terms, nnz).astype(np.int32)
    w = rng.uniform(0.1, 5.0, nnz).astype(np.float32)
    _, ix = np.unique(d.astype(np.int64) * n_terms + t, return_index=True)
    shards, dps = shard_corpus(d[ix], t[ix], w[ix], n_docs, n_terms, n_shards, device="cpu")
    stack = stack_indexes(shards)
    live = shard_live_stack((rng.random(n_docs) < 0.75).astype(np.int32), n_shards=n_shards,
                            docs_per_shard=dps, n_docs_pad=int(stack.doc_n_terms.shape[1]))
    qt = rng.integers(0, n_terms, (8, 6)).astype(np.int32)
    qw = rng.uniform(0.1, 2.0, (8, 6)).astype(np.float32)
    return stack, dps, n_docs, live, qt, qw


def _cases(layout):
    """name -> (mesh, the function that makes the step, keywords, live-masked)."""
    stack, dps, n_docs, _, _, _ = _corpus(2 * layout[0] * layout[1])
    exact = int(stack.doc_ids.shape[1])
    base = dict(k=10, docs_per_shard=dps, n_docs_total=n_docs, max_segs_per_term=stack.max_segs)
    saat = dict(base, rho_per_shard=exact)
    daat = dict(base, rho_per_shard=0, engine="daat", daat_est_blocks=2, daat_block_budget=2,
                max_bm_per_term=stack.max_bm, daat_use_kernels=True, daat_fused_chunk=True)
    sharded = make_mesh(layout, ("data", "model"), device="cpu")
    pod = make_mesh(layout, ("pod", "model"), device="cpu")
    return {
        "sharded_fused_live": (sharded, make_sharded_serve_step, dict(saat, fused_topk=True), True),
        "pod_sort": (pod, make_pod_serve_step, saat, False),
        "pod_budget_live": (pod, make_pod_serve_step, dict(saat, rho_per_shard=40), True),
        "pod_daat_fused": (pod, make_pod_serve_step, daat, False),
    }


def _pools(n_ranks, B=5, k=6):
    """Rank pools, each a contiguous id range sorted descending, integer
    scores (ties), ``-inf`` rows and ``(-inf, INT32_MAX)`` sentinels."""
    rng = np.random.default_rng(50 + n_ranks)
    out = []
    for r in range(n_ranks):
        s = rng.integers(0, 3, (B, k)).astype(np.float32)
        ids = (r * 100 + rng.permutation(k * B).reshape(B, k)).astype(np.int32)
        s[rng.integers(B)] = -np.inf
        s[rng.integers(B), k // 2:] = -np.inf
        ids[np.isneginf(s) & (rng.random((B, k)) < 0.5)] = I32_MAX
        order = np.argsort(-s, axis=-1, kind="stable")
        out.append((torch.from_numpy(np.take_along_axis(s, order, -1)),
                    torch.from_numpy(np.take_along_axis(ids, order, -1))))
    return out


def _serve(case, rank, layout, group):
    """One case's answer: this rank's block over ``group``, or (rank None,
    group None) the in-process path's whole answer."""
    mesh, build, kw, live_masked = _cases(layout)[case]
    stack, _, _, live, qt, qw = _corpus(2 * layout[0] * layout[1])
    serve, in_specs, _ = build(mesh, live_masked=live_masked, group=group, **kw)
    if rank is not None:
        stack, qt, qw = (rank_block(x, in_specs[i], mesh, rank) for i, x in
                         ((0, stack), (-2, qt), (-1, qw)))
        if live_masked:
            live = rank_block(live, in_specs[1], mesh, rank)
    return serve(stack, qt, qw, live_stack=live if live_masked else None)


def run_rank(store_path, rank, world, layout, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        res = {}
        for case in _cases(layout):
            s, i = _serve(case, rank, layout, group)
            res[case + "_s"], res[case + "_i"] = s.numpy(), i.numpy()
        s, i = _pools(world)[rank]
        for name, merge in (("canonical", canonical_topk_merge), ("sharded", sharded_topk_merge)):
            ms, mi = merge(s, i, 8, group)
            res[name + "_s"], res[name + "_i"] = ms.numpy(), mi.numpy()
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _run_world(tmp_path, world, layout):
    """Every rank as its own process; each waited on with its own timeout
    and killed when it runs out (which fails the test)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs, outs = [], []
    for rank in range(world):
        out = tmp_path / f"rank{rank}.npz"
        cmd = [sys.executable, __file__, str(store), str(rank), str(world),
               f"{layout[0]}x{layout[1]}", str(out)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    try:
        for rank, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {world} ran past {RANK_TIMEOUT_S} s")
            assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)])
def test_collective_path_equals_the_in_process_path(tmp_path, layout):
    world = layout[0] * layout[1]
    got = _run_world(tmp_path, world, layout)
    for case, (mesh, build, kw, live_masked) in _cases(layout).items():
        s, i = _serve(case, None, layout, None)
        _, _, out_specs = build(mesh, live_masked=live_masked, **kw)
        assert np.isfinite(s.numpy()).any(), case
        for rank in range(world):
            want_s = rank_block(s, out_specs[0], mesh, rank).numpy()
            want_i = rank_block(i, out_specs[1], mesh, rank).numpy()
            np.testing.assert_array_equal(got[rank][case + "_i"], want_i, err_msg=case)
            np.testing.assert_array_equal(got[rank][case + "_s"], want_s, err_msg=case)
    pools = _pools(world)
    for name, merge in (("canonical", canonical_topk_merge), ("sharded", sharded_topk_merge)):
        ws, wi = merge([p[0] for p in pools], [p[1] for p in pools], 8)
        for rank in range(world):
            np.testing.assert_array_equal(got[rank][name + "_i"], wi.numpy(), err_msg=name)
            np.testing.assert_array_equal(got[rank][name + "_s"], ws.numpy(), err_msg=name)


def test_a_group_of_another_size_raises(tmp_path):
    """A world of one serving a two-rank mesh raises rather than answering."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=30))
    try:
        mesh, build, kw, _ = _cases((1, 2))["pod_sort"]
        stack, _, _, _, qt, qw = _corpus(4)
        serve, _, _ = build(mesh, group=dist.group.WORLD, **kw)
        with pytest.raises(ValueError, match="the process group has 1 ranks, the mesh 2"):
            serve(stack, qt, qw)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    store_path, rank, world, layout, out_path = sys.argv[1:6]
    run_rank(store_path, int(rank), int(world), tuple(int(n) for n in layout.split("x")),
             out_path)
