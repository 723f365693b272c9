"""Wrappers around the impact-scatter CUDA kernel (``csrc/impact_scatter.cu``).

They pad, sort postings by doc (``sorted_posting_tiles``) and launch the
kernel for CUDA tensors. For CPU tensors, and only for those, they run the
plain PyTorch version in ``ref.py`` instead. There is no fallback: on a
CUDA tensor the kernel runs or the call raises.

``CONTRACT`` declares the shapes the kernel is checked at (the reference
contract's, and the edges ``chip_smoke.py`` holds it to) and the launch
plan it is checked against (:func:`launch_plan`, which the launcher also
takes its numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# The kernel (``csrc/impact_scatter.cu``) cuts each row into ranges of
# THREADS * spt posting slots, spt one of SLOTS_PER_THREAD (a warp takes 32
# * spt of them, a lane spt), and gives a CTA ``stages`` consecutive ranges,
# one staged in shared memory while the one before it is summed. A range
# also stages the EXTRA slots after it, for a run that goes on past its end
# (a longer run reads on one slot a load).
THREADS = 256
SLOTS_PER_THREAD = (2, 4, 8)
STAGES = (1, 2, 4, 8, 16, 32)
HEAD = 4  # slots staged before a range: the previous slot's doc
EXTRA = 64
# CTAs an SM should get from a batch before a CTA takes more ranges.
CTAS_PER_SM = 56


@functools.lru_cache(maxsize=256)
def range_layout(batch: int, n_slots: int, n_docs: int, n_sms: int) -> tuple[int, int]:
    """``(spt, stages)`` for ``[batch, n_slots]`` slots over ``n_docs`` docs.

    spt follows the slots a doc: the least of ``SLOTS_PER_THREAD`` at or
    above ``n_slots / n_docs`` (the most where none is). Dense rows (rho =
    1M on the 276,307-doc shard: 3.6 slots a doc) take longer lanes; sparse
    ones (100k: 0.36) more, shorter units, whose warps share the writing
    of the wide doc spans between postings. Then the most ranges a CTA that
    still gives every SM ``CTAS_PER_SM`` CTAs (one where none does). Both
    rules are the fastest of ``chip_smoke.py``'s sweep at B = 1 and 64, rho
    = 1M and 100k (``PERF.md``)."""
    spt = next((s for s in SLOTS_PER_THREAD if s * n_docs >= n_slots), SLOTS_PER_THREAD[-1])
    n_ranges = -(-n_slots // (THREADS * spt))
    stages = STAGES[0]
    for k in STAGES:
        if max(batch, 1) * -(-n_ranges // k) >= CTAS_PER_SM * n_sms:
            stages = k
    return spt, stages


def launch_plan(batch: int, n_slots: int, n_docs: int, n_sms: int) -> common.LaunchPlan:
    """The kernel's launch for ``[batch, n_slots]`` sorted slots over
    ``n_docs`` docs: ``range_layout``'s (spt, stages), one CTA a run of
    ``stages`` ranges of a row (one at least, which zeroes an empty row)
    and a row a ``grid.y``; two staged ranges of ``HEAD + THREADS * spt +
    EXTRA`` slots in static shared memory."""
    return _plan(batch, n_slots, n_docs, *range_layout(batch, n_slots, n_docs, n_sms))


@functools.lru_cache(maxsize=1024)
def _plan(batch: int, n_slots: int, n_docs: int, spt: int, stages: int) -> common.LaunchPlan:
    span = THREADS * spt * stages
    width = HEAD + THREADS * spt + EXTRA
    return common.LaunchPlan(
        "impact_scatter", "impact_scatter_launch", f"impact_scatter_kernel<{spt}>",
        (batch, n_slots, n_docs, spt, stages), grid=(max(1, -(-n_slots // span)), batch, 1),
        threads=THREADS,
        static_smem=((f"s_doc i32[2, {width}]", 8 * width), (f"s_val f32[2, {width}]", 8 * width)),
        cover=(("x", n_slots, span), ("y", batch, 1)))


def impact_scatter_launch(
    docs: torch.Tensor, contribs: torch.Tensor, n_docs: int, block_d: int
) -> torch.Tensor:
    """Launch the kernel on sorted postings. f32[B, n_docs] on the card.

    ``docs`` i32[B, P] sorted per row with values in ``[0, n_docs]`` (the
    sentinel ``n_docs`` on slots that carry nothing), ``contribs``
    f32[B, P]; ``n_docs % block_d == 0``.
    """
    global LAUNCHES
    common.check_block_d(block_d)
    common.check_cuda_tensors(docs, contribs)
    common.check_dtypes(docs=(docs, torch.int32), contribs=(contribs, torch.float32))
    if docs.ndim != 2 or docs.shape != contribs.shape:
        raise ValueError(f"expected matching [B, P] inputs, got {docs.shape}, {contribs.shape}")
    if n_docs % block_d:
        raise ValueError(f"n_docs {n_docs} is not a multiple of block_d {block_d}")
    B, P = docs.shape
    if B > 65535:
        raise ValueError(f"the kernel takes B <= 65535, got {B}")
    out = contribs.new_empty((B, n_docs))
    if B and n_docs:
        plan = launch_plan(B, P, n_docs, common.sm_count(docs.get_device()))
        common.launch("impact_scatter", plan.symbol, 3,
                      (docs.data_ptr(), contribs.data_ptr(), out.data_ptr()) + plan.ints,
                      docs.get_device())
        LAUNCHES += 1
    return out


def impact_scatter_batched(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    *,
    block_d: int = 512,
    tile_p: int = 512,
) -> torch.Tensor:
    """acc[b, d] = sum of contribs[b] with doc_ids[b] == d. f32[B, n_docs].

    ``doc_ids`` entries lie in ``[0, n_docs)``; masked-out postings carry
    contribution 0. One kernel launch covers the whole batch.
    """
    common.check_block_d(block_d)  # the same limits on the CPU as on the card
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    docs, c = common.sorted_posting_tiles(doc_ids, contribs, n_docs_pad, tile_p)
    acc = common.run_kernel(
        "impact_scatter", (*docs.shape, n_docs_pad), docs,
        lambda: impact_scatter_batched_ref(docs, c, n_docs_pad),
        lambda: impact_scatter_launch(docs, c, n_docs_pad, block_d))
    return acc[:, :n_docs]


def impact_scatter(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    *,
    block_d: int = 512,
    tile_p: int = 512,
) -> torch.Tensor:
    """Single-query ``[P]`` form: a batch of one. f32[n_docs]."""
    return impact_scatter_batched(
        doc_ids[None], contribs[None], n_docs, block_d=block_d, tile_p=tile_p
    )[0]


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    """The launch the wrapper makes at ``dims``: slots padded to ``tile_p``,
    docs to ``block_d``."""
    n_docs_pad = common.round_up(max(dims["n_docs"], dims["block_d"]), dims["block_d"])
    n_slots = common.round_up(dims["n_postings"], dims["tile_p"])
    return [launch_plan(dims.get("batch", 1), n_slots, n_docs_pad, n_sms)]


def _contract_call(dims, device):
    """The wrapper at ``dims`` on random postings (gamma contributions)."""
    rng = np.random.default_rng(dims["n_postings"] + dims["n_docs"])
    shape = ((dims["batch"],) if "batch" in dims else ()) + (dims["n_postings"],)
    docs = torch.as_tensor(rng.integers(0, dims["n_docs"], shape), dtype=torch.int32,
                           device=device)
    c = torch.as_tensor(rng.gamma(2.0, 1.0, shape), dtype=torch.float32, device=device)
    fn = impact_scatter_batched if "batch" in dims else impact_scatter
    return functools.partial(fn, n_docs=dims["n_docs"], block_d=dims["block_d"],
                             tile_p=dims["tile_p"]), (docs, c)


# The edge that chip_smoke.py holds both scatter kernels to at block_d 512
# (scatter_edge_inputs: block ``empty`` gets no posting, block ``long`` a run
# over three stages of 1,024 postings, so 6,000 + 3 * 1,024 + 100 postings a
# row, and every doc of block ``dead`` is tombstoned).
EDGE = dict(batch=3, n_postings=9172, n_docs=4000, block_d=512, tile_p=512, empty=2, long=5,
            dead=6)

# The reference contract's cases (same names and dims), then the edge.
CONTRACT = KernelContract(
    name="impact_scatter",
    description="batch-gridded scatter-add accumulator (SAAT hot loop)",
    make_call=_contract_call,
    plan=_contract_plan,
    expect_async_copy=True,
    shape_grid=(
        ShapeCase("single_tile", dict(n_postings=128, n_docs=512, block_d=256, tile_p=128)),
        ShapeCase("ragged", dict(n_postings=1000, n_docs=1000, block_d=256, tile_p=128)),
        ShapeCase("multi_tile", dict(n_postings=4096, n_docs=512, block_d=256, tile_p=128)),
        ShapeCase("b1", dict(batch=1, n_postings=128, n_docs=700, block_d=256, tile_p=128)),
        ShapeCase("b3_ragged", dict(batch=3, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
        ShapeCase("b8", dict(batch=8, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
        ShapeCase("edge", EDGE, port=True),
    ),
)
