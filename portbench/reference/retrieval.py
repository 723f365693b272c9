"""The plain reference of both configurations: impact-quantized top-k
retrieval, worked again from the raw COO postings the benchmark made.

It imports nothing of the system under test. From ``(doc, term, weight)``
postings it quantizes the weights onto one global uniform grid of
``2**bits - 1`` impacts (a frozen copy of the arithmetic the configuration
states), orders the postings by (term, impact descending, doc ascending),
and answers a query two ways:

  * budgeted score-at-a-time: the query's (term, impact) segments in
    decreasing order of contribution (impact x query weight, in float32;
    equal contributions keep query-slot order, then impact order), the
    first ``rho`` postings of that order, a partial last segment taking its
    lowest doc ids first; each doc's score is the sum of its admitted
    contributions;
  * exhaustive: every posting of the query's terms (``rho=None``), whose
    top-k a rank-safe DAAT has to return.

Scores are summed in float64, so the reference stands above the float32
the system computes in. ``precision=torch.bfloat16`` computes the
contributions and sums in bfloat16 instead: the control, the reference
put in the system's place one precision below the one stated. The top-k
orders by score, then by the lowest doc id.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def quantize_uniform(weights: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray, float]:
    """``(impacts i32, dequantized f32, scale)``: impacts in [1, 2**bits - 1]
    for positive weights, ceil of the weight's share of the largest, and
    each impact's value ``impact * scale`` rounded to float32."""
    levels = (1 << bits) - 1
    w = np.asarray(weights, dtype=np.float64)
    top = max(float(w.max()) if w.size else 1.0, 1e-12)
    q = np.ceil(np.clip(w / top, 0.0, 1.0) * levels)
    q = np.where(w > 0, np.clip(q, 1, levels), 0).astype(np.int32)
    scale = top / levels
    return q, (q.astype(np.float64) * scale).astype(np.float32), scale


def _ranges(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``concat(arange(s, s + n))`` over the pairs."""
    lens = lens.long()
    rep = torch.repeat_interleave(starts.long(), lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return rep + torch.arange(rep.numel(), device=rep.device) - first


@dataclasses.dataclass
class Answer:
    ids: np.ndarray  # i64[k], by score, then lowest id
    scores: np.ndarray  # f64[k]
    acc: torch.Tensor  # every doc's score (0 where nothing was admitted)
    processed: int  # postings admitted
    segments: int  # segments admitted (a partial one counts)


class ReferenceIndex:
    """The raw postings, deduplicated, quantized and sorted on ``device``."""

    def __init__(self, doc_idx, term_idx, weights, n_docs: int, n_terms: int, *, bits: int = 8,
                 block_size: int = 128, device=None):
        dev = torch.device(device or "cpu")
        doc_idx = np.asarray(doc_idx, dtype=np.int64)
        term_idx = np.asarray(term_idx, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        keep = weights > 0
        doc_idx, term_idx, weights = doc_idx[keep], term_idx[keep], weights[keep]
        key = doc_idx * n_terms + term_idx
        order = np.argsort(key, kind="stable")
        key, weights = key[order], weights[order]
        first = np.ones(key.size, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        if not first.all():  # a (doc, term) pair twice: one posting of their sum
            idx = np.flatnonzero(first)
            key, weights = key[idx], np.add.reduceat(weights, idx)
        doc_idx, term_idx = key // n_terms, key % n_terms
        q, deq, self.scale = quantize_uniform(weights, bits)
        levels = (1 << bits) - 1
        if float(n_terms + 1) * (levels + 1) * max(n_docs, 1) >= 2.0 ** 62:
            raise ValueError("the sort key of (term, impact, doc) overflows 62 bits")

        self.n_docs, self.n_terms, self.block_size, self.device = n_docs, n_terms, block_size, dev
        self.n_blocks = -(-n_docs // block_size)
        t = torch.from_numpy(term_idx).to(dev)
        d = torch.from_numpy(doc_idx).to(dev)
        qq = torch.from_numpy(q.astype(np.int64)).to(dev)
        skey = (t * (levels + 1) + (levels - qq)) * n_docs + d
        perm = torch.sort(skey, stable=True).indices
        t, d, qq = t[perm], d[perm], qq[perm]
        w = torch.from_numpy(deq).to(dev)[perm]
        self.docs = d
        self.n_postings = int(d.numel())
        V1 = n_terms + 1

        # segments: runs of one (term, impact)
        brk = torch.ones(t.numel(), dtype=torch.bool, device=dev)
        brk[1:] = (t[1:] != t[:-1]) | (qq[1:] != qq[:-1])
        seg_start = torch.nonzero(brk).flatten()
        seg_end = torch.cat([seg_start[1:], torch.tensor([t.numel()], device=dev)])
        self.seg_start, self.seg_len = seg_start, seg_end - seg_start
        self.seg_w = w[seg_start]  # f32 dequantized impact
        seg_term = t[seg_start]
        self.term_seg_count = torch.bincount(seg_term, minlength=V1)
        self.term_seg_start = torch.cumsum(self.term_seg_count, 0) - self.term_seg_count

        # (term, doc block) lists: the block maxima and posting counts
        tb = t * self.n_blocks + d // block_size
        tb_sorted, tb_perm = torch.sort(tb, stable=True)
        tb_key, tb_inv, tb_cnt = torch.unique_consecutive(tb_sorted, return_inverse=True,
                                                          return_counts=True)
        self.tb_block = tb_key % self.n_blocks
        self.tb_count = tb_cnt
        self.tb_max = torch.zeros(tb_key.numel(), dtype=torch.float32, device=dev).scatter_reduce(
            0, tb_inv, w[tb_perm], "amax", include_self=False)
        self.term_bm_count = torch.bincount(tb_key // self.n_blocks, minlength=V1)
        self.term_bm_start = torch.cumsum(self.term_bm_count, 0) - self.term_bm_count
        doc_slots = torch.bincount(d, minlength=self.n_blocks * block_size)
        self.block_slots = doc_slots.view(self.n_blocks, block_size).sum(-1)

    # ------------------------------------------------------------------ queries

    def _live(self, terms, weights) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.as_tensor(np.asarray(terms), device=self.device).long().flatten()
        w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=self.device).flatten()
        live = (w > 0) & (t < self.n_terms)
        return t[live], w[live]

    def budget_counts(self, terms, weights, rho: int) -> tuple[int, int, int]:
        """``(postings admitted, segments admitted, live slots)`` at budget
        ``rho``: the plan of :meth:`search` without the scoring."""
        t, w = self._live(terms, weights)
        cnt = self.term_seg_count[t]
        seg = _ranges(self.term_seg_start[t], cnt)
        slot = torch.repeat_interleave(torch.arange(t.numel(), device=self.device), cnt)
        order = torch.sort(-(self.seg_w[seg] * w[slot]), stable=True).indices
        cum = torch.cumsum(self.seg_len[seg[order]], 0)
        total = int(cum[-1]) if cum.numel() else 0
        budget = min(int(rho), total)
        return budget, int((cum - self.seg_len[seg[order]] < budget).sum()), int(t.numel())

    def search(self, terms, weights, k: int, rho: Optional[int] = None,
               precision: torch.dtype = torch.float32) -> Answer:
        """One query (slots in the order sent) at posting budget ``rho``
        (``None``: every posting). ``precision`` is the system's float32, or
        the control's lower one."""
        t, w = self._live(terms, weights)
        cnt = self.term_seg_count[t]
        seg = _ranges(self.term_seg_start[t], cnt)
        slot = torch.repeat_interleave(torch.arange(t.numel(), device=self.device), cnt)
        contrib = self.seg_w[seg].to(precision) * w[slot].to(precision)
        order = torch.sort(-contrib.float(), stable=True).indices
        seg, contrib = seg[order], contrib[order]
        lens = self.seg_len[seg]
        cum = torch.cumsum(lens, 0)
        total = int(cum[-1]) if cum.numel() else 0
        budget = total if rho is None else min(int(rho), total)
        taken = torch.clamp(budget - (cum - lens), min=0)
        taken = torch.minimum(taken, lens)
        n_seg = int((taken > 0).sum())
        docs = self.docs[_ranges(self.seg_start[seg], taken)]
        acc_dtype = torch.float64 if precision == torch.float32 else precision
        vals = torch.repeat_interleave(contrib, taken).to(acc_dtype)
        acc = torch.zeros(self.n_docs, dtype=acc_dtype, device=self.device).index_add_(0, docs, vals)
        top = torch.sort(-acc.double(), stable=True).indices[:k]
        return Answer(ids=top.cpu().numpy(), scores=acc[top].double().cpu().numpy(), acc=acc,
                      processed=budget, segments=n_seg)

    # ------------------------------------------------------- DAAT's block work

    def block_work(self, terms, weights, blocks_scored: int) -> tuple[int, int, int]:
        """``(block-max entries, doc slots, matched slots)`` of a rank-safe
        block-max DAAT that scored ``blocks_scored`` blocks: the query terms'
        block-max lists, and the doc-major slots of the ``blocks_scored``
        blocks of highest bound (each trip scores the highest remaining
        bounds, so a rank-safe run's scored set is a prefix of that order)
        with those slots that hold a query term."""
        t, w = self._live(terms, weights)
        n_bm = self.term_bm_count[t]
        ent = _ranges(self.term_bm_start[t], n_bm)
        slot = torch.repeat_interleave(torch.arange(t.numel(), device=self.device), n_bm)
        blk = self.tb_block[ent]
        ub = torch.zeros(self.n_blocks, dtype=torch.float64, device=self.device).index_add_(
            0, blk, self.tb_max[ent].double() * w[slot].double())
        matched = torch.zeros(self.n_blocks, dtype=torch.int64, device=self.device).index_add_(
            0, blk, self.tb_count[ent])
        top = torch.sort(-ub, stable=True).indices[: max(int(blocks_scored), 0)]
        return int(n_bm.sum()), int(self.block_slots[top].sum()), int(matched[top].sum())
