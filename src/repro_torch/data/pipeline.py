"""Batch pipeline for training the sparse encoder (and a token stream for
LM steps): the port of the part of ``repro.data.pipeline`` the encoder uses.

Host-side numpy generators, drawing the reference's numbers in the
reference's order from the same seed, that yield tensors on the given
device (``cuda`` unless ``device="cpu"``). The encoder's triples come from
the concept-latent corpus (``repro_torch.data.synthetic``), so ranking
quality is learned, not scripted. All batch shapes are static; ``batches``
iterators are infinite. The recsys and GNN batches and ``shard_batch`` are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import Corpus
from repro_torch.device import resolve_device


def lm_token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                     device=None) -> Iterator[dict]:
    """Zipf-distributed synthetic token stream with next-token labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** 1.1
    p /= p.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=p).astype(np.int32)
        yield {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
               "labels": torch.as_tensor(toks[:, 1:], device=dev)}


@dataclasses.dataclass
class TripleSampler:
    """(query, positive doc, negative doc) triples from the synthetic corpus.

    Tokens are surface term ids (the corpus vocabulary is the token space:
    no subword stage). Padded and masked to static lengths.
    """

    corpus: Corpus
    q_len: int = 16
    d_len: int = 64
    seed: int = 0
    device: Any = None  # where the batches go: cuda unless "cpu"

    def _pad(self, terms: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
        out = np.zeros(n, dtype=np.int32)
        mask = np.zeros(n, dtype=bool)
        t = terms[:n]
        out[: t.size] = t
        mask[: t.size] = True
        return out, mask

    def batches(self, batch: int) -> Iterator[dict]:
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        nq = self.corpus.n_queries
        while True:
            rows = {k: [] for k in ("query", "query_mask", "pos", "pos_mask", "neg", "neg_mask")}
            for _ in range(batch):
                qi = int(rng.integers(0, nq))
                d_pos = int(self.corpus.qrels[qi])
                d_neg = int(rng.integers(0, self.corpus.n_docs))
                while d_neg == d_pos:
                    d_neg = int(rng.integers(0, self.corpus.n_docs))
                q, qm = self._pad(self.corpus.query_terms[qi], self.q_len)
                dp, dpm = self._pad(self.corpus.doc(d_pos)[0], self.d_len)
                dn, dnm = self._pad(self.corpus.doc(d_neg)[0], self.d_len)
                for k, v in zip(rows, (q, qm, dp, dpm, dn, dnm)):
                    rows[k].append(v)
            yield {k: torch.as_tensor(np.stack(v), device=dev) for k, v in rows.items()}

    def doc_token_batches(self, batch: int) -> Iterator[tuple]:
        """All corpus docs in order (for corpus encoding), padded batches:
        (tokens, mask, number of real rows)."""
        dev = resolve_device(self.device)
        n = self.corpus.n_docs
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            toks = np.zeros((batch, self.d_len), dtype=np.int32)
            mask = np.zeros((batch, self.d_len), dtype=bool)
            for i, d in enumerate(range(lo, hi)):
                t, m = self._pad(self.corpus.doc(d)[0], self.d_len)
                toks[i], mask[i] = t, m
            yield torch.as_tensor(toks, device=dev), torch.as_tensor(mask, device=dev), hi - lo
