"""A configuration's data from the seed: the corpus, its treatment, the
query pool. What the system under test and the reference both start from."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.data.synthetic import CorpusConfig, generate_corpus
from portbench.data.treatments import EncodedCollection, apply_treatment


def device_sort_ops(device: torch.device):
    """``(argsort, searchsorted)`` over host arrays, computed on ``device``.
    A stable sort's permutation is unique, so every device gives the same."""

    def argsort(keys: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(keys)).to(device)
        return torch.sort(t, stable=True).indices.cpu().numpy()

    def searchsorted(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
        s = torch.from_numpy(np.ascontiguousarray(sorted_keys)).to(device)
        v = torch.from_numpy(np.ascontiguousarray(q)).to(device)
        return torch.searchsorted(s, v).cpu().numpy()

    return argsort, searchsorted


@dataclasses.dataclass(frozen=True)
class Deployment:
    """Raw COO postings of one shard under one treatment, and the query pool."""

    n_docs: int
    enc: EncodedCollection

    @property
    def n_terms(self) -> int:
        return self.enc.n_terms

    @property
    def pool_size(self) -> int:
        return len(self.enc.query_terms)

    def padded_pool(self) -> tuple[np.ndarray, np.ndarray]:
        """The pool as ``[n, Lq_max]`` arrays, pad slots (term ``n_terms``,
        weight 0) behind each query's terms."""
        lq = max(t.size for t in self.enc.query_terms)
        qt = np.full((self.pool_size, lq), self.n_terms, dtype=np.int32)
        qw = np.zeros((self.pool_size, lq), dtype=np.float32)
        for i, (t, w) in enumerate(zip(self.enc.query_terms, self.enc.query_weights)):
            qt[i, : t.size], qw[i, : w.size] = t, w
        return qt, qw


def make_deployment(config: dict, seed: int, device: torch.device) -> Deployment:
    """The corpus named by ``config`` (its ``corpus`` sizes, ``n_docs`` and
    ``n_queries``) drawn from ``seed``, under its ``treatment``."""
    argsort, searchsorted = device_sort_ops(device)
    cfg = CorpusConfig(n_docs=int(config["n_docs"]), n_queries=int(config["n_queries"]),
                       seed=int(seed), **config["corpus"])
    corpus = generate_corpus(cfg, argsort=argsort)
    enc = apply_treatment(corpus, config["treatment"], seed=int(seed), argsort=argsort,
                          searchsorted=searchsorted)
    return Deployment(n_docs=cfg.n_docs, enc=enc)
