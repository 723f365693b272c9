"""Batch pipeline for training (LM / sparse encoder / recsys / GNN): the
port of ``repro.data.pipeline``.

Host-side numpy generators, drawing the reference's numbers in the
reference's order from the same seed, that yield tensors on the given
device (``cuda`` unless ``device="cpu"``). The encoder's triples come from
the concept-latent corpus (``repro_torch.data.synthetic``), so ranking
quality is learned, not scripted. All batch shapes are static; ``batches``
iterators are infinite. ``shard_batch`` places a batch on a mesh's
shardings.
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


def recsys_batches(cfg, batch: int, seed: int = 0, device=None) -> Iterator[dict]:
    """Synthetic recsys batches with a learnable preference signal."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        if cfg.kind == "dcn-v2":
            dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
            sparse = rng.integers(0, 1 << 30, (batch, cfg.table.n_slots)).astype(np.int32)
            y = (dense[:, 0] + (sparse[:, 0] % 7 == 0) > 0.5).astype(np.float32)
            b = {"dense": dense, "sparse": sparse, "label": y}
        elif cfg.kind == "din":
            hist = rng.integers(0, 1 << 30, (batch, cfg.seq_len)).astype(np.int32)
            mask = rng.random((batch, cfg.seq_len)) > 0.2
            tgt = np.where(
                rng.random(batch) < 0.5, hist[:, 0], rng.integers(0, 1 << 30, batch)
            ).astype(np.int32)
            y = (tgt == hist[:, 0]).astype(np.float32)
            b = {"hist": hist, "hist_mask": mask, "target": tgt, "label": y}
        elif cfg.kind == "sasrec":
            seq = rng.integers(0, 1 << 30, (batch, cfg.seq_len)).astype(np.int32)
            pos = np.roll(seq, -1, axis=1)
            neg = rng.integers(0, 1 << 30, (batch, cfg.seq_len)).astype(np.int32)
            b = {
                "seq": seq,
                "pos": pos,
                "neg": neg,
                "mask": np.ones((batch, cfg.seq_len), dtype=bool),
            }
        elif cfg.kind == "wide-deep":
            sparse = rng.integers(0, 1 << 30, (batch, cfg.table.n_slots)).astype(np.int32)
            y = ((sparse[:, 0] % 5 == 0) | (sparse[:, 1] % 3 == 0)).astype(np.float32)
            b = {"sparse": sparse, "label": y}
        else:
            raise ValueError(cfg.kind)
        yield {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def gnn_batches(cfg, n_nodes: int, n_edges: int, seed: int = 0, graph_readout_graphs: int = 0,
                device=None) -> Iterator[dict]:
    """Synthetic graph batches (fixed topology, fresh features per step)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    w_true = rng.normal(size=(cfg.d_feat, cfg.n_vars)).astype(np.float32) * 0.3
    src_t, dst_t = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    while True:
        feats = rng.normal(size=(n_nodes, cfg.d_feat)).astype(np.float32)
        node_targets = feats @ w_true + 0.05 * rng.normal(size=(n_nodes, cfg.n_vars)).astype(np.float32)
        b = {
            "node_feats": torch.as_tensor(feats, device=dev),
            "edge_src": src_t,
            "edge_dst": dst_t,
            "edge_feats": torch.as_tensor(
                rng.normal(size=(n_edges, cfg.d_edge_feat)).astype(np.float32), device=dev),
        }
        if graph_readout_graphs:
            gid = np.sort(rng.integers(0, graph_readout_graphs, n_nodes)).astype(np.int32)
            b["graph_ids"] = torch.as_tensor(gid, device=dev)
            b["targets"] = torch.as_tensor(
                rng.normal(size=(graph_readout_graphs, cfg.n_vars)).astype(np.float32), device=dev)
        else:
            b["targets"] = torch.as_tensor(node_targets, device=dev)
        yield b


def shard_batch(batch, mesh, shardings=None, group=None):
    """Place a host batch on the mesh's batch shardings (``batch_shardings``
    unless given): the list of every rank's batch of its blocks on the
    mesh's device, or this rank's over ``group``
    (``repro_torch.distributed.sharding.place_tree``)."""
    from repro_torch.distributed.sharding import batch_shardings, place_tree

    if shardings is None:
        shardings = batch_shardings(batch, mesh)
    return place_tree(batch, shardings, group)
