"""Sparse-encoder driver: ``python -m repro_torch.launch.train_encoder [...]``.

The port of ``examples/train_sparse_encoder.py``, with the same flags plus
``--device``: it trains on the GPU (``cuda``, the default) and raises when
there is none, unless ``--device cpu`` asks for the plain PyTorch path on
the host. ``--docs`` and ``--queries`` (default: the example's 2,000 and
150) shrink the corpus for a quick check: an encoder trained for a few
steps is still dense, and its index holds about 2,400 postings a doc.

It closes the paper's loop: gradient descent on the FLOPS-regularized
contrastive objective, then the trained encoder encodes the corpus and the
queries, the impact index is built from its postings, and exact SAAT
search is scored (RR@10) against BM25 on the same corpus.
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import build_impact_index, exact_rho, pad_queries, saat_search
from repro_torch.core.saat import max_segments_per_term
from repro_torch.data.pipeline import TripleSampler
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.device import resolve_device
from repro_torch.metrics.ir_metrics import mrr_at_k
from repro_torch.models.sparse_encoder import (
    SparseEncoderConfig,
    encode,
    encode_corpus_to_coo,
    encoder_backbone,
    encoder_loss,
    init_encoder_params,
)
from repro_torch.models.treatments import apply_treatment
from repro_torch.train import AdamWConfig, init_train_state, make_train_step, train_loop


def main(argv=None) -> dict:
    """Runs the loop and prints the example's report. Returns the trained
    state, the training history, both indexes with their padded queries,
    and RR@10 of each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--flops-weight", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--docs", type=int, default=2000, help="a smaller corpus for a quick check")
    ap.add_argument("--queries", type=int, default=150)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    corpus = generate_corpus(
        CorpusConfig(n_docs=args.docs, n_queries=args.queries, n_concepts=150, seed=5))
    cfg = SparseEncoderConfig(
        backbone=encoder_backbone(d_model=128, n_layers=3, vocab=corpus.config.n_surface_terms),
        flops_weight=args.flops_weight,
        query_flops_weight=args.flops_weight * 3,
    )
    params = init_encoder_params(torch.Generator().manual_seed(0), cfg, device=device)
    print(f"encoder params: {sum(p.numel() for p in params.parameters()):,}")

    sampler = TripleSampler(corpus, q_len=12, d_len=48, device=device)
    step = make_train_step(
        lambda p, b: encoder_loss(p, b, cfg),
        AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps),
    )
    hooks = []
    cm = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    if cm:
        hooks.append(cm.every_n_steps_hook(100))
    state, hist = train_loop(
        step,
        init_train_state(params),
        itertools.islice(sampler.batches(args.batch), args.steps),
        hooks=hooks,
    )
    if cm:
        cm.wait()
    print(
        f"training: rank_loss {hist[0]['rank_loss']:.3f} -> {hist[-1]['rank_loss']:.3f}, "
        f"pair_acc {hist[0]['pair_acc']:.2f} -> {hist[-1]['pair_acc']:.2f}, "
        f"doc_nnz {hist[-1]['doc_nnz']:.0f}, query_nnz {hist[-1]['query_nnz']:.0f}"
    )

    print("encoding corpus + building impact index ...")
    toks, masks = [], []
    for t, m, _ in sampler.doc_token_batches(64):
        toks.append(t)
        masks.append(m)
    d, t, w, n = encode_corpus_to_coo(state.params, toks, masks, cfg)
    d_keep = d < corpus.n_docs  # drop padded batch rows
    idx = build_impact_index(d[d_keep], t[d_keep], w[d_keep], corpus.n_docs, cfg.vocab,
                             device=device)

    # encode the queries with the trained model
    q_terms, q_weights = [], []
    with torch.no_grad():
        for qi in range(corpus.n_queries):
            qt_pad, qm = sampler._pad(corpus.query_terms[qi], 12)
            rep = encode(state.params, torch.as_tensor(qt_pad[None], device=device),
                         torch.as_tensor(qm[None], device=device), cfg)[0].cpu().numpy()
            nz = np.nonzero(rep > 1e-4)[0]
            q_terms.append(nz.astype(np.int32))
            q_weights.append(rep[nz].astype(np.float32))
    max_q = max(max(len(x) for x in q_terms), 1)
    qt, qw = pad_queries(q_terms, q_weights, max_q, cfg.vocab)
    qt, qw = torch.as_tensor(qt, device=device), torch.as_tensor(qw, device=device)

    res = saat_search(
        idx, qt, qw, k=10, rho=exact_rho(idx), max_segs_per_term=max_segments_per_term(idx),
    )
    mrr_learned = mrr_at_k(res.doc_ids.cpu().numpy(), corpus.qrels, 10)

    # BM25 reference on the same corpus
    enc_bm = apply_treatment(corpus, "bm25")
    idx_bm = build_impact_index(
        enc_bm.doc_idx, enc_bm.term_idx, enc_bm.weights, corpus.n_docs, enc_bm.n_terms,
        device=device,
    )
    mq = max(len(x) for x in enc_bm.query_terms)
    qtb, qwb = pad_queries(enc_bm.query_terms, enc_bm.query_weights, mq, enc_bm.n_terms)
    res_bm = saat_search(
        idx_bm, qtb, qwb, k=10, rho=exact_rho(idx_bm),
        max_segs_per_term=max_segments_per_term(idx_bm),
    )
    mrr_bm = mrr_at_k(res_bm.doc_ids.cpu().numpy(), corpus.qrels, 10)
    print(f"RR@10: trained sparse encoder = {mrr_learned:.3f} | bm25 = {mrr_bm:.3f}")
    print(f"index postings: learned = {idx.n_postings:,} | bm25 = {idx_bm.n_postings:,} "
          f"(FLOPS regularizer controls this knob)")
    return {"state": state, "history": hist, "cfg": cfg, "index": idx, "q_terms": qt,
            "q_weights": qw, "bm25_index": idx_bm, "rr_learned": mrr_learned, "rr_bm25": mrr_bm,
            "qrels": np.asarray(corpus.qrels), "n_encoded": n}


if __name__ == "__main__":
    main()
