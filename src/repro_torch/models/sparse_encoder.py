"""Trainable learned-sparse encoders: the port of ``repro.models.sparse_encoder``.

A transformer encoder (any ``LMConfig`` backbone with
``window_pattern=(-1,)``: bidirectional attention) plus a sparse head:

  * **splade**: MLM-head logits over the vocab (the head is the embedding
    matrix, one parameter for both uses), ``log1p(relu(.))``, max-pooled
    over positions -> [B, V]. Any vocab dim can activate: the learned
    expansion behind the paper's "wacky" weights.
  * **unicoil**: a scalar weight per input token, scattered (max) into the
    token's own vocab dim; no expansion.

Both reductions are maxima with ties (masked positions give zeros that tie
with positions whose logits are <= 0; repeated tokens in uniCOIL), and the
gradient of a tied maximum is split evenly among the tied entries, as
``jax.grad`` splits it: ``torch.amax`` and ``scatter_reduce(...,
reduce="amax", include_self=True)`` do so, ``torch.max(dim)`` would not.

Padding tokens take part in attention, as in the reference: the mask
applies only at the head.

Training: contrastive pairwise softmax over (query, pos, neg) triples plus
SPLADE's FLOPS regularizer (``repro_torch.train.losses``). Encoded corpora
feed ``repro_torch.core.build_impact_index``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.archs import layers
from repro_torch.archs.transformer import (
    LMConfig,
    Transformer,
    lm_hidden_states,
    model_device,
    lm_params_from_reference,
    lm_params_to_reference,
)
from repro_torch.train.losses import flops_regularizer, pairwise_softmax


@dataclasses.dataclass(frozen=True)
class SparseEncoderConfig:
    backbone: LMConfig  # window_pattern must be (-1,) (bidirectional)
    head: str = "splade"  # splade | unicoil
    flops_weight: float = 1e-3
    query_flops_weight: float = 3e-3  # SPLADEv2 regularizes queries harder

    def __post_init__(self):
        if not all(w == -1 for w in self.backbone.window_pattern):
            raise ValueError("sparse encoders need bidirectional attention: window_pattern=(-1,)")

    @property
    def vocab(self) -> int:
        return self.backbone.vocab


def encoder_backbone(d_model: int = 256, n_layers: int = 4, vocab: int = 4096, **kw) -> LMConfig:
    return LMConfig(
        name="sparse-encoder-backbone",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=max(4, d_model // 64),
        n_kv_heads=max(4, d_model // 64),
        d_head=min(64, d_model // 4),
        d_ff=4 * d_model,
        vocab=vocab,
        window_pattern=(-1,),
        tie_embeddings=True,
        dtype=torch.float32,
        **kw,
    )


class SparseEncoder(nn.Module):
    """The backbone ``Transformer`` and, for uniCOIL, the head ``head.w``
    ``[d_model, 1]``; SPLADE's head is the backbone's embedding."""

    def __init__(self, cfg: SparseEncoderConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.backbone = Transformer(cfg.backbone, gen, device)
        if cfg.head == "unicoil":
            self.head = nn.Module()
            self.head.w = nn.Parameter(layers.dense_init(gen, cfg.backbone.d_model, 1,
                                                         cfg.backbone.dtype, device=device))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self, tokens, mask, self.cfg)

    def reference_tree(self, named: dict) -> dict:
        """name -> tensor (the params, or a moment keyed as the params) ->
        the reference's param pytree."""
        return encoder_params_to_reference(named, self.cfg)

    def from_reference_tree(self, tree) -> dict:
        return encoder_params_from_reference(tree)


def init_encoder_params(gen: torch.Generator | None, cfg: SparseEncoderConfig,
                        device=None) -> SparseEncoder:
    """A ``SparseEncoder`` drawn from ``gen`` on the host and placed on
    ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``: shapes only, for an
    abstract train state)."""
    return SparseEncoder(cfg, gen, device)


def encoder_params_from_reference(tree) -> dict:
    """The reference's ``init_encoder_params`` pytree (numpy arrays) -> the
    port's ``state_dict``: the stacked ``[repeats, ...]`` leaves of
    ``tree["backbone"]["blocks"]`` un-stacked a layer each."""
    out = lm_params_from_reference(tree["backbone"], prefix="backbone.")
    if "head" in tree:
        out["head.w"] = torch.from_numpy(np.array(tree["head"]["w"]))
    return out


def encoder_params_to_reference(named: dict, cfg: SparseEncoderConfig) -> dict:
    """The inverse of ``encoder_params_from_reference``, for checkpoints."""
    tree = {"backbone": lm_params_to_reference(named, cfg.backbone, prefix="backbone.")}
    if cfg.head == "unicoil":
        tree["head"] = {"w": named["head.w"]}
    return tree


def encode(params: SparseEncoder, tokens: torch.Tensor, mask: torch.Tensor,
           cfg: SparseEncoderConfig) -> torch.Tensor:
    """Token ids [B, L] (+ bool mask) -> sparse reps [B, V] (non-negative)."""
    h, _ = lm_hidden_states(params.backbone, tokens, cfg.backbone)  # [B, L, D]
    m = mask[..., None].to(h.dtype)
    if cfg.head == "splade":
        w_mlm = params.backbone.embed.T  # [D, V] tied MLM head
        logits = (h @ w_mlm).float()  # [B, L, V]
        acts = torch.log1p(torch.relu(logits)) * m
        return torch.amax(acts, dim=1)  # max-pool over positions
    if cfg.head == "unicoil":
        w_tok = torch.relu((h @ params.head.w).float())[..., 0]  # [B, L]
        w_tok = w_tok * mask.float()
        reps = torch.zeros((tokens.shape[0], cfg.vocab), device=w_tok.device)
        return reps.scatter_reduce(1, tokens.long(), w_tok, reduce="amax", include_self=True)
    raise ValueError(cfg.head)


def score(rep_q: torch.Tensor, rep_d: torch.Tensor) -> torch.Tensor:
    """Eq. (1): inner product in vocab space. [B,V]x[B,V] -> [B]."""
    return torch.sum(rep_q * rep_d, dim=-1)


def encoder_loss(params: SparseEncoder, batch, cfg: SparseEncoderConfig):
    """Contrastive + FLOPS-regularized loss over (query, pos, neg) triples."""
    rq = encode(params, batch["query"], batch["query_mask"], cfg)
    rp = encode(params, batch["pos"], batch["pos_mask"], cfg)
    rn = encode(params, batch["neg"], batch["neg_mask"], cfg)
    s_pos = score(rq, rp)
    s_neg = score(rq, rn)
    rank = pairwise_softmax(s_pos, s_neg)
    reg = cfg.flops_weight * (flops_regularizer(rp) + flops_regularizer(rn))
    reg = reg + cfg.query_flops_weight * flops_regularizer(rq)
    loss = rank + reg
    with torch.no_grad():
        acc = (s_pos > s_neg).float().mean()
        nnz_d = (rp > 1e-6).sum(dim=-1).float().mean()
        nnz_q = (rq > 1e-6).sum(dim=-1).float().mean()
    return loss, {"rank_loss": rank.detach(), "flops_reg": reg.detach(), "pair_acc": acc,
                  "doc_nnz": nnz_d, "query_nnz": nnz_q}


@torch.no_grad()
def encode_corpus_to_coo(params: SparseEncoder, token_batches, mask_batches,
                         cfg: SparseEncoderConfig, threshold: float = 1e-4):
    """Encode a corpus into COO postings for ``build_impact_index``: the
    reference's arrays and dtypes (int64 doc and term ids, float64
    weights, and the number of rows encoded). The threshold and
    ``nonzero`` run on the params' device."""
    device = params.backbone.embed.device
    doc_idx, term_idx, weights = [], [], []
    base = 0
    for toks, mask in zip(token_batches, mask_batches):
        reps = encode(params, torch.as_tensor(toks, device=device),
                      torch.as_tensor(mask, device=device), cfg)
        d, t = torch.nonzero(reps > threshold, as_tuple=True)
        doc_idx.append((d + base).cpu().numpy())
        term_idx.append(t.cpu().numpy())
        weights.append(reps[d, t].cpu().numpy())
        base += reps.shape[0]
    return (
        np.concatenate(doc_idx),
        np.concatenate(term_idx),
        np.concatenate(weights).astype(np.float64),
        base,
    )
