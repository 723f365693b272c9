"""Ranking and regularization losses of the learned-sparse encoder path:
the port of ``repro.train.losses``.

A pairwise loss between relevant and non-relevant passages (DeepImpact),
SPLADEv2's MarginMSE distillation, and the SPLADE FLOPS regularizer, the
"efficiency in the training objective" mechanism the paper's conclusion
calls for.
"""
from __future__ import annotations

import torch


def pairwise_hinge(pos_scores: torch.Tensor, neg_scores: torch.Tensor, margin: float = 1.0):
    """max(0, margin - (s+ - s-)), mean over the batch."""
    return torch.clamp(margin - (pos_scores - neg_scores), min=0.0).mean()


def pairwise_softmax(pos_scores: torch.Tensor, neg_scores: torch.Tensor):
    """Contrastive log-softmax over (pos, neg) pairs (DeepImpact-style)."""
    logits = torch.stack([pos_scores, neg_scores], dim=-1)
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()


def margin_mse(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    teacher_pos: torch.Tensor,
    teacher_neg: torch.Tensor,
):
    """SPLADEv2 distillation: match the teacher's score *margin*."""
    return torch.mean(((pos_scores - neg_scores) - (teacher_pos - teacher_neg)) ** 2)


def flops_regularizer(sparse_reps: torch.Tensor):
    """SPLADE FLOPS loss: sum_t (mean_d |w_{d,t}|)^2.

    Penalizes the expected number of operations a query term incurs: the
    posting-density term behind the paper's latency blow-up.
    ``sparse_reps: [B, V]`` non-negative term weights.
    """
    mean_act = torch.abs(sparse_reps).mean(dim=0)  # [V]
    return torch.sum(mean_act * mean_act)


def l1_regularizer(sparse_reps: torch.Tensor):
    return torch.abs(sparse_reps).sum(dim=-1).mean()
