"""Impact quantization (paper §3.2).

Score-at-a-time evaluation requires term weights quantized into small integer
*impact scores* organized into equal-impact segments.  The paper observes a
"wacky weights" consequence: learned sparse models generate weights whose
accumulated document scores overflow 16-bit accumulators (JASS had to move to
32-bit, a ~50% overhead on BM25).  This module provides the quantizers and the
overflow analysis used to reproduce that observation.

All quantizers map positive float weights to integers in ``[1, 2**bits - 1]``
(zero is reserved for "no posting").  ``dequantize`` maps back to the impact
midpoint so SAAT / DAAT / exhaustive evaluation all score in the same units.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, "torch.Tensor"]  # noqa: F821 - torch optional here


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration for impact quantization.

    Attributes:
      bits: width of the integer impact. The paper's systems use 8-bit impacts
        with 16/32-bit accumulators.
      scheme: ``uniform`` (linear in weight) or ``log`` (linear in log-weight,
        better for the heavy-tailed BM25-like distributions).
      per_term: if True, each term gets its own scale (max weight); otherwise a
        single global scale is used (JASS default, required so that impacts of
        different terms are comparable for segment ordering).
    """

    bits: int = 8
    scheme: str = "uniform"
    per_term: bool = False

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1


def _as_np(x) -> np.ndarray:
    return np.asarray(x)


def quantize(
    weights: ArrayLike,
    cfg: QuantConfig,
    max_weight: float | None = None,
) -> Tuple[np.ndarray, float]:
    """Quantize positive weights to integer impacts.

    Returns ``(impacts, scale)`` with ``impacts`` int32 in [0, levels] (0 only
    for non-positive input weights) and ``scale`` such that
    ``dequantize(impacts, scale) ~= weights``.
    """
    w = _as_np(weights).astype(np.float64)
    if max_weight is None:
        max_weight = float(w.max()) if w.size else 1.0
    max_weight = max(max_weight, 1e-12)
    levels = cfg.levels
    pos = w > 0
    if cfg.scheme == "uniform":
        q = np.ceil(np.clip(w / max_weight, 0.0, 1.0) * levels)
        scale = max_weight / levels
    elif cfg.scheme == "log":
        q = np.ceil(np.log1p(np.clip(w, 0.0, max_weight)) / np.log1p(max_weight) * levels)
        scale = max_weight / levels  # dequant for log scheme handled separately
    else:
        raise ValueError(f"unknown quantization scheme: {cfg.scheme!r}")
    q = np.where(pos, np.clip(q, 1, levels), 0).astype(np.int32)
    return q, float(scale)


def dequantize(impacts: ArrayLike, scale: float, cfg: QuantConfig | None = None) -> np.ndarray:
    """Map integer impacts back to float score contributions."""
    q = _as_np(impacts).astype(np.float64)
    if cfg is not None and cfg.scheme == "log":
        levels = cfg.levels
        max_weight = scale * levels
        return (np.expm1(q / levels * np.log1p(max_weight))).astype(np.float32)
    return (q * scale).astype(np.float32)


def quantization_error(weights: ArrayLike, cfg: QuantConfig) -> dict:
    """Round-trip error stats; uniform scheme error is bounded by one step."""
    w = _as_np(weights).astype(np.float64)
    q, scale = quantize(w, cfg)
    wd = dequantize(q, scale, cfg).astype(np.float64)
    err = np.abs(wd - w)[w > 0]
    step = scale
    return {
        "max_abs_err": float(err.max()) if err.size else 0.0,
        "mean_abs_err": float(err.mean()) if err.size else 0.0,
        "step": float(step),
        "bound_ok": bool(err.size == 0 or err.max() <= step + 1e-9),
    }


def accumulator_analysis(
    doc_impact_sums: ArrayLike,
    query_weight_max: float = 1.0,
    bits: int = 16,
) -> dict:
    """Reproduce the paper's 16-vs-32-bit accumulator overflow analysis.

    ``doc_impact_sums`` is the per-document sum of quantized impacts (the
    worst-case integer score when every document term matches the query with
    unit query weight).  With learned query weights the bound is multiplied by
    the max quantized query weight.  The paper: "32-bit accumulators were
    necessary ... as the learned sparse impacts and weights often result in
    scores exceeding 2^16 = 65,536".
    """
    sums = _as_np(doc_impact_sums).astype(np.float64) * float(query_weight_max)
    cap = float(1 << bits)
    frac = float((sums >= cap).mean()) if sums.size else 0.0
    return {
        "accumulator_bits": bits,
        "capacity": cap,
        "max_doc_score_bound": float(sums.max()) if sums.size else 0.0,
        "mean_doc_score_bound": float(sums.mean()) if sums.size else 0.0,
        "overflow_fraction": frac,
        "overflows": bool(sums.size and sums.max() >= cap),
    }
