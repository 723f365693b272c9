"""Retrieval models: BM25 and the paper's six corpus treatments (numpy).

Copies of ``repro.models.bm25`` and ``repro.models.treatments``: the same
seed gives array-equal COO postings and queries.
"""
from repro_torch.models.bm25 import BM25Params, bm25_weights  # noqa: F401
from repro_torch.models.treatments import (  # noqa: F401
    MODEL_NAMES,
    PROFILES,
    EncodedCollection,
    apply_treatment,
    encode_all,
)
