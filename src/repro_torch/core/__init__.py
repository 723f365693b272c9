"""Impact-quantized learned-sparse retrieval: the index, top-k, anytime SAAT
and the exhaustive oracle (ports of ``repro.core``).

    QuantConfig, quantize, dequantize     impact quantization
    ImpactIndex, build_impact_index       impact-ordered index on a device
    index_from_numpy                      a reference index's arrays -> ImpactIndex
    saat_search, exact_rho                anytime SAAT (rho posting budget)
    exhaustive_search                     rank-safe exhaustive disjunction
"""
from repro_torch.core.exhaustive import ExhaustiveResult, exhaustive_search, score_all_docs  # noqa: F401
from repro_torch.core.impact_index import (  # noqa: F401
    ARRAY_FIELDS,
    META_FIELDS,
    ImpactIndex,
    build_impact_index,
    extract_doc_coo,
    index_from_numpy,
    pad_queries,
    query_vector,
)
from repro_torch.core.quantization import (  # noqa: F401
    QuantConfig,
    accumulator_analysis,
    dequantize,
    quantization_error,
    quantize,
)
from repro_torch.core.saat import (  # noqa: F401
    SaatPlan,
    SaatResult,
    exact_rho,
    max_segments_per_term,
    saat_plan,
    saat_search,
)
from repro_torch.core.topk import merge_pools_by_id, merge_topk, tiled_topk, topk  # noqa: F401
