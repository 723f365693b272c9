"""Impact-quantized learned-sparse retrieval: the index, top-k, anytime SAAT,
block-max DAAT and the exhaustive oracle (ports of ``repro.core``).

    QuantConfig, quantize, dequantize     impact quantization
    ImpactIndex, build_impact_index       impact-ordered index on a device
    index_from_numpy                      a reference index's arrays -> ImpactIndex
    saat_search, exact_rho                anytime SAAT (rho posting budget)
    saat_search_vmap                      per-query SAAT, the parity oracle
    daat_search_batched                   block-max DAAT (plain, split, fused, multi-trip)
    daat_search_vmap / blockmax_search    per-query DAAT, the parity oracle
    exhaustive_search                     rank-safe exhaustive disjunction
    IndexHandle, search_delta_pool        mutable lifecycle (delta, tombstones, compaction)
    canonical_topk_merge                  the cross-rank k-merge (ties to the lowest doc id)
    wacky.*                               weight-wackiness analysers
    OperatingPoint, pareto_frontier       effectiveness/latency frontier

``index_handle`` builds on the engines (it imports ``daat`` and ``saat``
from this package), so it is imported after them.
"""
from repro_torch.core.daat import (  # noqa: F401
    DaatPlan,
    DaatResult,
    WorkStats,
    block_upper_bounds,
    blockmax_search,
    csr_blockmax_offsets,
    daat_plan,
    daat_search_batched,
    daat_search_vmap,
    max_blocks_per_term,
    query_vectors,
    score_blocks,
)
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
    saat_search_vmap,
)
from repro_torch.core.topk import (  # noqa: F401
    canonical_topk_merge,
    merge_pools_by_id,
    merge_topk,
    sharded_topk_merge,
    tiled_topk,
    topk,
)
from repro_torch.core.index_handle import (  # noqa: F401
    HandleResult,
    IndexHandle,
    search_delta_pool,
)
from repro_torch.core import wacky  # noqa: F401
from repro_torch.core.pareto import OperatingPoint, frontier_table, pareto_frontier  # noqa: F401
