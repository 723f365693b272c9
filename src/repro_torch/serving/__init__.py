"""Anytime serving on one device: deadline->rho control, batched streams,
Lq-bucketed batch shapes, the continuous-batching admission queue, and the
mutable-index lifecycle (tombstone-masked search, hot-swap compaction).
Ports of ``repro.serving``; sharded and pod serving are not ported yet."""
from repro_torch.serving.bucketing import (  # noqa: F401
    bucket_for,
    bucketize_batch,
    effective_lq,
    normalize_buckets,
    pad_to_width,
    sentinel_rows,
)
from repro_torch.serving.counters import CounterRegistry  # noqa: F401
from repro_torch.serving.lifecycle import (  # noqa: F401
    CompactionPolicy,
    Compactor,
    MutationEvent,
    replay_with_churn,
)
from repro_torch.serving.queue import (  # noqa: F401
    AdmissionQueue,
    Completion,
    FlushRecord,
    SurvivorPredictor,
    replay_arrivals,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    AnytimeServer,
    ServingConfig,
    index_static_signature,
    run_query_stream,
)
