"""Anytime serving: deadline->rho control, batched streams, doc sharding
over a mesh of ranks (in one process or over a ``torch.distributed`` process
group) with the pod front end, Lq-bucketed batch shapes, the
continuous-batching admission queue, and the mutable-index lifecycle
(tombstone-masked search, hot-swap compaction). Ports of ``repro.serving``."""
from repro_torch.serving.bucketing import (  # noqa: F401
    bucket_for,
    bucketize_batch,
    effective_lq,
    normalize_buckets,
    pad_to_width,
    sentinel_rows,
)
from repro_torch.serving.counters import CounterRegistry  # noqa: F401
from repro_torch.serving.pod import (  # noqa: F401
    PodFrontEnd,
    PodResult,
    PodServer,
    pod_hosts,
    warmup_pod,
)
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
from repro_torch.serving.sharded import (  # noqa: F401
    abstract_stacked_index,
    make_bucketed_serve_step,
    make_pod_serve_step,
    make_sharded_serve_step,
    rank_block,
    shard_corpus,
    shard_live_stack,
    stack_indexes,
)
