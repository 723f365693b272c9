"""Distribution layer: sharding rules, collectives, elastic/fault tolerance
(the port of ``repro.distributed``)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    CompressionConfig,
    compress_decompress,
    compressed_psum,
    dequantize_int8,
    make_error_feedback_transform,
    quantize_int8,
    reduce_scatter_grads,
)
from repro_torch.distributed.elastic import (  # noqa: F401
    MeshTopology,
    best_effort_mesh,
    data_parallel_liveness,
    reshard_state,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    Axes,
    Mesh,
    NamedSharding,
    PartitionSpec,
    batch_dim_sharding,
    batch_shardings,
    cache_shardings,
    constraint,
    fully_sharded_dim,
    make_mesh,
    mesh_axes,
    param_shardings,
    param_specs,
    train_state_shardings,
    use_mesh,
)
