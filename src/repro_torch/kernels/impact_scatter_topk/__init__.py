from repro_torch.kernels.impact_scatter_topk.ops import (  # noqa: F401
    impact_scatter_topk,
    impact_scatter_topk_batched,
)
