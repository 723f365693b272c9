"""Fused DAAT phase-2 chunk step: select + score + merge in one launch."""
from repro_torch.kernels.chunk_step.ops import (  # noqa: F401
    chunk_step_batched,
    chunk_step_multi_batched,
)
