"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

  impact_scatter       SAAT accumulation: per-block sorted segment sums
  impact_scatter_topk  fused SAAT scatter and per-block top-k (the
                       accumulator stays on chip; only [B, n_blocks, k]
                       candidates reach device memory)
  block_prune_csr      DAAT phase 0: block upper bounds off the CSR
                       block-max lists
  block_topk           per-tile top-k (stage 1 of the exact two-stage top-k)
  sparse_score         match-and-accumulate scoring of gathered doc rows
  chunk_step           the fused DAAT phase-2 trip (select, score, merge),
                       one trip or up to N trips per launch
  block_prune          the dense block bound and prune over [B, Lq, NB]
                       block maxima: block_prune_csr's oracle

Each subpackage holds ``ops.py`` (the wrapper, which launches the kernel
for CUDA tensors and counts launches) and ``ref.py`` (the plain PyTorch
version, which the wrapper runs for CPU tensors). The CUDA sources are in
``repro_torch/csrc/``; ``common.py`` builds them with ``nvcc`` at first use.

The package re-exports the wrappers, as the reference's does. The name
``impact_scatter`` (and ``block_prune``, ``block_topk``, ...) then binds
the function, not the subpackage: import a kernel's modules as
``from repro_torch.kernels.impact_scatter import ops``, which resolves
through ``sys.modules``, never by an attribute path such as
``repro_torch.kernels.impact_scatter.ops``.
"""
from repro_torch.kernels.block_prune import block_prune, block_prune_batched  # noqa: F401
from repro_torch.kernels.block_prune_csr import block_prune_csr_batched  # noqa: F401
from repro_torch.kernels.block_topk import block_topk, block_topk_batched  # noqa: F401
from repro_torch.kernels.chunk_step import (  # noqa: F401
    chunk_step_batched,
    chunk_step_multi_batched,
)
from repro_torch.kernels.impact_scatter import impact_scatter, impact_scatter_batched  # noqa: F401
from repro_torch.kernels.impact_scatter_topk import (  # noqa: F401
    impact_scatter_topk,
    impact_scatter_topk_batched,
)
from repro_torch.kernels.sparse_score import sparse_score, sparse_score_batched  # noqa: F401
