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

Each subpackage holds ``ops.py`` (the wrapper, which launches the kernel
for CUDA tensors and counts launches) and ``ref.py`` (the plain PyTorch
version, which the wrapper runs for CPU tensors). The CUDA sources are in
``repro_torch/csrc/``; ``common.py`` builds them with ``nvcc`` at first use.
"""
