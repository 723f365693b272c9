"""Model code of the port (``repro.archs``): the transformer LMs (dense,
MoE, GQA, local-global; KV cache, prefill and decode) and the sparse
encoders' backbone, the GraphCast-style GNN, and the four recsys models.

The arch registry lives in ``repro_torch.configs``; this package holds the
model code itself.
"""
