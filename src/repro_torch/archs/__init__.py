"""Model code of the port: the transformer layers and stack that the sparse
encoders use (``repro.archs.layers`` and ``repro.archs.transformer``).
The GNN and recsys families are not ported yet."""
