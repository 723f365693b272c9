"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the layout of the JAX package, which stays the reference:

    repro_torch.data      synthetic vocabulary-mismatch corpus and graphs
                          (numpy), and the training batch pipelines
    repro_torch.models    BM25 and the corpus treatments (numpy), and the
                          trainable sparse encoders
    repro_torch.metrics   IR effectiveness metrics and latency statistics
    repro_torch.core      impact index, top-k, anytime SAAT, block-max DAAT,
                          the mutable index handle, exhaustive oracle
    repro_torch.kernels   hand-written CUDA kernels (``csrc/``) and their
                          plain PyTorch versions
    repro_torch.serving   the anytime server, admission queue, index lifecycle,
                          sharded and pod serving
    repro_torch.archs     the LM transformers (MoE, KV cache), the GNN, the
                          recsys models, and the encoders' layers
    repro_torch.configs   the arch registry: 10 published configs, 40 cells
    repro_torch.train     losses, the from-scratch AdamW, the trainer
    repro_torch.checkpoint  atomic, sharded, async checkpoints
    repro_torch.launch    the serving CLI (``python -m repro_torch.launch.serve``),
                          the encoder's (``... .launch.train_encoder``) and the
                          arch trainer (``... .launch.train --arch <id>``)

The package imports torch and numpy, never JAX and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
