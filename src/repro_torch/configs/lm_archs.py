"""The five assigned LM-family architectures (exact published configs): the
port of ``repro.configs.lm_archs``, with torch dtypes.

Execution knobs per shape (math-preserving):
  * ``train_4k``    attn_chunk=1024, vocab-chunked loss, full remat
  * ``prefill_32k`` attn_chunk=2048, sequence(context)-parallel over model
  * ``decode_32k``  dense one-token attention over the model-sharded cache
  * ``long_500k``   (gemma3 only) ring-buffer local layers + seq-sharded
                    global caches
``long_500k`` is SKIPPED for the four pure full-attention archs: a 512k KV
cache at every layer has no sub-quadratic structure to exploit (documented,
DESIGN.md §4). gemma3's 5:1 local:global interleave caps 5/6 of the layers at
the 1024-token window — that is its sub-quadratic structure.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.archs.layers import MoEConfig
from repro_torch.archs.transformer import LMConfig
from repro_torch.configs.base import ArchSpec, lm_cells

_LONG_SKIP = (
    "pure full-attention GQA arch: 512k KV at every layer has no sub-quadratic "
    "structure (no local:global interleave / SSM / linear attention) — skipped per "
    "assignment rules; see DESIGN.md §4"
)


# models under this size use the DP-dominant (ZeRO-3) layout for training.
# Measured §Perf: TP=16 activation all-reduces cost ~30x compute for a ~1B
# model and ~20x for yi-34b at 1M tokens/step — with a per-chip batch this
# large, FSDP weight-gathers + grad reduce beat TP for EVERY assigned LM, so
# the threshold covers all five (TP remains the decode/serving layout).
DP_LAYOUT_MAX_PARAMS = 1e11


def _shape_knobs(cfg: LMConfig, shape: str) -> LMConfig:
    dp = cfg.n_params() < DP_LAYOUT_MAX_PARAMS
    if shape == "train_4k":
        return dataclasses.replace(cfg, attn_chunk=1024, remat="full", dp_layout=dp)
    if shape == "prefill_32k":
        return dataclasses.replace(cfg, attn_chunk=2048, remat="none", seq_shard=True)
    if shape in ("decode_32k", "long_500k"):
        return dataclasses.replace(cfg, attn_chunk=0, remat="none")
    return cfg


def _smoke(cfg: LMConfig) -> LMConfig:
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=2, d_expert_ff=32)
    return dataclasses.replace(
        cfg,
        n_layers=max(2, len(cfg.window_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=16,
        d_ff=128,
        vocab=512,
        moe=moe,
        dtype=torch.float32,
        vocab_chunk=0,
        attn_chunk=0,
        remat="none",
    )


def _spec(cfg: LMConfig, source: str, long_ok: bool = False) -> ArchSpec:
    return ArchSpec(
        arch_id=cfg.name,
        family="lm",
        source=source,
        config_for=lambda shape, _c=cfg: _shape_knobs(_c, shape),
        smoke_config=lambda _c=cfg: _smoke(_c),
        cells=lm_cells(long_ok=long_ok, long_skip_reason=_LONG_SKIP),
    )


MINITRON_4B = LMConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=9216,
    vocab=256000,
    tie_embeddings=False,
    vocab_chunk=256,
)

YI_34B = LMConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    tie_embeddings=False,
    rope_theta=5_000_000.0,
    vocab_chunk=256,
)

GEMMA3_1B = LMConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab=262144,
    tie_embeddings=True,
    # 5 local (sliding-window 1024) : 1 global, cycled; 26 = 4*6 + 2
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    rope_theta=1_000_000.0,
    vocab_chunk=256,
)

GRANITE_MOE = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert_ff=512),
    vocab_chunk=256,
)

MOONSHOT_16B = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=163840,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408),
    vocab_chunk=256,
)

SPECS = {
    "minitron-4b": _spec(MINITRON_4B, "arXiv:2407.14679; hf"),
    "yi-34b": _spec(YI_34B, "arXiv:2403.04652; hf"),
    "gemma3-1b": _spec(GEMMA3_1B, "hf:google/gemma-3-1b-pt; unverified", long_ok=True),
    "granite-moe-3b-a800m": _spec(GRANITE_MOE, "hf:ibm-granite/granite-3.0-1b-a400m-base; hf"),
    "moonshot-v1-16b-a3b": _spec(MOONSHOT_16B, "hf:moonshotai/Moonlight-16B-A3B; hf"),
}
