"""The five LM architectures, field for field the reference's
``repro.configs.lm_archs`` (sources noted per arch), and ``reduced_lm``,
the small variant of each that runs on a CPU."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def qwen2_72b() -> TransformerConfig:
    """[arXiv:2407.10671; hf] 80L d=8192 64H (GQA kv=8) ff=29568 V=152064, QKV bias."""
    return TransformerConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=29568, vocab=152064, qkv_bias=True,
        rope_theta=1e6, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        block_q=512,
    )


def qwen1_5_0_5b() -> TransformerConfig:
    """[hf:Qwen/Qwen1.5-0.5B] 24L d=1024 16H (kv=16) ff=2816 V=151936, QKV bias."""
    return TransformerConfig(
        name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=2816, vocab=151936, qkv_bias=True,
        rope_theta=1e4, dtype=torch.bfloat16, block_q=512,
    )


def llama3_2_3b() -> TransformerConfig:
    """[hf:meta-llama/Llama-3.2-3B] 28L d=3072 24H (GQA kv=8) ff=8192 V=128256."""
    return TransformerConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=128256, qkv_bias=False,
        rope_theta=5e5, dtype=torch.bfloat16, block_q=512,
    )


def deepseek_v3_671b() -> TransformerConfig:
    """[arXiv:2412.19437; hf] 61L d=7168 128H MLA, MoE 1 shared + 256 routed
    top-8 (ff=2048/expert), first 3 layers dense (ff=18432), MTP depth 1."""
    return TransformerConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
        attn="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        moe=MoEConfig(
            n_experts=256, top_k=8, d_ff=2048, n_shared=1,
            capacity_factor=1.25, router="sigmoid", impl="ep",
        ),
        moe_first_dense=3, mtp_depth=1, rope_theta=1e4,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, block_q=512,
    )


def moonshot_v1_16b_a3b() -> TransformerConfig:
    """[hf:moonshotai/Moonlight-16B-A3B] 48L d=2048 16H (kv=16), MoE 64
    routed top-6 (ff=1408) + shared, first layer dense (assignment config)."""
    return TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=5632, vocab=163840,
        moe=MoEConfig(
            n_experts=64, top_k=6, d_ff=1408, n_shared=2,
            capacity_factor=1.25, router="sigmoid", impl="ep",
        ),
        moe_first_dense=1, rope_theta=5e4, dtype=torch.bfloat16, block_q=512,
    )


def reduced_lm(full: TransformerConfig) -> TransformerConfig:
    """Same family at laptop scale: few layers, narrow, a tiny vocab,
    float32 compute (``param_dtype`` stays the full config's), a small MoE
    with scatter dispatch."""
    moe = full.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=8, top_k=min(moe.top_k, 2), d_ff=32,
            capacity_factor=4.0, impl="scatter",
        )
    return dataclasses.replace(
        full,
        n_layers=2 if full.moe is None else 3,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * full.n_kv_heads // full.n_heads),
        head_dim=16,
        d_ff=128,
        vocab=512,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        moe=moe,
        moe_first_dense=min(full.moe_first_dense, 1),
        dtype=torch.float32,
        block_q=None,
        remat=False,
    )
