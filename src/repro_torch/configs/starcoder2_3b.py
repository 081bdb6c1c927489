"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]

Deviation noted in DESIGN.md: StarCoder2 uses LayerNorm; we standardize on
RMSNorm across the zoo (same FLOP/byte profile).
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        qkv_bias=True,
        rope_theta=999_999.0,
        mlp_kind="gelu",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        head_dim=12,
        d_ff=96,
        vocab_size=256,
        qkv_bias=True,
        mlp_kind="gelu",
        dtype_name="float32",
        attn_block_kv=32,
    )
