"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mlp_kind="swiglu",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen2-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=56,
        num_heads=4,
        num_kv_heads=2,
        head_dim=14,
        d_ff=112,
        vocab_size=256,
        qkv_bias=True,
        mlp_kind="swiglu",
        dtype_name="float32",
        attn_block_kv=32,
    )
