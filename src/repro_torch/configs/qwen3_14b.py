"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        mlp_kind="swiglu",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        mlp_kind="swiglu",
        dtype_name="float32",
        attn_block_kv=32,
    )
