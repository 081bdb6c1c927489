"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=11008 vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        rope_theta=10_000.0,
        mlp_kind="swiglu",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_kind="swiglu",
        dtype_name="float32",
        attn_block_kv=32,
    )
