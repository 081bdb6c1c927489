"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained,
first layer dense (d_ff 10944).  [arXiv:2401.06066; hf]"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        mlp_kind="swiglu",
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        first_k_dense=1,
        dense_d_ff=10944,
        capacity_factor=1.25,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        num_layers=3,
        d_model=32,
        num_heads=4,
        num_kv_heads=4,
        head_dim=8,
        d_ff=64,
        vocab_size=128,
        mlp_kind="swiglu",
        num_experts=8,
        top_k=2,
        num_shared_experts=1,
        moe_d_ff=16,
        first_k_dense=1,
        dense_d_ff=64,
        capacity_factor=4.0,  # = E/top_k: drop-free, so decode == prefill
        dtype_name="float32",
        attn_block_kv=32,
    )
