"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Dense-MoE hybrid: a dense d_ff=4864 MLP runs in parallel (residual) with
the 128-expert top-2 routed layer in every block.
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        mlp_kind="swiglu",
        num_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
        capacity_factor=1.25,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="arctic-480b-smoke",
        family="moe",
        num_layers=2,
        d_model=32,
        num_heads=4,
        num_kv_heads=2,
        head_dim=8,
        d_ff=48,
        vocab_size=128,
        mlp_kind="swiglu",
        num_experts=8,
        top_k=2,
        moe_d_ff=48,
        dense_residual=True,
        capacity_factor=4.0,  # = E/top_k: drop-free, so decode == prefill
        dtype_name="float32",
        attn_block_kv=32,
    )
