"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409]

The ViT frontend is a STUB per the assignment: batches carry precomputed
patch/text embeddings ([B, S, d_model]).  Attention dim = 32*128 = 4096
with a separate o_proj back to d_model=5120.
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000_000.0,
        mlp_kind="swiglu",
        input_mode="embeddings",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="pixtral-12b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=12,
        d_ff=96,
        vocab_size=128,
        mlp_kind="swiglu",
        input_mode="embeddings",
        dtype_name="float32",
        attn_block_kv=32,
    )
