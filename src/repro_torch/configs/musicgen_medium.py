"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Modality frontend is a STUB per the assignment: batches carry precomputed
EnCodec frame embeddings ([B, S, d_model]); the backbone predicts codebook
tokens (vocab 2048).  Deviation noted in DESIGN.md: sinusoidal positions
replaced with RoPE (uniform positional mechanism across the zoo).
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        mlp_kind="gelu",
        input_mode="embeddings",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="musicgen-medium-smoke",
        family="audio",
        num_layers=2,
        d_model=48,
        num_heads=4,
        num_kv_heads=4,
        head_dim=12,
        d_ff=96,
        vocab_size=128,
        mlp_kind="gelu",
        input_mode="embeddings",
        dtype_name="float32",
        attn_block_kv=32,
    )
