"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2*d_model = 5120, head_dim = 64 -> 80 SSD heads, ngroups = 1.
Sub-quadratic: runs the long_500k decode shape (O(1) state per token).
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        conv_width=4,
        ssd_chunk=256,
        sub_quadratic=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="mamba2-2.7b-smoke",
        family="ssm",
        num_layers=2,
        d_model=32,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=8,
        conv_width=4,
        ssd_chunk=16,
        sub_quadratic=True,
        dtype_name="float32",
    )
