"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2:1
(recurrent, recurrent, attention).  [arXiv:2402.19427]

38 layers = 12 (rglru, rglru, local-attn) superblocks + 2 trailing rglru.
Sub-quadratic: the local window (2048) bounds attention state, so the
long_500k decode shape runs.
"""

from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        window=2048,
        d_rnn=4096,
        conv_width=4,
        sub_quadratic=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=5,  # 1 superblock + 2 tail rglru
        d_model=32,
        num_heads=4,
        num_kv_heads=1,
        head_dim=8,
        d_ff=64,
        vocab_size=128,
        window=16,
        d_rnn=32,
        conv_width=4,
        sub_quadratic=True,
        dtype_name="float32",
        attn_block_kv=16,
    )
