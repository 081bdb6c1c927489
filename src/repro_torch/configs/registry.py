"""Architecture and input-shape registry, ported from ``repro/configs/registry.py``.

The ten architectures of the JAX package's registry (families dense,
moe, audio, vlm, ssm and hybrid) have their modules here, with the JAX
package's fields copied unchanged.  ``input_specs`` gives every step
input as a ``meta`` tensor (shapes and dtypes, no memory): what the
dry-run plans against.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.lm import LMConfig

_ARCH_MODULES = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def list_archs() -> list[str]:
    """The architectures this port can build."""
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choices: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> LMConfig:
    return _module(name).config().validate()


def get_smoke_config(name: str) -> LMConfig:
    return _module(name).smoke_config().validate()


def shape_applicable(cfg: LMConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable, reason-if-not).  long_500k needs sub-quadratic
    sequence mixing; pure full-attention archs skip it."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 512Ki-token dense KV decode is "
            "skip-eligible per the assignment"
        )
    return True, ""


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for the step function's batch argument: int32
    tokens and labels, or bf16 embeddings, as the JAX package's."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        s = 1

    def f(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if cfg.input_mode == "tokens":
        specs = {"tokens": f((b, s), torch.int32)}
    else:
        specs = {"embeddings": f((b, s, cfg.d_model), torch.bfloat16)}
    if shape.kind == "train":
        specs["labels"] = f((b, s), torch.int32)
    return specs
