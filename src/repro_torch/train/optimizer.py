"""AdamW + LR schedule, ported from ``repro/train/optimizer.py``.

The state is ``{"m": tree, "v": tree, "step": int32 0-dim tensor}`` beside
a parameter tree of the same structure.  The step arithmetic (the bias
corrections ``b1**step``, the schedule, the clip scale) runs in f32
tensors on the parameters' device, as the reference computes it, never in
Python doubles.  ``moment_dtype`` drops the moments to bf16 for the
largest models.

Unlike the reference, whose arrays are immutable, ``adamw_update``
updates the parameters and the moments in place (full-width training
holds parameters, gradients and two moments at once, and a second copy of
each would not fit the card); it returns the same trees.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like: dict, leaves: list) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(tree):
        return {k: build(tree[k]) if isinstance(tree[k], dict) else next(it) for k in sorted(tree)}

    return build(like)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = _DTYPES[cfg.moment_dtype]
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros(p.shape, dtype=dt, device=p.device)
                                       for p in leaves])

    return {
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at ``total_steps``;
    ``step`` a tensor, the result an f32 tensor on its device."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clip(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' f32 sums of squares, leaf by leaf in
    ``tree_leaves`` order."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32).square()) for g in tree_leaves(tree)))


def clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """The factor the gradients are multiplied by: ``grad_clip / gnorm``,
    at most 1."""
    return torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)


def step_scalars(cfg: AdamWConfig, step: torch.Tensor) -> dict:
    """The f32 scalars of AdamW's update number ``step`` (the new step):
    ``lr`` and the bias corrections ``bc1``, ``bc2``."""
    return {"lr": lr_schedule(cfg, step),
            "bc1": 1.0 - torch.pow(cfg.beta1, step.to(torch.float32)),
            "bc2": 1.0 - torch.pow(cfg.beta2, step.to(torch.float32))}


@torch.no_grad()
def adamw_leaf(p, g, m, v, cfg: AdamWConfig, scale, lr, bc1, bc2) -> None:
    """One leaf's update, in place: ``p``, ``m`` and ``v`` (any block of
    a leaf: the arithmetic is elementwise, and the weight decay applies to
    leaves of two or more dims)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.to(torch.float32) * scale
    m32 = b1 * m.to(torch.float32) + (1 - b1) * g
    v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
    del g
    update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        update = update + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
    mdt = _DTYPES[cfg.moment_dtype]
    m.copy_(m32.to(mdt))
    v.copy_(v32.to(mdt))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """Returns (params, state, metrics): the given trees, updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    k = step_scalars(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        adamw_leaf(p, g, m, v, cfg, scale, k["lr"], k["bc1"], k["bc2"])
    state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": k["lr"]}
    return params, state, metrics
