"""Step builders, ported from ``repro/train/step.py``.

``make_train_step`` maps ``(state, batch)`` to ``(state, metrics)`` with
``state = {"params", "opt"}``, as the reference's does: the loss and its
gradients (autograd through ``lm_loss``, whose K3, K4 and K5 calls run
their backward kernels on the card; like the reference's, the loss adds
no MoE auxiliary loss), then AdamW.  The parameters and the
optimizer state are updated in place (``train/optimizer.py``).
``make_serve_prefill`` and ``make_serve_step`` close over a config and
take the batch dict the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import (
    LMConfig,
    decode_step,
    init_cache,
    init_params,
    lm_loss,
    params_from_numpy,
    prefill,
)
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_unflatten,
)


def loss_and_grads(params: dict, cfg: LMConfig, batch: dict) -> tuple:
    """``lm_loss`` and its gradients (a tree like ``params``), by autograd."""
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = lm_loss(tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig):
    """(state, batch) -> (state, metrics); metrics hold ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim f32 tensors on the card."""

    def train_step(state, batch):
        loss, grads = loss_and_grads(state["params"], cfg, batch)
        params, opt, metrics = adamw_update(state["params"], grads, state["opt"], opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(cfg: LMConfig, opt_cfg: AdamWConfig, seed: int = 0, device=None) -> dict:
    """Random parameters (``init_params``) and zero moments on ``device``
    (default CUDA; ``RuntimeError`` without it)."""
    params = init_params(cfg, seed, device)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def abstract_train_state(cfg: LMConfig, opt_cfg: AdamWConfig) -> dict:
    """The train state's shapes and dtypes, on the ``"meta"`` device (no
    memory): what ``CheckpointManager.restore`` reads of its ``like``."""
    return init_train_state(cfg, opt_cfg, device="meta")


def abstract_params(cfg: LMConfig) -> dict:
    """The parameters' shapes and dtypes on ``meta`` (no memory)."""
    return init_params(cfg, device="meta")


def abstract_cache(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The decode cache's shapes and dtypes on ``meta`` (no memory); its
    ``length`` is a Python int, where the JAX package's is an int32 array."""
    return init_cache(cfg, batch, max_len, device="meta")


def train_state_from_numpy(cfg: LMConfig, tree: dict, device=None) -> dict:
    """The port's train state from the JAX package's, given as a tree of
    numpy arrays (``jax.tree.map(np.asarray, state)``): the parameters,
    both moments and the step."""
    device = resolve_device(device)
    opt = tree["opt"]
    return {
        "params": params_from_numpy(cfg, tree["params"], device),
        "opt": {
            "m": params_from_numpy(cfg, opt["m"], device),
            "v": params_from_numpy(cfg, opt["v"], device),
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=device),
        },
    }


def make_serve_prefill(cfg: LMConfig):
    def serve_prefill(params, batch):
        inputs = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeddings"]
        return prefill(params, cfg, inputs)

    return serve_prefill


def make_serve_step(cfg: LMConfig):
    def serve_step(params, cache, batch):
        inputs = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeddings"]
        return decode_step(params, cfg, cache, inputs)

    return serve_step
