"""Decoder-LM stack, ported from ``repro/models/lm.py``.

One ``LMConfig`` describes every family of the JAX package; this port
carries the serving path and the loss (``lm_loss``, what training
differentiates) of all six:

  dense / audio / vlm : GQA attention (K3 in prefill) + MLP blocks
  moe                 : GQA attention + routed-expert blocks
                        (``models/moe.py``), optional leading dense blocks
                        (deepseek) and a parallel dense residual (arctic)
  ssm                 : Mamba-2 SSD blocks (K4 in prefill and training)
  hybrid              : Griffin superblocks (rglru, rglru, local-attn) +
                        rglru tail (K6 in every RG-LRU layer, K3 with a
                        sliding window in every attention layer)

and every norm runs K5.

Parameters are dicts of tensors stacked per layer as the JAX package
stacks them; the JAX ``lax.scan`` over layers is a Python loop over the
stacked tensors.  ``remat`` applies when autograd records the forward:
each block then runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), and has no meaning when serving.  ``decode_step``
writes the new token's KV entries and recurrent states into the cache it
is given, in place, and returns that cache: the JAX engine donates the
cache to the same effect.  The cache's ``length`` is a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.annotate import constrain, constrain_attn_out, constrain_qkv
from repro_torch.models import layers as ll
from repro_torch.models import mamba as mb
from repro_torch.models import rglru as rg
from repro_torch.models.moe import init_moe, moe_forward

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the kernels' types
_ATTN_FAMILIES = ("dense", "audio", "vlm")
_KV_FAMILIES = _ATTN_FAMILIES + ("moe",)  # a KV cache per layer


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_kind: str = "swiglu"
    # --- moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with experts
    first_k_dense: int = 0  # deepseek-moe: leading dense layers
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 256
    # --- hybrid (recurrentgemma)
    window: int = 0  # local-attention window
    d_rnn: int = 0
    # --- modality / numerics
    input_mode: str = "tokens"  # tokens | embeddings
    dtype_name: str = "bfloat16"
    remat: bool = True
    sub_quadratic: bool = False  # can run long_500k decode
    attn_block_kv: int = 4096

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_name]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def validate(self) -> "LMConfig":
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.family != "ssm" and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: {self.num_heads} heads, {self.num_kv_heads} kv heads")
        if self.family == "moe" and not (self.num_experts > 0 and self.top_k > 0):
            raise ValueError(f"{self.name}: moe needs experts and top_k")
        if self.family == "hybrid" and not (self.window > 0 and self.d_rnn > 0):
            raise ValueError(f"{self.name}: hybrid needs window and d_rnn")
        if self.family in ("audio", "vlm") and self.input_mode != "embeddings":
            raise ValueError(f"{self.name}: {self.family} takes embeddings")
        if self.dtype_name not in _DTYPES:
            raise ValueError(f"{self.name}: unsupported dtype {self.dtype_name!r}")
        return self


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _stack(init_fn, n: int) -> dict:
    """``n`` layers of ``init_fn()`` stacked on a leading axis, filled one
    layer at a time so no list of per-layer copies is ever held."""
    first = init_fn()
    stacked = _tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device), first)
    _tree_zip(lambda dst, src: dst[0].copy_(src), stacked, first)
    del first
    for i in range(1, n):
        _tree_zip(lambda dst, src, i=i: dst[i].copy_(src), stacked, init_fn())
    return stacked


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) out of a stacked tree."""
    return _tree_map(lambda t: t[i], stacked)


def _init_attn(gen, cfg: LMConfig, device) -> dict:
    dt = cfg.dtype
    p = {
        "wq": ll.dense_init(gen, cfg.d_model, cfg.q_dim, dt, device),
        "wk": ll.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device),
        "wv": ll.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device),
        "wo": ll.dense_init(gen, cfg.q_dim, cfg.d_model, dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros((cfg.head_dim,), dtype=dt, device=device)
    return p


def _init_dense_block(gen, cfg: LMConfig, device, d_ff: int) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)  # noqa: E731
    return {
        "ln1": zeros(),
        "attn": _init_attn(gen, cfg, device),
        "ln2": zeros(),
        "mlp": ll.init_mlp(gen, cfg.d_model, d_ff, cfg.mlp_kind, cfg.dtype, device),
    }


def _init_moe_block(gen, cfg: LMConfig, device) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)  # noqa: E731
    p = {
        "ln1": zeros(),
        "attn": _init_attn(gen, cfg, device),
        "ln2": zeros(),
        "moe": init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts, cfg.dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = ll.init_mlp(gen, cfg.d_model, cfg.num_shared_experts * cfg.moe_d_ff,
                                  cfg.mlp_kind, cfg.dtype, device)
    if cfg.dense_residual:
        p["residual"] = ll.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.dtype, device)
    return p


def _init_mamba_layer(gen, cfg: LMConfig, device) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "mixer": mb.init_mamba_block(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_width,
            cfg.dtype, device,
        ),
    }


def _init_rglru_layer(gen, cfg: LMConfig, device) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)  # noqa: E731
    return {
        "ln1": zeros(),
        "mixer": rg.init_rglru_block(gen, cfg.d_model, cfg.d_rnn, cfg.conv_width, cfg.dtype,
                                     device),
        "ln2": zeros(),
        "mlp": ll.init_mlp(gen, cfg.d_model, cfg.d_ff, "geglu", cfg.dtype, device),
    }


def _init_hybrid_attn_layer(gen, cfg: LMConfig, device) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)  # noqa: E731
    return {
        "ln1": zeros(),
        "attn": _init_attn(gen, cfg, device),
        "ln2": zeros(),
        "mlp": ll.init_mlp(gen, cfg.d_model, cfg.d_ff, "geglu", cfg.dtype, device),
    }


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's distributions, drawn from a
    ``torch.Generator`` seeded by ``seed`` directly on ``device`` (default
    CUDA), tensor by tensor, so full-size models never pass through the
    host.  The numbers differ from ``jax.random``'s; ``params_from_numpy``
    carries the JAX package's own parameters over.  On ``"meta"`` it
    draws nothing and returns the shapes and dtypes alone."""
    cfg.validate()
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "lm_head": ll.dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype, device),
    }
    if cfg.input_mode == "tokens":
        params["embed"] = ll.embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype, device)
    if cfg.family in _ATTN_FAMILIES:
        params["blocks"] = _stack(lambda: _init_dense_block(gen, cfg, device, cfg.d_ff),
                                  cfg.num_layers)
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            d_ff = cfg.dense_d_ff or cfg.d_ff
            params["dense_blocks"] = _stack(lambda: _init_dense_block(gen, cfg, device, d_ff),
                                            cfg.first_k_dense)
        params["moe_blocks"] = _stack(lambda: _init_moe_block(gen, cfg, device),
                                      cfg.num_layers - cfg.first_k_dense)
    elif cfg.family == "hybrid":
        n_super, tail = divmod(cfg.num_layers, 3)
        params["super"] = _stack(lambda: {"r1": _init_rglru_layer(gen, cfg, device),
                                          "r2": _init_rglru_layer(gen, cfg, device),
                                          "attn": _init_hybrid_attn_layer(gen, cfg, device)},
                                 n_super)
        if tail:
            params["tail"] = _stack(lambda: _init_rglru_layer(gen, cfg, device), tail)
    else:
        params["blocks"] = _stack(lambda: _init_mamba_layer(gen, cfg, device), cfg.num_layers)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(cfg: LMConfig, tree: dict, device=None) -> dict:
    """The port's parameters from the JAX package's, given as a tree of
    numpy arrays (``jax.tree.map(np.asarray, repro.models.lm.init_params(cfg, key))``).
    The layouts are the same, so only the containers change."""
    device = resolve_device(device)
    return _tree_map(lambda a: _to_tensor(a, device), tree)


# --------------------------------------------------------------------------
# full-sequence block forwards
# --------------------------------------------------------------------------


def _heads(p: dict, cfg: LMConfig, h: torch.Tensor, name: str, heads: int) -> torch.Tensor:
    """One projection (``"q"``, ``"k"`` or ``"v"``) of ``h [B, s, d_model]``
    to ``[B, heads, s, hd]``; qk-norm runs on the contiguous
    ``[B, s, H, hd]`` rows before the transpose (same values: the norm is
    over the last axis)."""
    b, s, _ = h.shape
    y = h @ p["w" + name] if "b" + name not in p else h @ p["w" + name] + p["b" + name]
    y = y.reshape(b, s, heads, cfg.head_dim)
    if cfg.qk_norm and name != "v":
        y = ll.rms_norm(y, p[name + "_norm"])
    return y.transpose(1, 2)


def _qkv(p: dict, cfg: LMConfig, h: torch.Tensor):
    """Projections to ``[B, H, s, hd]``."""
    return (_heads(p, cfg, h, "q", cfg.num_heads), _heads(p, cfg, h, "k", cfg.num_kv_heads),
            _heads(p, cfg, h, "v", cfg.num_kv_heads))


def _attend(p, cfg: LMConfig, h, positions, window=None):
    """Attention on the normed ``h`` up to the output projection:
    ``([B, s, q_dim], (k, v))``.  The sharded train step runs it on each
    model position's heads with a per-position ``cfg``
    (``distributed/spmd.py``)."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, cfg, h)
    q = ll.apply_rope(q, positions, cfg.rope_theta)
    k = ll.apply_rope(k, positions, cfg.rope_theta)
    q, k, v = constrain_qkv(q, k, v)
    att = ll.blockwise_attention(q, k, v, causal=True, window=window)
    att = constrain_attn_out(att, cfg.num_kv_heads)
    return att.transpose(1, 2).reshape(b, s, cfg.q_dim), (k, v)


def _attn_forward(p, cfg: LMConfig, x, positions, window=None):
    att, kv = _attend(p, cfg, ll.rms_norm(x, p["ln1"]), positions, window)
    return att @ p["wo"], kv


def _dense_block_forward(p, cfg: LMConfig, x, positions):
    # the reference's Megatron-SP points: the residual stream between
    # sublayers, annotated sequence-split over `model` (a no-op here
    # without an annotation mesh; the sharded step keeps it whole)
    x = constrain(x, "dp", "sp", None)
    out, kv = _attn_forward({**p["attn"], "ln1": p["ln1"]}, cfg, x, positions)
    x = constrain(x + out, "dp", "sp", None)
    h = ll.rms_norm(x, p["ln2"])
    x = x + ll.mlp_forward(p["mlp"], h, cfg.mlp_kind)
    return x, kv


def _moe_ffn(p, cfg: LMConfig, h):
    """The routed experts on the normed ``h``, plus the shared experts
    (deepseek) and the parallel dense residual (arctic)."""
    y = moe_forward(p["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    if "shared" in p:
        y = y + ll.mlp_forward(p["shared"], h, cfg.mlp_kind)
    if "residual" in p:
        y = y + ll.mlp_forward(p["residual"], h, cfg.mlp_kind)
    return y


def _moe_block_forward(p, cfg: LMConfig, x, positions):
    out, kv = _attn_forward({**p["attn"], "ln1": p["ln1"]}, cfg, x, positions)
    x = x + out
    return x + _moe_ffn(p, cfg, ll.rms_norm(x, p["ln2"])), kv


def _mamba_layer_forward(p, cfg: LMConfig, x):
    h = ll.rms_norm(x, p["ln1"])
    return x + mb.mamba_forward(p["mixer"], h, head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk)


def _rglru_layer_forward(p, cfg: LMConfig, x, return_cache: bool = False):
    """An RG-LRU layer; with ``return_cache``, ``(x, state)`` with the
    mixer's decode state after the last step (its K6 scan runs once)."""
    h = ll.rms_norm(x, p["ln1"])
    y = rg.rglru_forward(p["mixer"], h, return_cache=return_cache)
    y, state = y if return_cache else (y, None)
    x = x + y
    x = x + ll.mlp_forward(p["mlp"], ll.rms_norm(x, p["ln2"]), "geglu")
    return (x, state) if return_cache else x


def _hybrid_attn_layer_forward(p, cfg: LMConfig, x, positions):
    out, kv = _attn_forward({**p["attn"], "ln1": p["ln1"]}, cfg, x, positions, cfg.window)
    x = x + out
    return x + ll.mlp_forward(p["mlp"], ll.rms_norm(x, p["ln2"]), "geglu"), kv


def _super_forward(p, cfg: LMConfig, x, positions):
    """A Griffin superblock: two RG-LRU layers, then local attention."""
    x = _rglru_layer_forward(p["r1"], cfg, x)
    x = _rglru_layer_forward(p["r2"], cfg, x)
    return _hybrid_attn_layer_forward(p["attn"], cfg, x, positions)[0]


def _embed(params: dict, cfg: LMConfig, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return params["embed"][inputs.long()]
    return inputs.to(cfg.dtype)


def _unstack(stacked: dict, n: int) -> list[dict]:
    """The ``n`` layers' parameters (views) of a stacked tree, split with
    one ``unbind`` per leaf, whose backward stacks the layers' gradients
    once (``layer(stacked, i)`` would add a full-size zero-padded gradient
    per layer)."""
    layers: list[dict] = [{} for _ in range(n)]

    def split(tree, outs):
        for key, val in tree.items():
            if isinstance(val, dict):
                split(val, [o.setdefault(key, {}) for o in outs])
            else:
                for o, t in zip(outs, torch.unbind(val)):
                    o[key] = t

    split(stacked, layers)
    return layers


_BLOCK_FORWARD = {"dense": _dense_block_forward, "moe": _moe_block_forward}


def _stacks(params: dict, cfg: LMConfig) -> list[tuple[dict, str]]:
    """The stacked layers in depth order, each with its kind: ``"dense"``,
    ``"moe"``, ``"mamba"``, ``"super"`` or ``"rglru"`` (the moe family's
    leading dense blocks first, the hybrid family's RG-LRU tail last)."""
    if cfg.family == "ssm":
        return [(params["blocks"], "mamba")]
    if cfg.family == "hybrid":
        tail = [(params["tail"], "rglru")] if "tail" in params else []
        return [(params["super"], "super")] + tail
    if cfg.family == "moe":
        dense = [(params["dense_blocks"], "dense")] if "dense_blocks" in params else []
        return dense + [(params["moe_blocks"], "moe")]
    return [(params["blocks"], "dense")]


def _depth(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def forward_hidden(params: dict, cfg: LMConfig, inputs, positions) -> torch.Tensor:
    """inputs: tokens [B,S] int (tokens mode) or embeddings [B,S,D].  With
    autograd recording and ``cfg.remat``, each block (a hybrid superblock
    whole, as the JAX package's scan body) is checkpointed
    (``use_reentrant=False``): its activations are recomputed, kernels
    included, in the backward."""
    x = _embed(params, cfg, inputs)
    remat = cfg.remat and torch.is_grad_enabled()
    for stacked, kind in _stacks(params, cfg):
        if kind == "mamba":
            def body(lp, h):
                return _mamba_layer_forward(lp, cfg, h)
        elif kind == "rglru":
            def body(lp, h):
                return _rglru_layer_forward(lp, cfg, h)
        elif kind == "super":
            def body(lp, h):
                return _super_forward(lp, cfg, h, positions)
        else:
            def body(lp, h, fwd=_BLOCK_FORWARD[kind]):
                return fwd(lp, cfg, h, positions)[0]
        for lp in _unstack(stacked, _depth(stacked)):
            if remat:
                x = torch.utils.checkpoint.checkpoint(body, lp, x, use_reentrant=False)
            else:
                x = body(lp, x)
    return ll.rms_norm(x, params["final_norm"])


def lm_loss(params: dict, cfg: LMConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy over the full sequence (a 0-dim f32 tensor)."""
    inputs = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeddings"]
    s = inputs.shape[1]
    h = forward_hidden(params, cfg, inputs, torch.arange(s, device=inputs.device))
    logits = h @ params["lm_head"]
    return ll.cross_entropy(logits, batch["labels"])


# --------------------------------------------------------------------------
# serving: prefill + single-token decode with per-family caches
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed decode cache on ``device`` (default CUDA).  The hybrid
    family's attention layers keep a ring of ``min(window, max_len)``
    slots, position ``p`` in slot ``p % slots``."""
    device = resolve_device(device)
    dt = cfg.dtype
    if cfg.family in _KV_FAMILIES:
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "length": 0,
        }
    if cfg.family == "hybrid":
        n_super, tail = divmod(cfg.num_layers, 3)
        one = rg.init_rglru_cache(cfg.d_rnn, cfg.conv_width, batch, dt, device)
        stacked = lambda n: _tree_map(  # noqa: E731
            lambda a: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype, device=device), one)
        kvshape = (n_super, batch, cfg.num_kv_heads, min(cfg.window, max_len), cfg.head_dim)
        cache = {"r1": stacked(n_super), "r2": stacked(n_super),
                 "k": torch.zeros(kvshape, dtype=dt, device=device),
                 "v": torch.zeros(kvshape, dtype=dt, device=device), "length": 0}
        if tail:
            cache["tail"] = stacked(tail)
        return cache
    one = mb.init_mamba_cache(
        cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_width, batch, dt, device
    )
    return {
        "layers": _tree_map(
            lambda a: torch.zeros((cfg.num_layers,) + tuple(a.shape), dtype=a.dtype, device=device),
            one,
        ),
        "length": 0,
    }


def _attn_decode(p, cfg: LMConfig, kcache, vcache, x, pos: int, window=None):
    """One-token attention sublayer; writes this token's K and V into
    ``kcache``/``vcache`` ([B,Hkv,S,Dh]) at slot ``pos`` (``pos % S``, a
    ring, with a window), in place."""
    b = x.shape[0]
    h = ll.rms_norm(x, p["ln1"])
    q, k, v = _qkv(p["attn"], cfg, h)
    posv = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = ll.apply_rope(q, posv, cfg.rope_theta)
    k = ll.apply_rope(k, posv, cfg.rope_theta)
    slots = kcache.shape[2]
    slot = pos % slots if window is not None else pos
    kcache[:, :, slot] = k[:, :, 0]
    vcache[:, :, slot] = v[:, :, 0]
    if window is None:
        att = ll.decode_attention(q, kcache, vcache, pos + 1)
    else:
        att = _ring_window_attention(q, kcache, vcache, pos, slots)
    out = att.transpose(1, 2).reshape(b, 1, cfg.q_dim) @ p["attn"]["wo"]
    return x + out


def _ring_window_attention(q, kcache, vcache, pos: int, w: int):
    """Attention over a ring-buffered window cache of ``w`` slots, plain
    PyTorch: slot ``j`` holds position ``pos - ((pos - j) mod w)``, valid
    from position 0; scores and softmax in f32, probabilities cast to the
    cache's dtype before the f32 PV product, as the JAX package does."""
    b, hq, _, d = q.shape
    hkv = kcache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bhkd->bhgk", qg, kcache.float()) * (1.0 / d**0.5)
    age = (pos % w - torch.arange(w, device=q.device)) % w
    valid = pos - age >= max(0, pos - w + 1)
    scores = scores.masked_fill(~valid, ll.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(vcache.dtype).float(), vcache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _rglru_decode(p, states: dict, i: int, x):
    """One token through RG-LRU layer ``p``, its state ``i`` of the stacked
    ``states`` updated in place."""
    y, lc = rg.rglru_decode_step(p["mixer"], layer(states, i), ll.rms_norm(x, p["ln1"]))
    states["conv"][i] = lc["conv"]
    states["h"][i] = lc["h"]
    x = x + y
    return x + ll.mlp_forward(p["mlp"], ll.rms_norm(x, p["ln2"]), "geglu")


def decode_step(params: dict, cfg: LMConfig, cache: dict, inputs) -> tuple:
    """One token for the whole batch. inputs: [B,1] tokens or [B,1,D] embeds.
    Returns (logits [B, vocab] f32, cache), the cache updated in place."""
    pos = cache["length"]
    if cfg.input_mode == "tokens":
        x = params["embed"][inputs[:, 0].long()][:, None]  # [B,1,D]
    else:
        x = inputs.to(cfg.dtype)

    if cfg.family in _KV_FAMILIES:
        i = 0  # the layer's slot in the cache, across the stacks
        for stacked, kind in _stacks(params, cfg):
            for j in range(_depth(stacked)):
                lp = layer(stacked, j)
                x = _attn_decode(lp, cfg, cache["k"][i], cache["v"][i], x, pos)
                hn = ll.rms_norm(x, lp["ln2"])
                if kind == "moe":
                    x = x + _moe_ffn(lp, cfg, hn)
                else:
                    x = x + ll.mlp_forward(lp["mlp"], hn, cfg.mlp_kind)
                i += 1
    elif cfg.family == "hybrid":
        for i in range(_depth(params["super"])):
            sp = layer(params["super"], i)
            x = _rglru_decode(sp["r1"], cache["r1"], i, x)
            x = _rglru_decode(sp["r2"], cache["r2"], i, x)
            ap = sp["attn"]
            x = _attn_decode(ap, cfg, cache["k"][i], cache["v"][i], x, pos, window=cfg.window)
            x = x + ll.mlp_forward(ap["mlp"], ll.rms_norm(x, ap["ln2"]), "geglu")
        if "tail" in params:
            for i in range(_depth(params["tail"])):
                x = _rglru_decode(layer(params["tail"], i), cache["tail"], i, x)
    else:
        states = cache["layers"]
        for i in range(cfg.num_layers):
            lp = layer(params["blocks"], i)
            hn = ll.rms_norm(x, lp["ln1"])
            y, lc = mb.mamba_decode_step(
                lp["mixer"], layer(states, i), hn, head_dim=cfg.ssm_head_dim
            )
            x = x + y
            states["conv"][i] = lc["conv"]
            states["ssm"][i] = lc["ssm"]

    h = ll.rms_norm(x, params["final_norm"])
    logits = (h[:, 0] @ params["lm_head"]).to(torch.float32)
    cache["length"] = pos + 1
    return logits, cache


def prefill(params: dict, cfg: LMConfig, inputs) -> tuple:
    """Full-sequence prefill: returns (last-token logits [B, vocab], cache).

    Attention families materialize the KV cache; the ssm family returns
    each layer's final conv window and SSM state, the latter written by K4.
    The hybrid family returns each RG-LRU layer's conv window and final
    state (K6 runs once a layer) and each attention layer's last
    ``w = min(window, S)`` keys and values as the ring ``init_cache``
    describes, position ``p`` in slot ``p % w``; where ``S > window`` and
    ``S % window != 0`` the JAX package keeps them in positional order,
    which its decode does not read right (ROADMAP.md §3)."""
    s = inputs.shape[1]
    positions = torch.arange(s, device=inputs.device)
    x = _embed(params, cfg, inputs)
    cache: dict[str, Any] = {}
    if cfg.family in _KV_FAMILIES:
        ks, vs = [], []
        for stacked, kind in _stacks(params, cfg):
            for j in range(_depth(stacked)):
                x, (k, v) = _BLOCK_FORWARD[kind](layer(stacked, j), cfg, x, positions)
                ks.append(k)
                vs.append(v)
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
    elif cfg.family == "hybrid":
        w = min(cfg.window, s)
        states: dict[str, list] = {"r1": [], "r2": [], "tail": []}
        ks, vs = [], []
        for i in range(_depth(params["super"])):
            sp = layer(params["super"], i)
            for name in ("r1", "r2"):
                x, st = _rglru_layer_forward(sp[name], cfg, x, return_cache=True)
                states[name].append(st)
            x, (k, v) = _hybrid_attn_layer_forward(sp["attn"], cfg, x, positions)
            ks.append(torch.roll(k[:, :, s - w:], s % w, dims=2))  # slot p % w
            vs.append(torch.roll(v[:, :, s - w:], s % w, dims=2))
        if "tail" in params:
            for i in range(_depth(params["tail"])):
                x, st = _rglru_layer_forward(layer(params["tail"], i), cfg, x, return_cache=True)
                states["tail"].append(st)
        for name, sts in states.items():
            if sts:
                cache[name] = {key: torch.stack([st[key] for st in sts]) for key in ("conv", "h")}
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
    else:
        convs, ssms = [], []
        for i in range(cfg.num_layers):
            lp = layer(params["blocks"], i)
            hn = ll.rms_norm(x, lp["ln1"])
            y, lc = mb.mamba_forward(lp["mixer"], hn, head_dim=cfg.ssm_head_dim,
                                     chunk=cfg.ssd_chunk, return_cache=True)
            convs.append(lc["conv"])
            ssms.append(lc["ssm"])
            x = x + y
        cache["layers"] = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}

    h = ll.rms_norm(x, params["final_norm"])
    logits = (h[:, -1] @ params["lm_head"]).to(torch.float32)
    cache["length"] = s
    return logits, cache

