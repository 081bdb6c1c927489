"""K2: the graduation transform ``act(x @ W + b)``.

Replaces the TPU kernel ``_graduate_kernel`` (``repro/kernels/fused_graduate.py``).
Two routes in ``csrc/fused_graduate.cu``, picked by ``route`` from the
dtype, the shape and the alignment, never by trying one and catching:

- ``"tensor_core"``: bf16 with ``k % 8 == 0`` (k > 0) and ``m % 8 == 0`` on
  16-byte aligned x and W (TMA's rule for strides and addresses): wgmma
  on 128x128 tiles fed by TMA through a four-stage mbarrier ring.
- ``"cuda_core"``: everything else, f32 above all (the GNN main path; TF32
  stays off): register-blocked SGEMMs with 8x8 outputs per thread.  f32
  with ``k % 4 == 0``, ``m % 4 == 0`` on 16-byte aligned x and W takes the
  persistent, TMA-fed ``sgemm_kernel_tma`` at the tile ``tile_for`` fits
  to (n, k, m); other shapes and bf16 take ``sgemm_kernel`` (tile 0), a
  cp.async-pipelined kernel on 128x128 tiles.

Both accumulate in f32 in a fixed order and fuse bias and activation; the
two CUDA-core kernels give the same bits.  At the main path's shapes the
kernel is bound by operations.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
route's kernel or raise.  ``launches`` counts every launch,
``tensor_core_launches`` and ``cuda_core_launches`` (``route_launches[route]``)
each route's, ``tile_launches[name]`` the CUDA-core route's by tile
(``TILE_NAMES``), and ``padded_columns`` the columns its launches computed
past m (each launch adds its last column tile's overhang).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_graduate_ref

launches = _build.LaunchCount()
tensor_core_launches = _build.LaunchCount()
cuda_core_launches = _build.LaunchCount()
route_launches = {"tensor_core": tensor_core_launches, "cuda_core": cuda_core_launches}

# the CUDA-core route's tiles, (rows, columns) by the index the C entry point
# takes: 0 is sgemm_kernel's (bf16, and f32 shapes TMA cannot take), 1-4
# sgemm_kernel_tma's (launch_tiled in csrc/fused_graduate.cu)
TILES = {0: (128, 128), 1: (128, 128), 2: (64, 128), 3: (128, 176), 4: (64, 176)}
TILE_NAMES = {0: "fallback", 1: "128x128", 2: "64x128", 3: "128x176", 4: "64x176"}
tile_launches = {name: _build.LaunchCount() for name in TILE_NAMES.values()}
padded_columns = _build.LaunchCount()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "relu": 1, "gelu": 2}
_MAX_GRID_Y = 65535  # sgemm_kernel puts column tiles of 128 on y
_MAX_TILES = 2**31 - 1  # sgemm_kernel_tma counts its tiles in an int
_MAX_ROWS = 2**31 - 256  # and its rows, n + BM - 1 included


def route(dtype: torch.dtype, k: int, m: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"tensor_core"`` for bf16 with
    ``k % 8 == 0`` (k > 0), ``m % 8 == 0`` and 16-byte aligned x and W,
    else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and m % 8 == 0 and aligned:
        return "tensor_core"
    return "cuda_core"


def padded(m: int, tile: int) -> int:
    """The columns a launch at ``tile`` computes past ``m``."""
    bn = TILES[tile][1]
    return -(-m // bn) * bn - m


def tile_for(n: int, k: int, m: int, aligned: bool = True) -> int:
    """The CUDA-core route's tile for an f32 ``[n, k] @ [k, m]`` (an index
    of ``TILES``): 0, ``sgemm_kernel``, where TMA cannot take the shape
    (``k`` or ``m`` not a multiple of 4, x or W not 16-byte aligned, an
    empty one); else the fewest columns computed past ``m``, then the
    largest tile that still gives every SM a tile, or, where none does,
    the one that gives the most tiles."""
    if min(n, k, m) < 1 or k % 4 or m % 4 or not aligned or n > _MAX_ROWS:
        return 0

    def tiles(t: int) -> int:
        return -(-n // TILES[t][0]) * -(-m // TILES[t][1])

    fitted = [t for t in TILES if t and tiles(t) <= _MAX_TILES]
    if not fitted:
        return 0
    least = min(padded(m, t) for t in fitted)
    fitted = [t for t in fitted if padded(m, t) == least]
    filling = [t for t in fitted if tiles(t) >= _build.PLANNED_SMS]
    if filling:
        return max(filling, key=lambda t: (TILES[t][0] * TILES[t][1], -t))
    return max(fitted, key=lambda t: (tiles(t), -t))


def fused_graduate(
    x: torch.Tensor,  # [N, K] finalized aggregate rows
    w: torch.Tensor,  # [K, M] layer weight
    b: torch.Tensor,  # [M] bias
    activation: str = "relu",  # 'none' | 'relu' | 'gelu' (tanh)
) -> torch.Tensor:
    """``act(x @ w + b)`` accumulated in f32, returned in ``x.dtype``."""
    return _graduate(x, w, b, activation, None)


def _graduate_at_tile(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      activation: str, tile: int) -> torch.Tensor:
    """A test hook, not a tuning knob: ``fused_graduate`` on the CUDA-core
    route at ``tile`` (an index of ``TILES``) whatever ``tile_for`` would
    pick, for the checks that hold every tile against ``sgemm_kernel``
    (tile 0) bit for bit.  Nothing on the main path calls it.  Raises where
    the tile cannot take the shape, or on CPU tensors."""
    if tile not in TILES:
        raise ValueError(f"unknown tile {tile!r}")
    return _graduate(x, w, b, activation, tile)


def _graduate(x, w, b, activation: str, tile: int | None) -> torch.Tensor:
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("fused_graduate wants x [N, K], w [K, M], b [M]")
    n, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}"
        )
    m = w.shape[1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"x, w, b must share float32 or bfloat16, got {x.dtype}, {w.dtype}, {b.dtype}"
        )
    tensors = (x, w, b)
    if all(t.device.type == "cpu" for t in tensors) and tile is None:
        return fused_graduate_ref(x, w, b, activation)
    device = x.device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError("fused_graduate: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_graduate: tensors must be contiguous")
    if max(n, k, m) > 2**31 - 1 or -(-m // 128) > _MAX_GRID_Y:
        raise ValueError("fused_graduate: dimensions too large")
    out = torch.empty((n, m), dtype=x.dtype, device=device)
    if n == 0 or m == 0:
        return out
    _build.note("fused_graduate", tensors, (out,), activation=activation)
    if _build.planned(device):
        return out
    lib = _build.load("fused_graduate")
    args = (_build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(out), n, k, m)
    stream = _build.stream_handle(device)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    path = "cuda_core" if tile is not None else route(x.dtype, k, m, aligned=aligned)
    if path == "tensor_core":
        rc = lib.atlas_fused_graduate_tc(*args, _ACTS[activation], stream)
    else:
        if tile is None:
            tile = tile_for(n, k, m, aligned) if x.dtype == torch.float32 else 0
        rc = lib.atlas_fused_graduate(*args, _DTYPES[x.dtype], _ACTS[activation], tile, stream)
    _build.check(rc, lib, "fused_graduate")
    launches.add()
    route_launches[path].add()
    if path == "cuda_core":
        tile_launches[TILE_NAMES[tile]].add()
        padded_columns.add(padded(m, tile))
    return out
