"""Production mesh construction.

Functions, not module-level constants: a mesh is a shape, axis names and
one device name per position (``repro_torch.dist.mesh.Mesh``), and
building one touches no device.  Its names are resolved when a layer
step is built for it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 single-pod (256 positions) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    """Arbitrary mesh (tests, examples, the dry-run).  ``devices``: one name
    per position in row-major order, a single name repeated over every
    position, or None for ``cuda:0 .. cuda:n-1``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * math.prod(shape)
    names = None if devices is None else tuple(str(d) for d in devices)
    return Mesh(shape, axes, names)
