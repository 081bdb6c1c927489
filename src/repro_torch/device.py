"""Device selection for the port's entry points.

The port runs on the GPU.  The CPU is used only when the caller asks for
it by name (the CPU tests do); asking for CUDA on a machine without it is
an error, never a silent fallback.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``name`` (default ``"cuda"``).  ``"meta"``
    (shapes only: the dry-run's planner) is taken only where the caller
    names it.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or backend='cpu') to run on the CPU"
        )
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    return device


class PinnedStaging:
    """Reused pinned host buffers for h2d copies: one per operand name,
    grown on demand.

    ``fill`` waits on the event recorded after the previous copy out of
    the buffers before overwriting them, so a refill never races a
    ``non_blocking`` copy still in flight."""

    def __init__(self) -> None:
        self._bufs: dict[str, torch.Tensor] = {}
        self._copied: torch.cuda.Event | None = None

    def fill(self, **arrays: np.ndarray) -> dict[str, torch.Tensor]:
        if self._copied is not None:
            self._copied.synchronize()
        out = {}
        for name, a in arrays.items():
            buf = self._bufs.get(name)
            if buf is None or buf.numel() < a.nbytes:
                buf = torch.empty(max(a.nbytes, 1), dtype=torch.uint8, pin_memory=True)
                self._bufs[name] = buf
            view = buf[: a.nbytes].view(torch.from_numpy(a).dtype).view(a.shape)
            np.copyto(view.numpy(), a, casting="no")
            out[name] = view
        return out

    def copied(self, event: torch.cuda.Event) -> None:
        self._copied = event
