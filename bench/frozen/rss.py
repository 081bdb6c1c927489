"""The process's resident set size, frozen.

``read_rss_bytes`` is copied from ``src/repro_torch/obs/sampler.py`` at
commit 4cdb0a73912ceae5e46a51aa52d89d73ba4acce5.
"""

from __future__ import annotations

import os

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_rss_bytes() -> int:
    """Resident set size from /proc/self/statm (0 where unsupported)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return 0
