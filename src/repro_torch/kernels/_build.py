"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
Libraries land in ``<repo>/build/repro_torch/``, named by a hash of the
source and the flags, so an edited kernel rebuilds and an unchanged one
loads at once.  ``build_all`` starts one ``nvcc`` per source at the same
time.  ``nvcc`` is found through ``CUDA_HOME`` (default
``/usr/local/cuda``) or ``PATH``.

Every C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` right after its launch; ``check`` turns a
non-zero code into a ``RuntimeError``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's usual install prefix
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every kernel library's entry points (argtypes, restype)
SIGNATURES = {
    "edge_block_spmm": {
        # feats, feats_dtype, src, w, offsets, out, num_seg, n_rows, m, d, stream
        "atlas_segment_reduce": ([_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "atlas_edge_block_spmm_error": ([_I], ctypes.c_char_p),
    },
    "fused_graduate": {
        # x, w, b, out, n, k, m, dtype, act, stream
        "atlas_fused_graduate": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "atlas_fused_graduate_error": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class LaunchCount:
    """Thread-safe count of one kernel's launches (the staging and
    graduation threads launch concurrently)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH"
    )


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; ``None`` when already built."""
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, lib, cmd


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib, cmd = started
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{err}{out}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial .so


def _open(name: str) -> ctypes.CDLL:
    _, lib_path = _target(name)
    lib = ctypes.CDLL(str(lib_path))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_all() -> list[str]:
    """Build every kernel library not built yet, one ``nvcc`` per source,
    all started together.  Returns the names built."""
    with _lock:
        names = [n for n in SIGNATURES if n not in _libs]
        started = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, started[n])
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        for n in names:
            _libs[n] = _open(n)
        return [n for n in names if started[n] is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = _open(name)
        return _libs[name]


def check(rc: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"atlas_{name}_error")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    """The calling thread's current CUDA stream on ``device``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
