"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``.
Libraries land in ``<repo>/build/repro_torch/``, named by a hash of the
source, every shared header (``csrc/*.cuh``) and the flags, so an edited
kernel or header rebuilds and an unchanged one loads at once.  ``build_all`` starts one ``nvcc`` per source at the same
time.  ``nvcc`` is found through ``CUDA_HOME`` (default
``/usr/local/cuda``) or ``PATH``.

Every C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` right after its launch; ``check`` turns a
non-zero code into a ``RuntimeError``.  Nothing here runs at import time.

Planning.  A wrapper given tensors on the ``meta`` device (``planned``)
allocates its outputs and the scratch its card route would, with the
dtypes that route returns, and launches nothing.  On ``meta`` and on the
card alike it reports each call to the observers ``observe`` installs
(``note``): the dry-run's op record (``repro_torch.perf.hlo_cost``) sees
a kernel as one op on either device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's usual install prefix
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signature of every kernel library's entry points (argtypes, restype)
SIGNATURES = {
    "edge_block_spmm": {
        # feats, feats_dtype, src, w, offsets, out, num_seg, n_rows, m, d, stream
        "atlas_segment_reduce": ([_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # feats, feats_dtype, src, w, offsets, out, scratch, split counters, num_seg, n_rows,
        # m, d, stream ("rows" route: a warp per output row, long segments cut into slabs)
        "atlas_segment_rows": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # m, d: the rows route's scratch bytes
        "atlas_segment_rows_scratch_bytes": ([_I, _I], ctypes.c_longlong),
        # the edges of a slab, which fix K1's order of summation
        "atlas_segment_slab_edges": ([], _I),
        "atlas_edge_block_spmm_error": ([_I], ctypes.c_char_p),
    },
    "segment_attention": {
        # z, ldz, a_src, a_dst, s, t, n, heads, f, stream (GAT's scores)
        "atlas_segment_attention_scores": ([_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        # z, ldz, s, t_seg, src, slabs, n_slabs, multis, n_multis, heads, f, n_rows, slope,
        # num, den, mx, pnum, pden, pmx, stream (the attention-weighted segment sums)
        "atlas_segment_attention": ([_P, _LL, _P, _P, _P, _P, _LL, _P, _LL, _I, _I, _I, _F]
                                    + [_P] * 7, _I),
        # num, den, mx, rows, offsets, nv, bias, skip (or null), ldskip, out, heads, f, concat,
        # elu, scale, stream (the normalisation)
        "atlas_segment_attention_normalize": ([_P] * 5 + [_I, _P, _P, _LL, _P, _I, _I, _I, _I,
                                                          _F, _P], _I),
        # the edges of a slab
        "atlas_segment_attention_slab_edges": ([], _I),
        "atlas_segment_attention_error": ([_I], ctypes.c_char_p),
    },
    "fused_graduate": {
        # x, w, b, out, n, k, m, dtype, act, tile (fused_graduate.TILES), stream
        "atlas_fused_graduate": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        # x, w, b, out, n, k, m, act, stream (bf16 on the tensor cores)
        "atlas_fused_graduate_tc": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "atlas_fused_graduate_error": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        # q, k, v, out, lse (or null), bhq, s, d, group, sm_scale, causal, window (0: none),
        # dtype, stream
        "atlas_flash_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P], _I),
        # q, k, v, out, lse (or null), bhq, s, d, group, sm_scale, causal, window (0: none),
        # stream (bf16 on the tensor cores)
        "atlas_flash_attention_tc": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P], _I),
        # q, k, v, o, dout, lse, delta, partials, dq, dk, dv, bhq, s, d, group, sm_scale,
        # causal, window (0: none), runs, dtype, stream (the backward)
        "atlas_flash_attention_bwd": ([_P] * 11 + [_I] * 4 + [_F] + [_I] * 4 + [_P], _I),
        # s, window, causal: the runs of q tiles of the backward's dK/dV partials
        "atlas_flash_attention_bwd_runs": ([_I, _I, _I], _I),
        # q, k, v, o, dout, lse, scratch, partials (or null), dq, dk, dv, bhq, s, d, group,
        # sm_scale, causal, window (0: none), stream (the backward, bf16 on the tensor cores)
        "atlas_flash_attention_bwd_tc": ([_P] * 11 + [_I] * 4 + [_F, _I, _I, _P], _I),
        "atlas_flash_attention_error": ([_I], ctypes.c_char_p),
    },
    "ssd_chunk": {
        # x, a, b, c, y, state (or null), bh, s, p, n, chunk, heads_per_bc, dtype, stream
        "atlas_ssd_chunk": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        # x, a, b, c, y, state (or null), cl, states, hi, lo, bh, s, n, chunk, heads_per_bc,
        # stream (bf16 on the tensor cores)
        "atlas_ssd_chunk_tc": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        # x, a, b, c, dy, dx, da, db, dc, states, dstates, dbp, dcp, bh, s, p, n, chunk,
        # heads_per_bc, dtype, stream (the backward)
        "atlas_ssd_chunk_bwd": ([_P] * 13 + [_I] * 7 + [_P], _I),
        # x, a, b, c, dy, dx, da, db, dc, cl, states, sin_hi, sin_lo, ds_hi, ds_lo, dcl,
        # dss, dbp, dcp, bh, s, n, chunk, heads_per_bc, group, stream (the backward, bf16
        # on the tensor cores)
        "atlas_ssd_chunk_bwd_tc": ([_P] * 19 + [_I] * 6 + [_P], _I),
        "atlas_ssd_chunk_error": ([_I], ctypes.c_char_p),
    },
    "rms_norm": {
        # x, scale, out, n, d, eps, dtype, vec, stream
        "atlas_rms_norm": ([_P, _P, _P, _I, _I, _F, _I, _I, _P], _I),
        # x, scale, out, n, d, eps, dtype, stream (rows held in registers)
        "atlas_rms_norm_resident": ([_P, _P, _P, _I, _I, _F, _I, _P], _I),
        # x, scale, dy, dx, dscale, partial, n, d, blocks, eps, dtype, vec, stream (the backward)
        "atlas_rms_norm_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P], _I),
        # x, scale, dy, dx, dscale, partial, n, d, blocks, eps, dtype, stream (the
        # backward, rows held in registers)
        "atlas_rms_norm_bwd_resident": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P], _I),
        "atlas_rms_norm_error": ([_I], ctypes.c_char_p),
    },
    "rglru_scan": {
        # a, w, h0 (or null), h, chain, ticket, epoch, b, s, r, chunk, stream
        "atlas_rglru_scan": ([_P] * 6 + [_U] + [_I] * 4 + [_P], _I),
        # a, h, dh, h0 (or null), da, dw, dh0 (or null), chain, ticket, epoch, b, s, r,
        # chunk, stream (the backward)
        "atlas_rglru_scan_bwd": ([_P] * 9 + [_U] + [_I] * 4 + [_P], _I),
        # the sequential kernels K6 replaced, for chip_smoke.py's comparison: a, w, h0 (or null), h,
        # b, s, r, stream; a, h, dh, h0, da, dw, dh0, b, s, r, stream
        "atlas_rglru_scan_loop": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "atlas_rglru_scan_bwd_loop": ([_P] * 7 + [_I] * 3 + [_P], _I),
        "atlas_rglru_scan_error": ([_I], ctypes.c_char_p),
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

    def add(self, count: int = 1) -> None:
        with self._lock:
            self._n += count

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


# the devices a wrapper takes past its plain version: the card, and ``meta``
# (shapes only, no launch)
CARD_TYPES = ("cuda", "meta")
PLANNED_SMS = 132  # the H100 SXM's SMs, for the grids a ``meta`` call sizes
_observers: list = []


def planned(device) -> bool:
    """True for the ``meta`` device: the wrapper allocates, notes and
    returns without a launch."""
    return device.type == "meta"


def sm_count(device) -> int:
    """The SMs of ``device`` (the H100 SXM's on ``meta``)."""
    import torch

    if planned(device):
        return PLANNED_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def note(name: str, inputs, outputs, **attrs) -> None:
    """One kernel call (``name``, its input and output tensors, its
    arguments that are not tensors) to every observer."""
    for fn in tuple(_observers):
        fn(name, inputs, outputs, attrs)


class observe:
    """``with observe(fn):`` calls ``fn(name, inputs, outputs, attrs)`` for
    every kernel call ``note`` reports inside the block."""

    def __init__(self, fn) -> None:
        self.fn = fn

    def __enter__(self):
        _observers.append(self.fn)
        return self

    def __exit__(self, *exc) -> None:
        _observers.remove(self.fn)


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
    """The source and its library's path.  The name hashes the source, every
    ``csrc/*.cuh`` in sorted order (no include parsing: a header edit
    rebuilds every kernel) and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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
    lib.with_suffix(".ptxas.txt").write_text(err)  # -Xptxas -v: registers and spills
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


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '([^']+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
    r".*?Used (\d+) registers", re.S)


def resource_usage(name: str) -> dict[str, tuple[int, int, int]]:
    """``{mangled kernel: (registers, spill store bytes, spill load bytes)}``
    as ``ptxas -v`` reported them when ``csrc/<name>.cu`` was built;
    empty if this library was built before the report was kept."""
    report = _target(name)[1].with_suffix(".ptxas.txt")
    if not report.exists():
        return {}
    return {m[0]: (int(m[3]), int(m[1]), int(m[2]))
            for m in _PTXAS_ENTRY.findall(report.read_text())}


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
