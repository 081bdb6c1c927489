"""Static cost model over the port's own program, the counterpart of
``repro/perf/hlo_cost.py``.

The reference parses the compiled, SPMD-partitioned HLO of a step.
PyTorch has no HLO, so the port counts the program it runs:

  1. ``trace_ops(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and
     records every op: its name, its input and output shapes and dtypes,
     and the bytes live on each device after it (the counterpart of
     ``parse_module``).  On ``meta`` tensors nothing is allocated and no
     device is touched; on the card the same counter sees the same ops,
     since every branch of the port that tells the card from ``meta``
     takes the card's route on both (``kernels/ops.py``,
     ``distributed/spmd.py``).  Ops whose tensors all lie on the host are
     not the device's work and are left out;
  2. no trip counts.  Eager execution unrolls the layer loop, so every
     layer's ops are recorded once each: the reference's
     ``compute_multipliers`` and ``_trip_count`` have no counterpart.
     Where a caller runs one of several equal programs (one data shard of
     the sharded step), ``repeat(n)`` weights its records by ``n``;
  3. FLOPs: matmuls, batched matmuls and convolutions (2 · prod(out) ·
     prod(contracted dims)), plus the products of the hand-written kernels
     whose reference is a dot (K2, K3, K4, by ``kernel_cost``'s
     formulas); elementwise work is ignored, as the reference ignores it,
     and so are the operations of K1's segment sums, K5's norm and K6's
     scan (``elementwise_kernel_flops`` keeps them).  A kernel is one op:
     its wrapper notes the call (``kernels/_build.note``) on the card and
     on ``meta`` alike;
  4. bytes: XLA's convention, operand plus output bytes of every op that
     runs a kernel.  Allocations and views (outputs that alias an input)
     run none and count nothing.  The reference's movement discount is not
     carried over: it drops converts and copies because the TPU folds them
     into the next op, but in the eager port each one is a kernel;
  5. collectives: the wire bytes of the copies between distinct mesh
     positions, which ``distributed/spmd.py`` and ``dist/mesh.py`` note by
     kind (``note_copy``), weighted by the reference's ring factors;
  6. memory, which XLA reports and a parse of HLO text cannot:
     ``peak_bytes``, the most bytes live at once (the arguments
     included), each storage rounded up to the CUDA caching allocator's
     512-byte blocks, and ``temp_bytes``, ``peak_bytes`` less the
     arguments' (the counterpart of XLA's ``temp_size_in_bytes``).

The totals are those of the traced program: one device's, or, where the
mesh's positions run in one process, all of theirs.
"""

from __future__ import annotations

import contextlib
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_RING = {  # wire-bytes factor per device, ring algorithms, (n-1)/n ~ 1
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_BLOCK = 512  # the CUDA caching allocator's rounding of every allocation

# ops that allocate without writing: no kernel
_ALLOCATIONS = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
                "aten.new_empty_strided"}

# ops with one transcendental per output element ("out") or per element of
# their first input ("in"), as XLA's cost analysis counts them
_TRANSCENDENTAL = {
    "aten.exp": "out", "aten.exp2": "out", "aten.expm1": "out", "aten.log": "out",
    "aten.log2": "out", "aten.log1p": "out", "aten.tanh": "out", "aten.sigmoid": "out",
    "aten.rsqrt": "out", "aten.sqrt": "out", "aten.sin": "out", "aten.cos": "out",
    "aten.erf": "out", "aten.silu": "out", "aten.gelu": "out", "aten.softplus": "out",
    "aten.pow": "out", "aten._softmax": "out", "aten._log_softmax": "out",
    "aten.logsumexp": "in", "aten.silu_backward": "out", "aten.gelu_backward": "out",
    "aten._log_softmax_backward_data": "out",
}

# kernels whose work the reference's XLA program does as elementwise ops or
# scatters, not dots: their operations stay out of ``flops``
_ELEMENTWISE_KERNELS = ("edge_block_spmm", "rms_norm", "rms_norm_bwd", "rglru_scan",
                        "rglru_scan_bwd")


# -------------------------------------------------------------- the record

_traces: list["_OpTrace"] = []


_DTYPE_NAMES: dict = {}


def _spec(t: torch.Tensor) -> tuple:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        name = _DTYPE_NAMES[t.dtype] = str(t.dtype).removeprefix("torch.")
    return (tuple(t.shape), name)


def _tensors(obj):
    """The tensors of a tree of dicts, lists, tuples and sharded leaves (any
    object with a ``blocks`` list)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(getattr(obj, "blocks", None), list):
        yield from _tensors(obj.blocks)


def _flat(objs) -> list:
    """The tensors among ``objs`` and in its lists and tuples, one level
    down (an op's arguments or results)."""
    out = []
    for x in objs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _writes_new(ins: list, outs: list) -> bool:
    """True if an output lies on a storage no input holds (a view or an
    alias of an input runs no kernel)."""
    held = {id(t.untyped_storage()) for t in ins}
    return any(id(t.untyped_storage()) not in held for t in outs)


def _rounded(nbytes: int) -> int:
    return 0 if nbytes == 0 else -(-nbytes // _BLOCK) * _BLOCK


class _OpTrace(TorchDispatchMode):
    """The dispatch-level counter: one record per op (see the module
    docstring), the storages it creates tracked until they die."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[dict] = []
        self.live: dict[str, int] = {}
        self._storages: dict[int, tuple[str, int]] = {}
        self._finalizers: list = []
        self._ops: dict = {}  # func -> (name, mutable)
        self.weight = 1

    # ------------------------------------------------------------ memory
    def _free(self, key: int) -> None:
        dev, nbytes = self._storages.pop(key)
        self.live[dev] -= nbytes

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies (once per storage)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        dev, nbytes = str(t.device), _rounded(st.nbytes())
        self._storages[key] = (dev, nbytes)
        self.live[dev] = self.live.get(dev, 0) + nbytes
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def add(self, rec: dict) -> None:
        if self.weight != 1:
            rec["mult"] = self.weight
        rec["live"] = dict(self.live)
        self.records.append(rec)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _flat(args)
        if kwargs:
            ins += _flat(kwargs.values())
        outs = _flat((out,))
        if all(t.device.type == "cpu" for t in ins) and all(t.device.type == "cpu"
                                                            for t in outs):
            return out
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = (str(func.overloadpacket), func._schema.is_mutable)
        name, mutable = op
        for t in outs:
            self.track(t)
        rec = {"op": name, "in": [_spec(t) for t in ins], "out": [_spec(t) for t in outs]}
        if name in _ALLOCATIONS or not (mutable or _writes_new(ins, outs)):
            rec["nokernel"] = True
        self.add(rec)
        return out

    def kernel(self, name: str, inputs, outputs, attrs: dict) -> None:
        """A hand-written kernel's call, noted by its wrapper."""
        rec = {"op": "kernel." + name, "in": [_spec(t) for t in inputs],
               "out": [_spec(t) for t in outputs]}
        if attrs:
            rec["attrs"] = attrs
        self.add(rec)


def trace_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), records)``: every op ``fn`` runs on a device
    (``meta`` or the card), every noted kernel call and position-to-position
    copy, one dict each, after a first record of the arguments, whose
    tensors count as live from the start."""
    mode = _OpTrace()
    for t in _tensors((args, kwargs)):
        if t.device.type != "cpu":
            mode.track(t)
    mode.add({"op": "arguments", "in": [], "out": [], "nokernel": True})
    _traces.append(mode)
    try:
        with _build.observe(mode.kernel), mode:
            result = fn(*args, **kwargs)
    finally:
        _traces.remove(mode)
        for f in mode._finalizers:  # storages that outlive the trace keep nothing alive
            f.detach()
    return result, mode.records


def tracing() -> bool:
    """True inside ``trace_ops``."""
    return bool(_traces)


@contextlib.contextmanager
def repeat(n: int):
    """Weight the records made inside the block by ``n``: the caller runs
    one of ``n`` programs equal op for op (a no-op outside a trace)."""
    olds = [m.weight for m in _traces]
    for m in _traces:
        m.weight *= n
    try:
        yield
    finally:
        for m, w in zip(_traces, olds):
            m.weight = w


def note_copy(kind: str, nbytes: int, count: int = 1) -> None:
    """``count`` copies of ``nbytes`` in all between distinct mesh
    positions, each the part of a collective ``kind`` that it carries out."""
    for m in _traces:
        m.add({"op": "collective." + kind, "in": [], "out": [], "nokernel": True,
               "wire_bytes": int(nbytes), "count": count})


# ---------------------------------------------------------- kernels' costs

H100 = {
    "peak_flops": 989e12,  # bf16 tensor cores, dense, H100 SXM (published)
    "peak_flops_f32": 67e12,  # f32 without tensor cores
    "hbm_bw": 3.35e12,  # B/s HBM3
    "ici_bw": 450e9,  # B/s each way, NVLink 4
}


def _nbytes(spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * getattr(torch, dtype).itemsize


def band_pairs(s: int, window: int | None, causal: bool = True) -> int:
    """(query, key) pairs a query of ``s`` rows sees: the causal triangle,
    cut to the band ``q - k < window``."""
    if not causal:  # every key after the query's band start
        w = s if window is None else min(window, s)
        return s * s - (s - w) * (s - w + 1) // 2
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def kernel_cost(name: str, tensors, **attrs) -> dict:
    """FLOPs, bytes and transcendentals of one kernel call, and the peak
    rate its FLOPs run at on an H100: the formulas of ``PERF.md``'s bound
    column.  ``tensors`` are ``(shape, dtype name)`` pairs, inputs then
    outputs, as the wrapper notes them (``kernels/_build.note``); the
    bytes read each input once and write each output once."""
    tensors = [(tuple(s), d) for s, d in tensors]
    nbytes = sum(_nbytes(t) for t in tensors)
    (shape0, dtype0) = tensors[0]
    peak = H100["peak_flops"] if dtype0 == "bfloat16" else H100["peak_flops_f32"]
    trans = 0
    if name in ("flash_attention", "flash_attention_bwd"):
        b, hq, s, d = shape0
        pairs = band_pairs(s, attrs.get("window"), attrs.get("causal", True))
        # forward: QKᵀ and PV inside the band; backward: S recomputed, dP, dV, dQ, dK
        flops = (4 if name == "flash_attention" else 10) * b * hq * d * pairs
        trans = b * hq * pairs
    elif name in ("ssd_scan", "ssd_scan_bwd"):
        bh, s, p = shape0
        n = tensors[2][0][-1]
        chunk = attrs["chunk"]
        tri = chunk * (chunk + 1) // 2
        if name == "ssd_scan":
            flops = bh * (s // chunk) * (2 * tri * (n + p) + 4 * chunk * p * n)
        else:
            # five products on and below the diagonal (C Bᵀ, dY Xᵀ, dX, dB, dC),
            # three with the state (B dSᵀ, X dS, dY S_in), the two recurrences
            flops = bh * (s // chunk) * (2 * tri * (3 * n + 2 * p) + 2 * 5 * chunk * p * n)
        trans = bh * (s // chunk) * tri
    elif name in ("rms_norm", "rms_norm_bwd"):
        rows, d = shape0
        flops = (4 if name == "rms_norm" else 14) * rows * d  # ~14 f32 ops an element back
        trans = rows
        peak = H100["peak_flops_f32"]
    elif name in ("rglru_scan", "rglru_scan_bwd"):
        b, s, r = shape0
        flops = (2 if name == "rglru_scan" else 4) * b * s * r
        peak = H100["peak_flops_f32"]
    elif name == "fused_graduate":
        (n, k), m = shape0, tensors[1][0][1]
        flops = 2 * n * k * m
        trans = n * m if attrs.get("activation") == "gelu" else 0
    elif name == "edge_block_spmm":
        d = shape0[1]
        flops = 2 * tensors[1][0][0] * d  # two per edge and feature
        peak = H100["peak_flops_f32"]
    else:
        raise ValueError(f"unknown kernel {name!r}")
    return {"flops": flops, "bytes": nbytes, "transcendentals": trans, "peak_flops": peak}


def bound_ms(cost: dict, hw: dict = H100) -> tuple[float, str]:
    """The least time the card could take for ``kernel_cost``'s work: its
    bytes over HBM or its FLOPs at their peak, whichever is longer, and
    which (``"bytes"`` or ``"operations"``)."""
    t_bytes = cost["bytes"] / hw["hbm_bw"] * 1e3
    t_ops = cost["flops"] / cost["peak_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- the totals


def _dot_flops(op: str, ins: list, outs: list) -> int:
    """2 · prod(output dims) · prod(contracted dims) of a matmul, batched
    matmul or convolution (0 for other ops)."""
    if not outs:
        return 0
    out = math.prod(outs[0][0])
    if op in ("aten.mm", "aten.bmm", "aten.dot", "aten.mv"):
        return 2 * out * ins[0][0][-1]
    if op in ("aten.addmm", "aten.baddbmm", "aten.addmv", "aten.addbmm"):
        return 2 * out * ins[1][0][-1]
    if op == "aten.convolution":
        weight = ins[1][0]
        return 2 * out * math.prod(weight[1:])
    if op == "aten.convolution_backward":  # grad input and grad weight: two convolutions
        weight = ins[2][0]
        return 2 * 2 * math.prod(ins[0][0]) * math.prod(weight[1:])
    return 0


def analyze(records) -> dict:
    """Totals of a record (``trace_ops``'s, or its lines read back): the
    reference's keys (``flops``, ``bytes``, ``collective_bytes``,
    ``collectives``, ``collective_counts``, ``num_computations``, the count
    of distinct ops) plus ``transcendentals``, ``elementwise_kernel_flops``,
    ``kernels`` (calls by kernel), ``peak_bytes``, ``argument_bytes`` and
    ``temp_bytes``."""
    records = list(records)
    flops = 0
    elementwise = 0
    nbytes = 0
    trans = 0
    coll = {k: 0.0 for k in _COLLECTIVES}
    coll_count = {k: 0 for k in _COLLECTIVES}
    kernels: dict[str, int] = {}
    kinds = set()
    for r in records:
        op, mult = r["op"], r.get("mult", 1)
        if op == "arguments":
            continue
        kinds.add(op)
        if op.startswith("collective."):
            kind = op.removeprefix("collective.")
            coll[kind] += mult * r["wire_bytes"] * _RING[kind]
            coll_count[kind] += mult * r["count"]
            continue
        if op.startswith("kernel."):
            name = op.removeprefix("kernel.")
            cost = kernel_cost(name, r["in"] + r["out"], **r.get("attrs", {}))
            if name in _ELEMENTWISE_KERNELS:
                elementwise += mult * cost["flops"]
            else:
                flops += mult * cost["flops"]
            nbytes += mult * cost["bytes"]
            trans += mult * cost["transcendentals"]
            kernels[name] = kernels.get(name, 0) + mult
            continue
        flops += mult * _dot_flops(op, r["in"], r["out"])
        if not r.get("nokernel"):
            nbytes += mult * sum(_nbytes(t) for t in r["in"] + r["out"])
        per = _TRANSCENDENTAL.get(op)
        if per is not None:
            trans += mult * math.prod((r["out"] if per == "out" else r["in"])[0][0])
    peak = max(sum(r["live"].values()) for r in records)
    args = sum(records[0]["live"].values()) if records and records[0]["op"] == "arguments" else 0
    return {
        "flops": flops,
        "bytes": nbytes,
        "transcendentals": trans,
        "elementwise_kernel_flops": elementwise,
        "collective_bytes": sum(coll.values()),
        "collectives": coll,
        "collective_counts": coll_count,
        "num_computations": len(kinds),
        "kernels": kernels,
        "peak_bytes": peak,
        "argument_bytes": args,
        "temp_bytes": peak - args,
    }


# -------------------------------------------------------------- roofline


def roofline_terms(analysis: dict, hw: dict = H100) -> dict:
    compute_s = analysis["flops"] / hw["peak_flops"]
    memory_s = analysis["bytes"] / hw["hbm_bw"]
    collective_s = analysis["collective_bytes"] / hw["ici_bw"]
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
