"""Fault-tolerant checkpoint manager, ported from ``repro/train/checkpoint.py``.

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other:

  <dir>/step_000123/<leaf-path>.npy   one file per leaf
  <dir>/step_000123/manifest.json     step, and each leaf's name, dtype, shape
  <dir>/LATEST                        atomic pointer file

Leaf names are the dict path joined by ``__`` in sorted key order.  A
bf16 leaf is written as the reference writes it (numpy has no bfloat16:
the two bytes of each value as an ``<V2`` array) with ``"bfloat16"`` in the
manifest, and restored by the manifest's dtype.

  * atomic commits: leaves go to ``step_N.tmp``, the manifest is fsync'd,
    the directory is renamed into place and then ``LATEST``; a crash
    mid-save never shadows the last good step;
  * async saves: ``save`` copies the tensors to host memory at once (the
    caller may then update them in place) and a background thread writes;
  * retention: the newest ``keep`` steps stay, older ones go only after
    the new one is committed;
  * sharded states: a ``ShardedTensor`` leaf is saved as its whole value,
    and ``restore(..., shardings=)`` puts each leaf straight into its
    blocks on a mesh (the elastic-remesh entry point).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, from_blocks

_BF16_DESCR = "<V2"  # what np.save writes for the reference's bfloat16 leaves


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) in sorted key order, names joined by ``__``."""
    out = []
    for key in sorted(tree):
        name = f"{prefix}__{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            out += _flatten(tree[key], name)
        else:
            out.append((name, tree[key]))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    out = {}
    for key in sorted(like):
        name = f"{prefix}__{key}" if prefix else str(key)
        out[key] = _unflatten(like[key], leaves, name) if isinstance(like[key], dict) else leaves[name]
    return out


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf's host array as it goes to disk, and its manifest dtype."""
    t = t.full(torch.device("cpu")) if isinstance(t, ShardedTensor) else t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape}
        )
        f.write(arr.tobytes())


def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")  # (np.ascontiguousarray would make a 0-d leaf 1-d)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    return _host_tensor(np.load(path), dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = async_save
        self._err: list[BaseException] = []
        if async_save:
            self._q: queue.Queue = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._save_loop, name="ckpt-save", daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, state) -> None:
        """Snapshot ``state`` (a dict tree of tensors) at ``step``."""
        if self._err:
            raise self._err[0]
        host = [(name, *_to_host(leaf)) for name, leaf in _flatten(state)]
        if self._async:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def wait(self) -> None:
        """Block until all queued saves are durable."""
        if self._async:
            self._q.join()
        if self._err:
            raise self._err[0]

    def _save_loop(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except BaseException as e:  # surfaced on the next save()/wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for name, arr, dtype in host:
            _save_leaf(os.path.join(tmp, name + ".npy"), arr, dtype)
            manifest["leaves"].append({"name": name, "dtype": dtype, "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        ptr_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(f"step_{step:09d}")
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, d))

    # -------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, like, step: int | None = None, device=None, shardings=None):
        """Restore into the structure of ``like`` (a dict tree of tensors;
        only the shapes are read).  Returns ``(tree, step)``: CPU
        tensors in the dtypes the manifest names, or on ``device``; with
        ``shardings`` (a matching tree of ``Placement``s), ``ShardedTensor``s
        whose blocks are read from each file's mapping, each distinct block
        once, straight onto its positions' devices."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
        placements = dict(_flatten(shardings)) if shardings is not None else {}
        leaves = {}
        for name, ref in _flatten(like):
            path = os.path.join(d, name + ".npy")
            if shardings is None:
                t = _load_leaf(path, dtypes[name])
            else:
                t = np.load(path, mmap_mode="r")
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {name}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
            if shardings is None:
                leaves[name] = t if device is None else t.to(device)
            else:
                leaves[name] = from_blocks(placements[name], tuple(t.shape),
                                           lambda region, a=t, dt=dtypes[name]:
                                           _host_tensor(np.array(a[region], order="C"), dt))
        return _unflatten(like, leaves), step
