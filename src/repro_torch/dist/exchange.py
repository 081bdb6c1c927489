"""Cross-shard message exchange: one bucket per (src_shard, dst_shard).

Per layer, each shard worker streams its own source range, delivers
locally-owned destinations straight into its hot store, and accumulates
one pre-combined bucket per *remote* destination shard — ``(dst ids,
partial rows, message counts)``, one record per distinct destination
(the same source-side combining ``CombinedEdgePlan`` does on a device
mesh: wire volume is distinct destinations, not edges).  The exchange
then routes the buckets:

* ``LocalExchange`` — file-backed buckets under a shared directory with
  atomic tmp+rename publication and ``sent`` marker files; shard ``t``
  polls for all markers (the intra-layer barrier) and reads its column.
  Works identically for thread workers (one shared instance) and
  process workers (one instance per process over the same directory) —
  the CPU-only 2-to-4-process single-host harness.
* ``MeshExchange`` — routes the padded bucket tensors by the tiled
  all_to_all's definition, ``recv[t][i] = send[i][t]``, over one torch
  device per shard: shard ``i``'s slab is stacked on ``devices[i]`` and
  each destination's column is copied to ``devices[t]``; when every
  shard names the same device this is one transpose-and-copy there.
  The device list is explicit (``["cpu"] * N`` on a CPU host,
  ``["cuda:0"] * N`` on one GPU), and defaults to ``cuda:0 ..
  cuda:N-1`` — the port's form of the JAX package's forced host device
  count.  Thread workers only: they rendezvous on an in-process
  barrier.  Bytes move verbatim (zero-padding is filtered by the valid
  mask), so bit-identity with the local exchange holds.

Failure model: ``abort()`` (a marker file / broken barrier) unblocks
every poll so a dead worker turns into a clean ``ExchangeAborted`` in
the survivors instead of a hang; the coordinator then leaves the run
manifest un-advanced for that layer.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


class ExchangeAborted(RuntimeError):
    """Another shard died (or the coordinator cancelled the layer)."""


def _bucket_nbytes(dst: np.ndarray, partial: np.ndarray, counts: np.ndarray) -> int:
    return int(dst.nbytes + partial.nbytes + counts.nbytes)


class LocalExchange:
    """File-backed (src_shard, dst_shard) buckets with polling barriers.

    Layout under ``root``::

        layer_<l>/msg_s<i>_to_s<j>.npz   bucket i -> j (atomic tmp+rename)
        layer_<l>/sent_s<i>.ok           shard i posted ALL its buckets
        abort.ok                         any worker died; polls raise

    The marker is written strictly after every bucket file, so a visible
    marker implies readable buckets; empty buckets write no file.
    """

    def __init__(
        self,
        root: str,
        num_shards: int,
        poll_s: float = 0.005,
        timeout_s: float = 120.0,
    ):
        self.root = root
        self.num_shards = int(num_shards)
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _layer_dir(self, layer: int) -> str:
        return os.path.join(self.root, f"layer_{int(layer):03d}")

    def _bucket_path(self, layer: int, src: int, dst: int) -> str:
        return os.path.join(
            self._layer_dir(layer), f"msg_s{src:02d}_to_s{dst:02d}.npz"
        )

    def _marker_path(self, layer: int, src: int) -> str:
        return os.path.join(self._layer_dir(layer), f"sent_s{src:02d}.ok")

    @property
    def _abort_path(self) -> str:
        return os.path.join(self.root, "abort.ok")

    # ------------------------------------------------------------- abort
    def abort(self, reason: str = "") -> None:
        tmp = self._abort_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(reason)
        os.replace(tmp, self._abort_path)

    def check_abort(self) -> None:
        if os.path.exists(self._abort_path):
            with open(self._abort_path) as f:
                reason = f.read().strip()
            raise ExchangeAborted(
                f"exchange aborted: {reason or 'a shard worker died'}"
            )

    # -------------------------------------------------------------- post
    def post(self, layer: int, shard: int, buckets: dict) -> int:
        """Publish shard ``shard``'s outgoing buckets for ``layer``.

        ``buckets`` maps dst shard -> ``(dst_ids, partial, counts)``;
        each file lands atomically, the marker last.  Returns bytes
        posted."""
        d = self._layer_dir(layer)
        os.makedirs(d, exist_ok=True)
        sent = 0
        for t, (dst, partial, counts) in sorted(buckets.items()):
            if not len(dst):
                continue
            path = self._bucket_path(layer, shard, int(t))
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, dst=dst, partial=partial, counts=counts)
            os.replace(tmp, path)
            sent += _bucket_nbytes(dst, partial, counts)
        marker = self._marker_path(layer, shard)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write("ok")
        os.replace(tmp, marker)
        return sent

    # ----------------------------------------------------------- collect
    def collect(self, layer: int, shard: int) -> list[tuple]:
        """Wait for every peer's marker (the intra-layer exchange
        barrier), then read shard ``shard``'s incoming buckets.  Returns
        ``[(src_shard, dst_ids, partial, counts), ...]``; raises
        ``ExchangeAborted`` when a peer died, ``TimeoutError`` when the
        barrier never completes."""
        peers = [s for s in range(self.num_shards) if s != shard]
        deadline = time.monotonic() + self.timeout_s
        waiting = set(peers)
        while waiting:
            self.check_abort()
            waiting = {
                s for s in waiting
                if not os.path.exists(self._marker_path(layer, s))
            }
            if not waiting:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shard {shard}: layer {layer} exchange barrier timed "
                    f"out after {self.timeout_s}s waiting for shards "
                    f"{sorted(waiting)}"
                )
            time.sleep(self.poll_s)
        out = []
        for s in peers:
            path = self._bucket_path(layer, s, shard)
            if not os.path.exists(path):
                continue  # peer had no messages for us
            with np.load(path) as z:
                out.append((s, z["dst"], z["partial"], z["counts"]))
        return out


class MeshExchange:
    """all_to_all bucket routing over one torch device per shard.

    Thread workers only: all ``num_shards`` workers rendezvous on an
    in-process barrier; the last arrival stacks every bucket into padded
    ``[S, S, K(, W)]`` slabs and routes them with ``recv[t][i] =
    send[i][t]`` — the tiled all_to_all over the shard axis — as device
    copies.  ids/counts travel as int32, rows as float32: pure data
    movement, bit-exact.

    ``devices`` lists one device per shard and may repeat one; the
    default ``cuda:0 .. cuda:S-1`` needs that many GPUs.
    """

    def __init__(self, num_shards: int, devices=None, timeout_s: float = 120.0):
        self.num_shards = int(num_shards)
        if devices is None:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < self.num_shards:
                raise RuntimeError(
                    f"exchange='mesh' needs >= {self.num_shards} CUDA devices, "
                    f"have {have} (pass mesh devices explicitly, e.g. "
                    f"{['cuda:0'] * self.num_shards!r} on one GPU or "
                    f"{['cpu'] * self.num_shards!r} on the CPU)"
                )
            devices = [f"cuda:{i}" for i in range(self.num_shards)]
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != self.num_shards:
            raise ValueError(
                f"exchange='mesh' needs one device per shard: "
                f"{self.num_shards} shards, {len(self.devices)} devices"
            )
        self.timeout_s = timeout_s
        self._out: list[dict] = [{} for _ in range(self.num_shards)]
        self._recv: list[list] = [[] for _ in range(self.num_shards)]
        self._error: BaseException | None = None
        self._aborted = False
        self._barrier = threading.Barrier(self.num_shards, action=self._route)

    # ------------------------------------------------------------- abort
    def abort(self, reason: str = "") -> None:
        self._aborted = True
        self._barrier.abort()

    def check_abort(self) -> None:
        if self._aborted:
            raise ExchangeAborted("exchange aborted: a shard worker died")

    # -------------------------------------------------------------- post
    def post(self, layer: int, shard: int, buckets: dict) -> int:
        self._out[shard] = {
            int(t): b for t, b in buckets.items() if len(b[0])
        }
        return sum(_bucket_nbytes(*b) for b in self._out[shard].values())

    # ----------------------------------------------------------- collect
    def collect(self, layer: int, shard: int) -> list[tuple]:
        try:
            self._barrier.wait(timeout=self.timeout_s)
        except threading.BrokenBarrierError:
            if self._error is not None:
                raise self._error
            raise ExchangeAborted(
                "exchange aborted: a shard worker died before the "
                "all_to_all rendezvous"
            ) from None
        if self._error is not None:
            raise self._error
        return self._recv[shard]

    # ------------------------------------------------------------- route
    def _route(self) -> None:
        """Barrier action (runs once on the last-arriving worker thread):
        pad, stack, all_to_all, unpack."""
        try:
            self._recv = [[] for _ in range(self.num_shards)]
            s = self.num_shards
            widths = {
                b[1].shape[1]
                for out in self._out for b in out.values()
            }
            if not widths:  # no cross-shard traffic at all this layer
                self._out = [{} for _ in range(s)]
                return
            if len(widths) != 1:
                raise ValueError(f"mixed bucket widths {sorted(widths)}")
            w = widths.pop()
            k = max(
                (len(b[0]) for out in self._out for b in out.values()),
                default=1,
            )
            ids = np.full((s, s, k), -1, dtype=np.int32)
            cnt = np.zeros((s, s, k), dtype=np.int32)
            rows = np.zeros((s, s, k, w), dtype=np.float32)
            for i, out in enumerate(self._out):
                for j, (dst, partial, counts) in out.items():
                    n = len(dst)
                    ids[i, j, :n] = dst.astype(np.int32)
                    cnt[i, j, :n] = counts.astype(np.int32)
                    rows[i, j, :n] = partial
            r_ids, r_cnt, r_rows = self._all_to_all(ids, cnt, rows)
            for t in range(s):
                for i in range(s):
                    valid = r_ids[t, i] >= 0
                    if i == t or not np.any(valid):
                        continue
                    self._recv[t].append((
                        i,
                        r_ids[t, i][valid].astype(np.int64),
                        r_rows[t, i][valid],
                        r_cnt[t, i][valid].astype(np.int64),
                    ))
            self._out = [{} for _ in range(s)]
        except BaseException as e:  # noqa: BLE001 — re-raised by collectors
            self._error = e
            raise  # breaks the barrier so every waiter wakes

    def _all_to_all(self, ids, cnt, rows):
        """``recv[t][i] = send[i][t]`` for each padded slab: shard ``i``'s
        ``[S, K(, W)]`` slab on ``devices[i]``, destination ``t``'s
        ``[S, K(, W)]`` column gathered on ``devices[t]``, returned to the
        host.  ``.cpu()`` waits for the copies on the calling thread's
        current stream."""
        s = self.num_shards
        routed = []
        for slab in (ids, cnt, rows):
            send = [torch.from_numpy(slab[i]).to(self.devices[i]) for i in range(s)]
            if len(set(self.devices)) == 1:
                # every shard on one device: one transpose-and-copy there
                recv = torch.stack(send).transpose(0, 1).contiguous().cpu()
            else:
                recv = torch.stack([
                    torch.stack([send[i][t].to(self.devices[t]) for i in range(s)]).cpu()
                    for t in range(s)
                ])
            routed.append(recv.numpy())
        return tuple(routed)


def make_exchange(
    kind: str, root: str, num_shards: int, timeout_s: float = 120.0,
    devices=None,
):
    """Exchange factory: ``'local'`` (file-backed buckets) or ``'mesh'``
    (device all_to_all over ``devices``; thread workers only)."""
    if kind == "local":
        return LocalExchange(root, num_shards, timeout_s=timeout_s)
    if kind == "mesh":
        return MeshExchange(num_shards, devices=devices, timeout_s=timeout_s)
    raise ValueError(f"unknown exchange {kind!r} (want 'local'|'mesh')")


__all__ = [
    "ExchangeAborted",
    "LocalExchange",
    "MeshExchange",
    "make_exchange",
]
