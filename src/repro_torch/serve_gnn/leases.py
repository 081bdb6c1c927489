"""Cross-process pin leases for published servable versions.

``AtlasSession`` refcounts its own readers in process memory, which is
enough for one publishing process but invisible to every other one: a
second serving process pinning a version could not stop the publisher's
GC from deleting it.  Leases make pins *durable coordination state*:

* every pinned reader drops a **lease file** under the pinned version's
  directory (``v<epoch>/.leases/<pid>-<token>.lease``) recording its
  pid, and refreshes the file's mtime from a heartbeat thread;
* ``gc``/``publish`` treat a version with any **live** lease exactly
  like an in-process pin — it survives — after first **reaping stale
  leases**: a lease is stale once its heartbeat mtime is older than the
  TTL *and* its recorded pid is no longer alive, so a crashed reader
  releases its pin automatically after one TTL while a merely slow
  heartbeat (live pid) never loses it;
* the pin-acquire / GC-retire critical sections are serialized across
  processes by an ``flock`` on ``<store root>/.atlas.lock``
  (``store_lock``), closing the window where a reader picks a version
  from the manifest and a concurrent GC deletes it before the lease
  lands.

Lease files are transient coordination state, not data: they are never
fsynced (a crash loses the lease, which is exactly the reap semantics
above) and live inside the version directory so GC's ``rmtree`` of a
retired version cleans them up for free.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import json
import os
import threading
import time
import uuid

try:  # POSIX only; the serving tier targets linux hosts
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None

#: default lease TTL in seconds — a dead reader's pin outlives it by at
#: most this long.  Heartbeats refresh at TTL/4, so four missed beats
#: plus a dead pid are needed before a lease is reaped.
DEFAULT_LEASE_TTL = 30.0

LEASE_DIR = ".leases"
LOCK_FILE = ".atlas.lock"


def lease_dir(version_dir: str) -> str:
    return os.path.join(version_dir, LEASE_DIR)


def pid_alive(pid: int) -> bool:
    """Is ``pid`` a live process on this host?  ``EPERM`` counts as
    alive (the process exists, we just may not signal it)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError as e:  # pragma: no cover - exotic platforms
        return e.errno != errno.ESRCH
    return True


@dataclasses.dataclass(frozen=True)
class LeaseInfo:
    """One on-disk lease as observed by a scan."""

    path: str
    pid: int
    created_at: float
    mtime: float

    def age(self, now: float | None = None) -> float:
        return (time.time() if now is None else now) - self.mtime


def _read_lease(path: str) -> LeaseInfo | None:
    """Parse one lease file; None when it vanished mid-scan or is
    unreadable garbage (an interrupted writer's leftovers — the reaper
    treats those as pid 0, i.e. dead)."""
    try:
        mtime = os.stat(path).st_mtime
        with open(path) as f:
            data = json.load(f)
        return LeaseInfo(
            path=path,
            pid=int(data.get("pid", 0)),
            created_at=float(data.get("created_at", 0.0)),
            mtime=mtime,
        )
    except FileNotFoundError:
        return None
    except (ValueError, OSError):
        return LeaseInfo(path=path, pid=0, created_at=0.0, mtime=0.0)


def list_leases(version_dir: str) -> list[LeaseInfo]:
    """Every lease currently recorded under ``version_dir`` (live or
    stale — no reaping)."""
    d = lease_dir(version_dir)
    try:
        names = sorted(os.listdir(d))
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        if not name.endswith(".lease"):
            continue
        info = _read_lease(os.path.join(d, name))
        if info is not None:
            out.append(info)
    return out


def reap_stale(
    version_dir: str, ttl: float = DEFAULT_LEASE_TTL, now: float | None = None
) -> list[LeaseInfo]:
    """Remove leases whose heartbeat is older than ``ttl`` AND whose pid
    is dead; returns the reaped leases.  A live pid keeps its lease no
    matter how stale the mtime (a stalled-but-alive reader must never
    lose its pin); a dead pid keeps it until the TTL expires (guards
    against clock skew and a reader observed mid-exit)."""
    now = time.time() if now is None else now
    reaped = []
    for info in list_leases(version_dir):
        if info.age(now) <= ttl or pid_alive(info.pid):
            continue
        try:
            os.remove(info.path)
            reaped.append(info)
        except FileNotFoundError:
            pass
    return reaped


def live_leases(
    version_dir: str, ttl: float = DEFAULT_LEASE_TTL, now: float | None = None
) -> list[LeaseInfo]:
    """Reap stale leases, then return what survives — the set of pins GC
    must honor.  Every surviving lease counts (conservative: an
    un-reapable lease keeps the version on disk)."""
    reap_stale(version_dir, ttl=ttl, now=now)
    return list_leases(version_dir)


class PinLease:
    """One process's pin on one published version directory.

    Acquiring writes the lease file atomically (tmp + rename) and starts
    a daemon heartbeat thread refreshing its mtime every ``ttl/4``
    seconds; ``release`` stops the heartbeat and removes the file.
    Idempotent and usable as a context manager.  The version directory
    itself may already be gone on release (GC of an already-closed
    session raced us) — that is not an error.
    """

    def __init__(
        self,
        version_dir: str,
        ttl: float = DEFAULT_LEASE_TTL,
        heartbeat: bool = True,
        pid: int | None = None,
    ):
        self.version_dir = version_dir
        self.ttl = float(ttl)
        self.pid = os.getpid() if pid is None else int(pid)
        d = lease_dir(version_dir)
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(
            d, f"{self.pid}-{uuid.uuid4().hex[:8]}.lease"
        )
        payload = json.dumps(
            {"pid": self.pid, "created_at": time.time()}
        )
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self.path)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if heartbeat:
            self._thread = threading.Thread(
                target=self._beat, name="atlas-lease-heartbeat", daemon=True
            )
            self._thread.start()

    def _beat(self) -> None:
        interval = max(0.05, self.ttl / 4.0)
        while not self._stop.wait(interval):
            try:
                os.utime(self.path)
            except (FileNotFoundError, OSError):
                # reaped or the version dir was force-removed: nothing
                # left to keep alive
                return

    @property
    def released(self) -> bool:
        return self._stop.is_set()

    def release(self, join: bool = True) -> None:
        """Remove the lease and stop the heartbeat.  ``join=False``
        skips waiting for the heartbeat thread (it notices the stop
        event at its next tick) — used from GC finalizers, which must
        not block."""
        if self._stop.is_set():
            return
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            os.remove(self.path)
        except (FileNotFoundError, OSError):
            pass

    def __enter__(self) -> "PinLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@contextlib.contextmanager
def store_lock(store_root: str):
    """Exclusive cross-process critical section for one store: pin
    acquisition (manifest read + lease write) and GC retirement
    decisions run under it, so a reader can never pick a version that a
    concurrent GC is deleting.  Advisory ``flock`` on
    ``<root>/.atlas.lock`` — held only for the (tiny) decision window,
    never across file I/O of actual version data."""
    path = os.path.join(store_root, LOCK_FILE)
    if fcntl is None:  # pragma: no cover - non-POSIX: degrade to no-op
        yield
        return
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


__all__ = [
    "DEFAULT_LEASE_TTL",
    "LeaseInfo",
    "PinLease",
    "lease_dir",
    "list_leases",
    "live_leases",
    "pid_alive",
    "reap_stale",
    "store_lock",
]
