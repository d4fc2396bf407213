"""naughty-disk — programmable fault-injection StorageAPI decorator
(counterpart of minio_tpu/chaos/naughty.py, the same programs and admin
documents).

Role-equivalent of cmd/naughty-disk_test.go: wraps a real drive and
returns programmed errors at chosen call indices or for chosen methods,
so failure tests exercise per-call error handling (timeouts, partial
writes, flaky drives) instead of only wrecking files on disk.

Latency injection: per_method_delay maps a method name to seconds of
added latency, or to the HANG sentinel for an indefinite stall;
stream_chunk_delay paces every read() of the streams returned by
read_file_stream / read_file_range_stream (a drive that opens fine but
trickles data). Hung calls block on `release`; clear_faults() sets it.

Every NaughtyDisk registers in a process-wide weak registry, so (1)
`clear_all()` releases every leaked HANG in one sweep (the port tests'
hygiene fixtures), and (2) a server process booted with
`MTPU_CHAOS_DRIVE_WRAP=1` wraps its local drives in ErasureSets and lets
the guarded admin `faults` route program them over HTTP — the drive
plane's mirror of `dist/faultplane.py`'s admin surface.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

# Sentinel for per_method_delay: the call blocks until `release` is set
# (an injected drive hang, the NFS-stall failure mode).
HANG = float("inf")

#: Process opt-in: ErasureSets wraps each LOCAL drive in an (inert)
#: NaughtyDisk between the disk-ID check and the health checker, so the
#: admin faults endpoint can inject drive faults into a live server.
WRAP_ENV = "MTPU_CHAOS_DRIVE_WRAP"

# Every NaughtyDisk ever constructed, weakly: clear_all() must reach
# disks a crashed test abandoned, without pinning them past their set.
_DISKS: "weakref.WeakSet[NaughtyDisk]" = weakref.WeakSet()
_DISKS_MU = threading.Lock()


class NaughtyDisk:
    def __init__(self, inner, per_call: dict[int, Exception] | None = None,
                 per_method: dict[str, Exception] | None = None,
                 default: Exception | None = None,
                 per_method_call: dict | None = None,
                 per_method_delay: dict[str, float] | None = None,
                 stream_chunk_delay: float = 0.0):
        """per_call: {global call index (1-based): error to raise};
        per_method: {method name: error} (every call of that method fails);
        per_method_call: {(method name, k): error} — fail only the k-th
        call OF THAT METHOD (1-based), the reference naughty-disk's
        per-call error matrices; default: raised for any call index not
        in per_call (when set);
        per_method_delay: {method name: seconds | HANG} — sleep before
        forwarding (HANG blocks until self.release is set);
        stream_chunk_delay: seconds slept inside every read() of streams
        returned by read_file_stream/read_file_range_stream."""
        self.inner = inner
        self.per_call = per_call or {}
        self.per_method = per_method or {}
        self.per_method_call = per_method_call or {}
        self.per_method_delay = per_method_delay or {}
        self.stream_chunk_delay = stream_chunk_delay
        self.default = default
        self.calls = 0
        self.method_calls: dict[str, int] = {}
        self.release = threading.Event()  # unsticks HANG'd calls
        self._mu = threading.Lock()
        with _DISKS_MU:
            _DISKS.add(self)

    def _maybe_delay(self, name: str) -> None:
        d = self.per_method_delay.get(name)
        if not d:
            return
        if d == HANG:
            self.release.wait()
        else:
            time.sleep(d)

    def _maybe_fail(self, name: str) -> None:
        with self._mu:
            self.calls += 1
            n = self.calls
            self.method_calls[name] = self.method_calls.get(name, 0) + 1
            mk = self.method_calls[name]
        if name in self.per_method:
            raise self.per_method[name]
        if (name, mk) in self.per_method_call:
            raise self.per_method_call[(name, mk)]
        if n in self.per_call:
            raise self.per_call[n]
        if self.default is not None and self.per_call:
            # default fires only when a per_call program exists and the
            # index is past it (mirrors naughty-disk's defaultErr)
            if n > max(self.per_call):
                raise self.default

    # -- chaos-plane surface ------------------------------------------

    def armed(self) -> bool:
        """Any fault program installed (the post-test leak probe)."""
        return bool(self.per_call or self.per_method
                    or self.per_method_call or self.per_method_delay
                    or self.stream_chunk_delay or self.default is not None)

    def clear_faults(self) -> None:
        """Drop every program and unstick anything blocked on HANG. The
        release event is replaced AFTER being set: threads parked on the
        old event wake, while a fault armed later gets a fresh, unset
        event to block on."""
        self.per_call.clear()
        self.per_method.clear()
        self.per_method_call.clear()
        self.per_method_delay.clear()
        self.stream_chunk_delay = 0.0
        self.default = None
        old = self.release
        self.release = threading.Event()
        old.set()

    def describe(self) -> dict:
        ep = ""
        try:
            ep = self.inner.endpoint()
        # Informational: a drive whose endpoint() faults still gets a row.
        except Exception:  # noqa: BLE001
            ep = f"<{type(self.inner).__name__}>"
        return {"endpoint": ep, "calls": self.calls,
                "perMethodDelay": {k: ("hang" if v == HANG else v)
                                   for k, v in self.per_method_delay.items()},
                "perMethodError": {k: type(v).__name__
                                   for k, v in self.per_method.items()},
                "streamChunkDelay": ("hang"
                                     if self.stream_chunk_delay == HANG
                                     else self.stream_chunk_delay)}

    def __getattr__(self, name: str):
        fn = getattr(self.inner, name)
        if not callable(fn) or name.startswith("_"):
            return fn

        def wrapped(*a, **kw):
            # Specialized read entry points ALSO honor their base
            # method's fault program: a hook keyed on the specific name
            # (per_method, per_method_call or per_method_delay) fires
            # first; otherwise read_file_range_stream falls back to
            # read_file_stream's program.
            prog = name
            if (name == "read_file_range_stream"
                    and name not in self.per_method
                    and name not in self.per_method_delay
                    and not any(k[0] == name
                                for k in self.per_method_call)):
                prog = "read_file_stream"
            # The async group-commit entries honor their sync twins'
            # fault programs: a chaos schedule hanging
            # write_metadata_single / write_all must also hang the
            # two-phase paths.
            if (name == "journal_commit_async"
                    and name not in self.per_method
                    and name not in self.per_method_delay
                    and not any(k[0] == name
                                for k in self.per_method_call)):
                prog = "write_metadata_single"
            if (name == "write_all_async"
                    and name not in self.per_method
                    and name not in self.per_method_delay
                    and not any(k[0] == name
                                for k in self.per_method_call)):
                prog = "write_all"
            self._maybe_fail(prog)
            self._maybe_delay(prog)
            out = fn(*a, **kw)
            if (self.stream_chunk_delay
                    and name in ("read_file_stream",
                                 "read_file_range_stream")):
                return _SlowStream(out, self.stream_chunk_delay,
                                   self.release)
            return out

        return wrapped


class _SlowStream:
    """File-like pacing wrapper: every read sleeps the chunk delay
    (HANG blocks until released) — a drive serving bytes at a trickle."""

    def __init__(self, inner, delay: float, release: threading.Event):
        self._inner = inner
        self._delay = delay
        self._release = release

    def _pace(self) -> None:
        if self._delay == HANG:
            self._release.wait()
        else:
            time.sleep(self._delay)

    def read(self, *a, **kw):
        self._pace()
        return self._inner.read(*a, **kw)

    def read1(self, *a, **kw):
        self._pace()
        return self._inner.read1(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        try:
            self._inner.close()
        # Teardown only: the stream is abandoned, a close error has no
        # consumer.
        except Exception:  # noqa: BLE001
            return


# --- process-wide registry (the chaos plane's drive surface) -----------------


def wrap_enabled() -> bool:
    return os.environ.get(WRAP_ENV, "") == "1"


def wrap_drives(drives: list) -> list:
    """Interpose an inert NaughtyDisk over each LOCAL drive (remote
    drives are reached through the peer's own wrap — injecting on the
    client side would fault one node's VIEW of a healthy drive, which is
    the network plane's job). Called by ErasureSets between the disk-ID
    check and the health checker, so injected hangs exercise the real
    ONLINE→FAULTY→OFFLINE machinery and the sentinel probe."""
    out = []
    for d in drives:
        is_local = getattr(d, "is_local", None)
        if is_local is not None and not is_local():
            out.append(d)
        else:
            out.append(NaughtyDisk(d))
    return out


def _registered() -> list[NaughtyDisk]:
    with _DISKS_MU:
        return list(_DISKS)


def any_present() -> bool:
    """Any NaughtyDisk alive in this process — armed or not. A two-phase
    group-commit submit that is pure memory on a plain drive can BLOCK
    inside an interposed fault program, so such loops run bounded
    whenever an injector exists; the port's loops ask
    erasure/sysstore.py `submits_may_block`, which is True for any drive
    that is not a bare LocalDrive under its health and disk-ID wrappers,
    a NaughtyDisk included."""
    return len(_DISKS) > 0


def any_armed() -> bool:
    return any(nd.armed() for nd in _registered())


def clear_all() -> int:
    """Release every fault program on every live NaughtyDisk in the
    process (HANG sentinels included). Returns how many disks actually
    had something armed — 0 means the sweep was a no-op."""
    cleared = 0
    for nd in _registered():
        if nd.armed():
            cleared += 1
        nd.clear_faults()
    return cleared


def describe() -> list[dict]:
    """Armed disks only: the admin surface reports live faults, not the
    whole (possibly large) inert fleet."""
    return [nd.describe() for nd in _registered() if nd.armed()]


def _match(endpoint_substr: str) -> list[NaughtyDisk]:
    out = []
    for nd in _registered():
        try:
            ep = nd.inner.endpoint()
        # Selection only: a drive that cannot name itself is not
        # addressable by endpoint substring.
        except Exception:  # noqa: BLE001
            continue
        if endpoint_substr in ep:
            out.append(nd)
    return out


def _error_for(name: str) -> Exception:
    from minio_tpu_torch.utils import errors as se

    table = {"faulty": se.FaultyDisk, "notfound": se.DiskNotFound,
             "timeout": se.OperationTimedOut, "io": OSError}
    if name not in table:
        raise ValueError(f"unknown drive error kind {name!r} "
                         f"(one of {sorted(table)})")
    return table[name](f"chaos: injected {name}")


def apply_admin(doc: dict) -> dict:
    """One admin-endpoint drive-fault document (rides the same guarded
    `/minio/admin/v3/faults` route as the network plane). Shapes:
      {"op": "drive", "endpoint": "n1/d0", "method": "create_file",
       "delay": 1.5 | "hang"}                      — latency / hang
      {"op": "drive", "endpoint": ..., "method": ..., "error": "faulty"}
      {"op": "drive_slow", "endpoint": ..., "chunkDelay": 0.05 | "hang"}
      {"op": "drive_clear"[, "endpoint": ...]}     — release programs
    `endpoint` is a substring match on the wrapped drive's endpoint
    path; matching zero drives is an error (a typo'd path must not
    silently no-op the storm)."""
    op = doc.get("op", "")
    if op == "drive_clear":
        sel = doc.get("endpoint", "")
        disks = _match(sel) if sel else _registered()
        for nd in disks:
            nd.clear_faults()
        return {"cleared": len(disks), "drives": describe()}

    disks = _match(doc.get("endpoint", ""))
    if not disks:
        raise ValueError(
            f"no wrapped drive matches endpoint {doc.get('endpoint')!r} "
            f"(is {WRAP_ENV}=1 set on this node?)")
    if op == "drive":
        method = doc.get("method", "")
        if not method:
            raise ValueError("drive fault requires a method name")
        if doc.get("error") is not None:
            err = _error_for(str(doc["error"]))
            for nd in disks:
                nd.per_method[method] = err
        else:
            delay = doc.get("delay", "hang")
            delay = HANG if delay == "hang" else float(delay)
            for nd in disks:
                nd.per_method_delay[method] = delay
    elif op == "drive_slow":
        d = doc.get("chunkDelay", 0.05)
        d = HANG if d == "hang" else float(d)
        for nd in disks:
            nd.stream_chunk_delay = d
    else:
        raise ValueError(f"unknown drive-fault op {op!r}")
    return {"drives": describe()}
