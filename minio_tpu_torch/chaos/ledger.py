"""Write-ahead ledger of acknowledged S3 operations (counterpart of
minio_tpu/chaos/ledger.py: the same rows, audit file and fold).

The ground truth the invariant checker replays after a storm: every
workload client records an *intent* row BEFORE issuing a mutation and an
*ack* row only after the server acknowledged it (2xx with the response
consumed). The split matters under chaos:

- an **acked** mutation is a durability promise — the checker asserts
  it bit-exactly, and a missing acked object is a lost write;
- an **intent without an ack** (connection cut mid-PUT, node SIGKILLed
  before the response) may land EITHER way, but never a third way: a
  read returns one of the candidate generations in full, or 404.
  Anything else is a torn write.

Keys have linear per-key histories (the workload fleet namespaces keys
per worker), so "latest acked op" is well defined by the ledger's global
sequence counter, taken under the ledger lock at intent time.

The ledger is memory-first with an optional append-only JSONL audit
file (one row per intent and ack, flushed per row), so a wedged run
leaves a replayable trail on disk.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class LedgerEntry:
    __slots__ = ("seq", "op", "key", "sha256", "size", "etag",
                 "t_intent", "t_ack", "acked")

    def __init__(self, seq: int, op: str, key: str, sha256: str = "",
                 size: int = 0):
        self.seq = seq
        self.op = op              # "put" | "delete" | "multipart"
        self.key = key
        self.sha256 = sha256
        self.size = size
        self.etag = ""
        self.t_intent = time.time()
        self.t_ack = 0.0
        self.acked = False

    def row(self, phase: str) -> dict:
        return {"phase": phase, "seq": self.seq, "op": self.op,
                "key": self.key, "sha256": self.sha256, "size": self.size,
                "etag": self.etag, "t": time.time()}


class ExpectedState:
    """Post-storm expectation for one key.

    `settled`: the latest ACKED entry (None when no op ever acked).
    `candidates`: every allowed read outcome — digests of acked-or-
    in-flight generations at or after the settled one, plus `None` for
    "absent" when a delete is settled/in flight or no put ever acked."""

    __slots__ = ("key", "settled", "candidates")

    def __init__(self, key: str):
        self.key = key
        self.settled: LedgerEntry | None = None
        self.candidates: list[str | None] = []

    @property
    def must_exist(self) -> bool:
        """True when exactly one outcome is allowed: a settled PUT with
        no in-flight op after it — the zero-lost-write assertion row."""
        return (self.settled is not None and self.settled.op != "delete"
                and self.candidates == [self.settled.sha256])


class WriteLedger:
    def __init__(self, path: str | None = None):
        self._mu = threading.Lock()
        self._entries: list[LedgerEntry] = []
        self._seq = 0
        self._file = open(path, "a", buffering=1) if path else None

    def close(self) -> None:
        with self._mu:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- recording -----------------------------------------------------

    def intent(self, op: str, key: str, data_sha256: str = "",
               size: int = 0) -> LedgerEntry:
        """Write-ahead row: MUST be called before the request is issued,
        so a response lost to the storm still leaves the op visible as
        in-flight (allowed-either, but torn-read-checked)."""
        with self._mu:
            self._seq += 1
            e = LedgerEntry(self._seq, op, key, data_sha256, size)
            self._entries.append(e)
            if self._file is not None:
                self._file.write(json.dumps(e.row("intent")) + "\n")
        return e

    def ack(self, e: LedgerEntry, etag: str = "") -> None:
        """The durability promise: only call with the 2xx response in
        hand. From here on the checker asserts this generation (until a
        later acked op supersedes it)."""
        with self._mu:
            e.etag = etag
            e.t_ack = time.time()
            e.acked = True
            if self._file is not None:
                self._file.write(json.dumps(e.row("ack")) + "\n")

    # -- replay --------------------------------------------------------

    def entries(self) -> list[LedgerEntry]:
        with self._mu:
            return list(self._entries)

    def acked_count(self) -> int:
        return sum(1 for e in self.entries() if e.acked)

    def expected(self) -> dict[str, ExpectedState]:
        """Fold the ledger into per-key expectations (see class doc)."""
        out: dict[str, ExpectedState] = {}
        by_key: dict[str, list[LedgerEntry]] = {}
        for e in self.entries():
            by_key.setdefault(e.key, []).append(e)
        for key, evs in by_key.items():
            st = ExpectedState(key)
            evs.sort(key=lambda e: e.seq)
            last_ack = None
            for e in evs:
                if e.acked:
                    last_ack = e
            st.settled = last_ack
            cands: list[str | None] = []
            if last_ack is None:
                cands.append(None)  # possibly never committed
                tail = evs
            else:
                cands.append(None if last_ack.op == "delete"
                             else last_ack.sha256)
                tail = [e for e in evs if e.seq > last_ack.seq]
            for e in tail:  # in-flight ops after the settled point
                cands.append(None if e.op == "delete" else e.sha256)
            # De-dup, keep order (first entry is the settled outcome).
            seen: set = set()
            st.candidates = [c for c in cands
                             if not (c in seen or seen.add(c))]
            out[key] = st
        return out

    def describe(self) -> dict:
        es = self.entries()
        return {"entries": len(es),
                "acked": sum(1 for e in es if e.acked),
                "inflight": sum(1 for e in es if not e.acked),
                "keys": len({e.key for e in es})}
