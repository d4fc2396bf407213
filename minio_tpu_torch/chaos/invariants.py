"""Post-storm invariant checks — assert, don't log (counterpart of
minio_tpu/chaos/invariants.py, the same checks and exposition helpers).

Four invariant families, each returning an `InvariantReport` whose
failure text carries the chaos seed (the whole plane is deterministic,
so the seed in an assertion message IS the repro command):

1. **zero lost acknowledged writes** — every key whose ledger history
   settles on an acked PUT must read back 200 with the exact sha256;
   keys with in-flight tails must read back one of the candidate
   generations in full (or 404 where absence is legal). Anything else
   is a lost or torn write. A 5xx is S3's retry contract, not a
   durability verdict: acked keys get a bounded retry window and then
   still fail; never-acked tail keys may sit 503-pending until a deep
   heal purges a below-quorum remnant.
2. **heal convergence** — after the faults clear, every drive returns
   online and a deep heal reports every surviving object fully
   redundant (every per-drive after-state "ok").
3. **SLO** — p99 latency and error rate from the `obs/` histogram and
   counter families, over a DELTA window (two scrapes, or the on-node
   ring through `window_from_ring`), so a long-lived cluster's earlier
   history does not dilute the storm window.
4. **cross-node agreement** — a sample of settled keys reads bit-exact
   through every node's front door.
"""

from __future__ import annotations

import re
import time

from minio_tpu_torch.chaos.ledger import WriteLedger, digest


class InvariantReport:
    def __init__(self, name: str, seed: int):
        self.name = name
        self.seed = seed
        self.failures: list[str] = []
        self.checked = 0

    def fail(self, msg: str) -> None:
        self.failures.append(msg)

    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        if self.ok():
            return f"{self.name}: OK ({self.checked} checks)"
        head = "; ".join(self.failures[:8])
        more = (f" (+{len(self.failures) - 8} more)"
                if len(self.failures) > 8 else "")
        return (f"{self.name}: {len(self.failures)} violation(s): {head}"
                f"{more} — reproduce with MTPU_CHAOS_SEED={self.seed}")

    def assert_ok(self) -> None:
        assert self.ok(), self.summary()


# ---------------------------------------------------------------------------
# 1. zero lost acknowledged writes / no torn reads
# ---------------------------------------------------------------------------

def _get_retrying_5xx(get_fn, key, deadline: float,
                      interval: float = 1.5):
    """One ledger-replay read with bounded patience for 5xx: a 503 is
    the S3 RETRY contract (SlowDown), not a durability verdict — a
    SIGKILL'd node's stale dsync lock 503s reads of that object until
    the lease expires (LOCK_STALE_AFTER), and MRF/breaker drain can
    briefly 503 too. Durability is still asserted: run out the window
    and the caller fails the key exactly as before. `deadline` is an
    absolute monotonic instant SHARED across the whole check — N
    genuinely-lost keys cost one window total, not N windows (the
    transient causes expire on wall clock, not per key)."""
    while True:
        status, body = get_fn(key)
        if status < 500 or time.monotonic() >= deadline:
            return status, body
        time.sleep(interval)


def check_acknowledged_writes(get_fn, ledger: WriteLedger,
                              seed: int = 0,
                              retry_5xx_s: float = 60.0) -> InvariantReport:
    """`get_fn(key) -> (status_code, body_bytes)` — typically a closure
    over one node's S3 client. Replays the whole ledger."""
    rep = InvariantReport("zero-lost-acknowledged-writes", seed)
    retry_deadline = time.monotonic() + retry_5xx_s
    for key, st in sorted(ledger.expected().items()):
        rep.checked += 1
        status, body = get_fn(key)
        if status >= 500 and st.settled is not None:
            # The client holds an ack for SOME generation of this key
            # (a settled PUT or DELETE, possibly with an in-flight
            # tail): 5xx only ever buys the bounded retry window — it
            # can never excuse the key from the checks below.
            status, body = _get_retrying_5xx(get_fn, key, retry_deadline)
        if st.must_exist:
            want = st.settled.sha256
            if status != 200:
                rep.fail(f"{key}: HTTP {status}, acked write "
                         f"(seq {st.settled.seq}, etag "
                         f"{st.settled.etag!r}) lost")
            elif digest(body) != want:
                rep.fail(f"{key}: torn read — {len(body)}B sha "
                         f"{digest(body)[:12]} != acked sha {want[:12]} "
                         f"({st.settled.size}B)")
            continue
        # In-flight tail (or settled delete): any candidate is legal,
        # but ONLY a candidate — and always a complete generation.
        if status == 200:
            got = digest(body)
            if got not in st.candidates:
                rep.fail(f"{key}: read matches no ledgered generation "
                         f"({len(body)}B sha {got[:12]}; candidates "
                         f"{[c[:12] if c else None for c in st.candidates]})")
        elif status == 404:
            if None not in st.candidates:
                rep.fail(f"{key}: 404 but absence is not a legal "
                         f"outcome (candidates "
                         f"{[c[:12] if c else None for c in st.candidates]})")
        elif status >= 500 and st.settled is None:
            # NOTHING on this key was ever acknowledged: a PUT killed
            # mid-flight can leave a below-quorum remnant that 503s
            # until deep heal purges it as dangling — and heal
            # convergence runs AFTER this check. With no ack held,
            # "unavailable pending heal" is a legal landing (neither
            # lost nor torn); 200-with-wrong-bytes and illegal 404s
            # above still fail, and any key with an acked generation
            # already burned the bounded retry window before reaching
            # here and fails in the branch below.
            pass
        else:
            rep.fail(f"{key}: post-storm read failed with HTTP {status}")
    return rep


def check_cross_node_agreement(get_fns: list, ledger: WriteLedger,
                               seed: int = 0,
                               sample: int = 24,
                               retry_5xx_s: float = 60.0) -> InvariantReport:
    """Every node's front door serves the same settled bytes (reads are
    quorum reads, so divergence means split-brain metadata)."""
    rep = InvariantReport("cross-node-agreement", seed)
    retry_deadline = time.monotonic() + retry_5xx_s
    expected = ledger.expected()
    keys = [key for key, st in sorted(expected.items())
            if st.must_exist][:sample]
    for key in keys:
        rep.checked += 1
        want = expected[key].settled.sha256
        for i, fn in enumerate(get_fns):
            status, body = fn(key)
            if status >= 500:
                status, body = _get_retrying_5xx(fn, key, retry_deadline)
            if status != 200 or digest(body) != want:
                rep.fail(f"{key}: node{i} serves HTTP {status} "
                         f"sha {digest(body)[:12] if body else '-'} "
                         f"!= settled {want[:12]}")
    return rep


# ---------------------------------------------------------------------------
# 2. heal convergence
# ---------------------------------------------------------------------------

def check_heal_convergence(info_fn, heal_fn, want_drives: int,
                           seed: int = 0, timeout: float = 90.0,
                           heal_attempts: int = 3) -> InvariantReport:
    """`info_fn() -> admin server-info dict`, `heal_fn() -> heal items`
    (deep scan). Converged means: every drive back online within
    `timeout`, then a deep heal leaves every object either fully
    redundant or purged-as-dangling (the correct fate of a
    partially-applied delete's remnant journals). A heal pass racing
    in-flight MRF work can report transient per-object errors, so
    non-converged passes retry up to `heal_attempts` times."""
    rep = InvariantReport("heal-convergence", seed)
    deadline = time.monotonic() + timeout
    online = -1
    while time.monotonic() < deadline:
        info = info_fn()
        online = info.get("drivesOnline", -1)
        if online == want_drives and info.get("drivesOffline", 1) == 0:
            break
        time.sleep(1.0)
    rep.checked += 1
    if online != want_drives:
        rep.fail(f"drives never converged: {online}/{want_drives} "
                 f"online after {timeout:.0f}s")
        return rep

    for attempt in range(heal_attempts):
        failures: list[str] = []
        checked = 0
        for it in heal_fn():
            checked += 1
            if it.get("purged"):
                continue
            after = it.get("after")
            if not after:
                # No per-drive states: the heal of this object errored
                # (heal_objects yields typed ObjectErrors as items,
                # e.g. a lock conflict) — a convergence failure, never
                # a silent pass.
                failures.append(
                    f"{it.get('bucket')}/{it.get('object')}: heal "
                    f"returned no shard states "
                    f"({it.get('error', 'errored')})")
                continue
            bad = [s for s in after if s.get("state") != "ok"]
            if bad:
                failures.append(
                    f"{it.get('bucket')}/{it.get('object')}: "
                    f"{len(bad)} shard(s) not ok after deep heal "
                    f"({sorted({s.get('state') for s in bad})})")
        rep.checked += checked
        if not failures:
            return rep
        if attempt + 1 < heal_attempts:
            time.sleep(3.0)
    rep.failures.extend(failures)
    return rep


# ---------------------------------------------------------------------------
# 3. SLOs from the obs/ exposition
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)\s*$')


def parse_exposition(text: str) -> dict[tuple[str, tuple], float]:
    """{(family_sample_name, sorted-label-items): value} — enough
    structure to diff two scrapes and fold histogram buckets. Accepts
    both flavors the exporter serves: OpenMetrics exemplar suffixes
    (` # {trace_id=...} v ts`) are stripped before the sample parse."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if " # " in line:
            line = line.split(" # ", 1)[0]
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels = []
        raw = m.group("labels") or ""
        for part in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', raw):
            labels.append(part)
        try:
            val = float(m.group("value"))
        except ValueError:
            continue
        out[(m.group("name"), tuple(sorted(labels)))] = val
    return out


def delta(after: dict, before: dict) -> dict:
    """Per-sample difference (missing-before samples count from 0) —
    the storm window's own traffic on a long-lived cluster."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def histogram_quantile(samples: dict, family: str, q: float,
                       label_filter: dict | None = None) -> float:
    """Linear-interpolated quantile over `{family}_bucket` samples
    (cumulative `le` buckets, merged across label sets passing
    `label_filter`). Returns +inf when the quantile lands in the +Inf
    bucket — callers get an SLO failure, not false comfort."""
    buckets: dict[float, float] = {}
    for (name, labels), v in samples.items():
        if name != f"{family}_bucket":
            continue
        ld = dict(labels)
        if label_filter and any(ld.get(k) != v2
                                for k, v2 in label_filter.items()):
            continue
        le = ld.get("le", "")
        bound = float("inf") if le == "+Inf" else float(le)
        buckets[bound] = buckets.get(bound, 0.0) + v
    if not buckets:
        return 0.0
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = buckets[b]
        if cum >= rank:
            if b == float("inf"):
                return float("inf")
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return prev_bound + (b - prev_bound) * frac
        prev_bound, prev_cum = b, cum
    return float("inf")


def counter_sum(samples: dict, family: str,
                label_filter: dict | None = None) -> float:
    total = 0.0
    for (name, labels), v in samples.items():
        if name != family:
            continue
        ld = dict(labels)
        if label_filter and any(ld.get(k) != v2
                                for k, v2 in label_filter.items()):
            continue
        total += v
    return total


def window_from_ring(tsdb, seconds: float) -> dict:
    """A `check_slos`-ready window from the on-node metric ring
    (obs/tsdb.py) instead of two live scrapes: the ring's snapshots
    share parse_exposition's key shape by construction, so the delta
    drops straight into histogram_quantile/counter_sum/check_slos.
    `tsdb` is an obs.tsdb.TSDB (e.g. minio_tpu_torch.obs.tsdb.get())."""
    _span, window = tsdb.delta_window(seconds)
    return window


def window_from_history(history: list[dict], seconds: float) -> dict:
    """`window_from_ring` over the ring of another process: the entries of
    its GET /minio/admin/v3/slo/history answer (obs/tsdb.py `history()`),
    restored into a local TSDB through the ring's persisted form."""
    import gzip
    import json

    from minio_tpu_torch.obs.tsdb import TSDB

    blob = gzip.compress(json.dumps(
        {"v": 1, "coarse": [[e["t"], e["samples"]] for e in history]}).encode())

    class _Store:
        def read_sys_config(self, key: str) -> bytes:
            return blob

    db = TSDB(families=(), sample_s=3600, persist_s=float("inf"))
    db.attach_store(_Store(), "history")
    return window_from_ring(db, seconds)


def check_slos(window: dict, seed: int = 0, *, p99_bound: float,
               error_rate_bound: float,
               apis: tuple[str, ...] = ("PutObject", "GetObject")
               ) -> InvariantReport:
    """`window` is a delta()'d exposition covering the storm. p99 is
    asserted per API over `minio_tpu_s3_requests_latency_seconds`;
    error rate is 5xx/total across ALL APIs (4xx under churn — 404s on
    deleted keys — is legitimate client behavior, not an outage)."""
    rep = InvariantReport("slo", seed)
    for api in apis:
        rep.checked += 1
        p99 = histogram_quantile(
            window, "minio_tpu_s3_requests_latency_seconds", 0.99,
            {"api": api})
        if p99 > p99_bound:
            rep.fail(f"{api} p99 {p99:.2f}s > SLO {p99_bound:.2f}s")
    total = counter_sum(window, "minio_tpu_s3_requests_total")
    errs = counter_sum(window, "minio_tpu_s3_requests_5xx_errors_total")
    rep.checked += 1
    if total > 0 and errs / total > error_rate_bound:
        rep.fail(f"5xx rate {errs / total:.1%} ({errs:.0f}/{total:.0f})"
                 f" > SLO {error_rate_bound:.1%}")
    return rep
