"""Fault-injection fabric for the inter-node RPC transport (counterpart
of minio_tpu/dist/faultplane.py; the same rules, matching and draws).

Role-equivalent of the reference's network-fault shell harnesses
(buildscripts/verify-healing.sh kills processes; the Go race tests use
custom net.Conn wrappers) folded into a deterministic, rule-driven plane
the RestClient consults at three points of every fabric call:

  connect  — before a socket is created (refusal = partition)
  request  — before the request is written (delay / mid-call reset)
  response — while the body is read (truncation / corruption)

Rules are matched by (src node, dst peer, route) and fire a bounded
number of times; named partitions (symmetric or asymmetric, healable at
runtime) compile down to connection-refusal checks. All randomness
(delay jitter) comes from per-rule `random.Random` children seeded from
the plane seed, so the same seed always yields the same fault schedule —
chaos tests replay bit-identically (`schedule()` previews the draws
without consuming them).

The plane is process-global but *addressed*: in-process multi-node tests
give every node's clients a `fault_src` identity, so an asymmetric
partition (A→B dead, B→A alive) works with both nodes in one process.
Install from tests via `install()`, or over the guarded admin `faults`
route (`apply_admin`); when nothing is installed the RestClient pays one
module-attribute read per call.
"""

from __future__ import annotations

import random
import threading

# Rule actions.
REFUSE = "refuse"        # connect raises ConnectionRefusedError (zero sockets)
DELAY = "delay"          # sleep delay+jitter before the request is written
RESET = "reset"          # ConnectionResetError as the request is written
TRUNCATE = "truncate"    # response body cut after `after_bytes`, then reset
CORRUPT = "corrupt"      # response bytes XOR-flipped (payload, not transport)

_ACTIONS = (REFUSE, DELAY, RESET, TRUNCATE, CORRUPT)


class FaultRule:
    """One programmable fault. Match fields are exact (or None = any):
    `src` / `peer` are node identities ("host:port", the ADVERTISED S3
    address in a cluster), `route` is the RPC method name (the last path
    segment, e.g. "read_version"), `plane` the path's plane segment.
    `times` bounds how often the rule fires (None = forever)."""

    __slots__ = ("action", "src", "peer", "route", "plane", "delay",
                 "jitter", "after_bytes", "xor", "times", "fired", "_rng")

    def __init__(self, action: str, *, src: str | None = None,
                 peer: str | None = None, route: str | None = None,
                 plane: str | None = None, delay: float = 0.0,
                 jitter: float = 0.0, after_bytes: int = 0,
                 xor: int = 0xFF, times: int | None = None, seed: int = 0):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        self.action = action
        self.src = src
        self.peer = peer
        self.route = route
        self.plane = plane
        self.delay = float(delay)
        self.jitter = float(jitter)
        self.after_bytes = int(after_bytes)
        self.xor = int(xor) & 0xFF
        self.times = times
        self.fired = 0
        self._rng = random.Random(seed)

    def matches(self, src: str, peer: str, route: str, plane: str) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return ((self.src is None or self.src == src)
                and (self.peer is None or self.peer == peer)
                and (self.route is None or self.route == route)
                and (self.plane is None or self.plane == plane))

    def draw_delay(self) -> float:
        if self.jitter <= 0:
            return self.delay
        return self.delay + self._rng.uniform(0.0, self.jitter)

    def describe(self) -> dict:
        return {"action": self.action, "src": self.src, "peer": self.peer,
                "route": self.route, "plane": self.plane,
                "delay": self.delay, "jitter": self.jitter,
                "afterBytes": self.after_bytes, "times": self.times,
                "fired": self.fired}


class FaultPlane:
    """Rule set + named partitions, consulted by every RestClient."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._mu = threading.Lock()
        self._rules: list[FaultRule] = []
        # name -> list of (src, dst) one-way refusal edges.
        self._partitions: dict[str, list[tuple[str, str]]] = {}

    # -- programming ---------------------------------------------------

    def add_rule(self, action: str, **kw) -> FaultRule:
        """Child seeds derive from (plane seed, rule index): the same
        programming order under the same seed replays the same jitter."""
        with self._mu:
            rule = FaultRule(action, seed=hash((self.seed, len(self._rules)))
                             & 0x7FFFFFFF, **kw)
            self._rules.append(rule)
            return rule

    def partition(self, name: str, *groups) -> None:
        """Symmetric named partition: every cross-group (src, dst) pair
        refuses connections, both directions."""
        edges = []
        gs = [list(g) for g in groups]
        for i, ga in enumerate(gs):
            for gb in gs[i + 1:]:
                for a in ga:
                    for b in gb:
                        edges.append((a, b))
                        edges.append((b, a))
        with self._mu:
            self._partitions[name] = edges

    def isolate(self, name: str, src: str, dst: str) -> None:
        """Asymmetric edge: src can no longer reach dst (dst→src stays
        alive — the half-partition a broken switch port produces)."""
        with self._mu:
            self._partitions.setdefault(name, []).append((src, dst))

    def heal(self, name: str) -> bool:
        with self._mu:
            return self._partitions.pop(name, None) is not None

    def clear(self) -> None:
        with self._mu:
            self._rules.clear()
            self._partitions.clear()

    def describe(self) -> dict:
        with self._mu:
            return {"seed": self.seed,
                    "rules": [r.describe() for r in self._rules],
                    "partitions": {n: [list(e) for e in edges]
                                   for n, edges in self._partitions.items()}}

    # -- matching ------------------------------------------------------

    @staticmethod
    def _route_of(path: str) -> tuple[str, str]:
        """("plane", "method") from /rpc/{plane}/v1/{method}; bare paths
        (the probe's /health) match as plane="", route=path."""
        parts = path.strip("/").split("/")
        if len(parts) == 4 and parts[0] == "rpc":
            return parts[1], parts[3]
        return "", path.strip("/")

    def _take(self, action: str, src: str, peer: str, path: str
              ) -> FaultRule | None:
        plane, route = self._route_of(path)
        with self._mu:
            for r in self._rules:
                if r.action == action and r.matches(src, peer, route, plane):
                    r.fired += 1
                    return r
        return None

    def partitioned(self, src: str, peer: str) -> bool:
        with self._mu:
            for edges in self._partitions.values():
                if (src, peer) in edges:
                    return True
        return False

    # -- hooks (called by RestClient) ----------------------------------

    def on_connect(self, src: str, peer: str, path: str = "") -> None:
        """Raises ConnectionRefusedError before any socket exists when a
        partition or refusal rule covers (src → peer). `path` is the
        request the connection is being opened FOR, so route/plane
        matchers apply to refusals too (a route-scoped REFUSE fires at
        establishment; a pooled keep-alive conn sidesteps it by design —
        use a partition to cut live links). The probe loop rides the
        same hook, so a partitioned peer stays OPEN until the partition
        heals."""
        if self.partitioned(src, peer):
            raise ConnectionRefusedError(
                f"faultplane: partition {src or '?'} -> {peer}")
        if self._take(REFUSE, src, peer, path) is not None:
            raise ConnectionRefusedError(
                f"faultplane: refused {src or '?'} -> {peer}")

    def on_request(self, src: str, peer: str, path: str) -> None:
        """Delay and mid-call reset faults, applied as the request is
        about to be written (inside the caller's transport try block, so
        a raised reset degrades exactly like a real one). A named
        partition also bites HERE, not just at connect: a live link cut
        resets established keep-alive connections too — without this, a
        warm connection pool would tunnel straight through the
        partition."""
        import time as _time

        if self.partitioned(src, peer):
            raise ConnectionResetError(
                f"faultplane: partition {src or '?'} -> {peer} "
                f"(established connection reset)")
        rule = self._take(DELAY, src, peer, path)
        if rule is not None:
            _time.sleep(rule.draw_delay())
        if self._take(RESET, src, peer, path) is not None:
            raise ConnectionResetError(
                f"faultplane: reset {src or '?'} -> {peer} {path}")

    def response_fault(self, src: str, peer: str, path: str
                       ) -> FaultRule | None:
        """Claim a truncation/corruption rule for this call's response
        body (consumed now so `times` counts calls, not reads)."""
        rule = self._take(TRUNCATE, src, peer, path)
        if rule is not None:
            return rule
        return self._take(CORRUPT, src, peer, path)

    # -- determinism (tests) -------------------------------------------

    def schedule(self, n: int) -> list[tuple[str, float]]:
        """Preview the next `n` jitter draws per rule WITHOUT consuming
        them: a pure function of (seed, programming order), so two planes
        programmed identically under one seed preview — and then fire —
        the identical fault schedule."""
        out: list[tuple[str, float]] = []
        with self._mu:
            for r in self._rules:
                rng = random.Random()
                rng.setstate(r._rng.getstate())
                for _ in range(n):
                    d = (r.delay if r.jitter <= 0
                         else r.delay + rng.uniform(0.0, r.jitter))
                    out.append((r.action, d))
        return out


# --- process-global installation ---------------------------------------------

_PLANE: FaultPlane | None = None


def install(plane: FaultPlane | None = None,
            seed: int | None = None) -> FaultPlane:
    """Install the process-global plane. With seed=None the plane seed
    derives from the composed-chaos master (`MTPU_CHAOS_SEED`, via
    chaos.subseed(master, "net")), as in the JAX package. An explicit seed
    overrides — single-plane tests keep their pinning."""
    global _PLANE
    if plane is None and seed is None:
        from minio_tpu_torch import chaos

        seed = chaos.subseed(chaos.master_seed(), "net")
    _PLANE = plane if plane is not None else FaultPlane(seed=seed)
    return _PLANE


def uninstall() -> None:
    global _PLANE
    _PLANE = None


def get() -> FaultPlane | None:
    return _PLANE


def describe() -> dict:
    return {"installed": _PLANE is not None,
            **(_PLANE.describe() if _PLANE is not None else {})}


def apply_admin(doc: dict) -> dict:
    """Apply one document of the admin `faults` route to the global plane
    (installing it on first use). Shapes:
      {"op": "rule", "action": "...", ...FaultRule kwargs}
      {"op": "partition", "name": "...", "groups": [["a:1"], ["b:2"]]}
      {"op": "isolate", "name": "...", "src": "a:1", "dst": "b:2"}
      {"op": "heal", "name": "..."}
      {"op": "clear"}
    """
    plane = _PLANE if _PLANE is not None else install(
        seed=int(doc["seed"]) if doc.get("seed") is not None else None)
    op = doc.get("op", "")
    if op == "rule":
        kw = {k: doc[k] for k in ("src", "peer", "route", "plane", "delay",
                                  "jitter", "times", "xor")
              if doc.get(k) is not None}
        if doc.get("afterBytes") is not None:
            kw["after_bytes"] = doc["afterBytes"]
        plane.add_rule(doc.get("action", ""), **kw)
    elif op == "partition":
        plane.partition(doc.get("name", ""), *doc.get("groups", []))
    elif op == "isolate":
        plane.isolate(doc.get("name", ""), doc.get("src", ""),
                      doc.get("dst", ""))
    elif op == "heal":
        plane.heal(doc.get("name", ""))
    elif op == "clear":
        plane.clear()
    else:
        raise ValueError(f"unknown faultplane op {op!r}")
    return plane.describe()
