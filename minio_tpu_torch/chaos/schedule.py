"""Deterministic multi-fault scheduler — one seed, one timeline
(counterpart of minio_tpu/chaos/schedule.py: the same seed gives the same
event list, bit for bit, in either package).

A `ChaosProgram` is a materialized timeline of fault events across the
three planes (drive, network, process). It is built by hand (`add(...)`,
the explicit storms of the tests and of `chip_smoke.py`) or generated
(`generate(...)`, flapping soaks); every random draw comes from
`random.Random` children seeded from `(seed, family)`, so the SAME seed
yields the SAME event list in any process. `schedule(n)` previews events
without consuming anything (the program is immutable once built): the
determinism gate programs twice from one seed, compares the previews,
then compares against what the scheduler applied.

The `ChaosScheduler` walks the timeline against pluggable *actuators*
(callables keyed by event kind). Actuator errors are recorded, never
raised: a storm keeps its remaining schedule even if one injection site
is momentarily unavailable (a node that is SIGKILLed). `applied()` is
the record the replay assertion reads.
"""

from __future__ import annotations

import random
import threading
import time

from minio_tpu_torch.chaos import subseed

# Event kinds — the union of the three fault planes' vocabularies.
DRIVE_HANG = "drive_hang"        # per-method HANG on a drive (naughty)
DRIVE_DELAY = "drive_delay"      # per-method latency on a drive
DRIVE_SLOW = "drive_slow"        # stream chunk pacing on a drive
DRIVE_CLEAR = "drive_clear"      # release a drive's fault programs
NET_PARTITION = "net_partition"  # symmetric named partition
NET_ISOLATE = "net_isolate"      # asymmetric edge (src -> dst dead)
NET_HEAL = "net_heal"            # heal a named partition
KILL = "kill"                    # SIGKILL a node
RESTART = "restart"              # restart a killed node
WORKER_KILL = "worker_kill"      # SIGKILL one front-door worker (the
#                                  supervisor respawns it — the storm
#                                  asserts the respawn SLO separately)

KINDS = (DRIVE_HANG, DRIVE_DELAY, DRIVE_SLOW, DRIVE_CLEAR,
         NET_PARTITION, NET_ISOLATE, NET_HEAL, KILL, RESTART,
         WORKER_KILL)


class ChaosEvent:
    """One scheduled fault. Compared structurally so two programs built
    from the same seed compare equal event-by-event."""

    __slots__ = ("t", "kind", "target", "params")

    def __init__(self, t: float, kind: str, target: str, **params):
        if kind not in KINDS:
            raise ValueError(f"unknown chaos event kind {kind!r}")
        self.t = float(t)
        self.kind = kind
        self.target = target
        self.params = params

    def as_tuple(self) -> tuple:
        return (round(self.t, 6), self.kind, self.target,
                tuple(sorted(self.params.items())))

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChaosEvent)
                and self.as_tuple() == other.as_tuple())

    def __hash__(self) -> int:
        return hash(self.as_tuple())

    def __repr__(self) -> str:
        kv = "".join(f" {k}={v!r}" for k, v in sorted(self.params.items()))
        return f"<t={self.t:.2f}s {self.kind} {self.target}{kv}>"


class ChaosProgram:
    """An ordered, immutable-once-built fault timeline."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.events: list[ChaosEvent] = []

    def add(self, t: float, kind: str, target: str, **params
            ) -> "ChaosProgram":
        self.events.append(ChaosEvent(t, kind, target, **params))
        return self

    def sorted_events(self) -> list[ChaosEvent]:
        # Stable sort: same-instant events keep programming order (the
        # faultplane contract — order IS part of the schedule).
        return sorted(self.events, key=lambda e: e.t)

    def schedule(self, n: int | None = None) -> list[tuple]:
        """Preview the first `n` events (all when None) WITHOUT
        consuming anything — the determinism gate's comparison form."""
        evs = self.sorted_events()
        if n is not None:
            evs = evs[:n]
        return [e.as_tuple() for e in evs]

    def duration(self) -> float:
        return max((e.t for e in self.events), default=0.0)

    def describe(self) -> dict:
        return {"seed": self.seed, "events": self.schedule()}

    # -- generation ----------------------------------------------------

    @classmethod
    def generate(cls, seed: int, duration: float, *,
                 nodes: list[str], drives: list[str],
                 kill_nodes: list[str] | None = None,
                 flap_period: float = 8.0, flap_down: float = 3.0,
                 hang_period: float = 10.0, hang_hold: float = 4.0,
                 hang_methods: tuple[str, ...] = ("create_file",
                                                  "read_version"),
                 kill_at_frac: float = 0.45,
                 restart_after: float = 4.0,
                 worker_kill_targets: list[str] | None = None,
                 worker_kill_period: float = 12.0) -> "ChaosProgram":
        """A flapping storm: partitions cycle on/off around
        `flap_period`, one drive at a time hangs for `hang_hold` around
        `hang_period`, and each of `kill_nodes` is SIGKILL'd once near
        `kill_at_frac * duration` then restarted. Every draw comes from
        per-family child RNGs seeded from (seed, family), so the
        timeline is a pure function of the arguments."""
        prog = cls(seed)
        net_rng = random.Random(subseed(seed, "net-schedule"))
        drive_rng = random.Random(subseed(seed, "drive-schedule"))
        proc_rng = random.Random(subseed(seed, "proc-schedule"))

        # Flapping partitions: victim node cycles out and back.
        t = net_rng.uniform(0.5, 2.0)
        flap = 0
        while t + 1.0 < duration and len(nodes) >= 2:
            victim = net_rng.choice(nodes[1:])  # never the front door
            rest = [n for n in nodes if n != victim]
            name = f"flap-{flap}"
            prog.add(t, NET_PARTITION, victim, name=name, rest=tuple(rest))
            heal_at = min(t + flap_down + net_rng.uniform(0.0, 2.0),
                          duration - 0.5)
            prog.add(heal_at, NET_HEAL, victim, name=name)
            t = heal_at + max(1.0, flap_period - flap_down
                              + net_rng.uniform(-1.0, 1.0))
            flap += 1

        # Rolling drive hangs: one victim at a time, always released.
        t = drive_rng.uniform(1.0, 3.0)
        while t + 0.5 < duration and drives:
            victim = drive_rng.choice(drives)
            method = drive_rng.choice(list(hang_methods))
            prog.add(t, DRIVE_HANG, victim, method=method)
            clear_at = min(t + hang_hold + drive_rng.uniform(0.0, 1.0),
                           duration - 0.25)
            prog.add(clear_at, DRIVE_CLEAR, victim)
            t = clear_at + max(1.0, hang_period - hang_hold
                               + drive_rng.uniform(-1.0, 1.0))

        # One crash per kill-node, jittered around the midpoint.
        for kn in (kill_nodes or []):
            at = duration * kill_at_frac + proc_rng.uniform(0.0, 2.0)
            prog.add(at, KILL, kn)
            prog.add(at + restart_after + proc_rng.uniform(0.0, 1.0),
                     RESTART, kn)

        # Rolling front-door worker kills (no RESTART twin: the
        # supervisor respawns on its own — that IS the thing the storm
        # proves). A fresh RNG family keeps every pre-existing seed's
        # timeline bit-identical when no targets are given.
        if worker_kill_targets:
            wrk_rng = random.Random(subseed(seed, "worker-schedule"))
            t = wrk_rng.uniform(2.0, 5.0)
            while t + 1.0 < duration:
                prog.add(t, WORKER_KILL,
                         wrk_rng.choice(list(worker_kill_targets)))
                t += max(2.0, worker_kill_period
                         + wrk_rng.uniform(-2.0, 2.0))
        return prog


class ChaosScheduler:
    """Executes a program against actuators on a background thread.

    `actuators` maps event kind -> callable(event). Missing kinds and
    raising actuators are recorded as errors in the applied log, never
    raised. `stop()` aborts the remaining timeline (used by teardown);
    `join()` waits for the storm to finish."""

    def __init__(self, program: ChaosProgram, actuators: dict,
                 on_event=None):
        self.program = program
        self.actuators = dict(actuators)
        self.on_event = on_event
        self._applied: list[tuple] = []
        self._errors: list[tuple] = []
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ChaosScheduler":
        self._thread = threading.Thread(target=self._run,
                                        name="chaos-scheduler")
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        for ev in self.program.sorted_events():
            delay = ev.t - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            fn = self.actuators.get(ev.kind)
            try:
                if fn is None:
                    raise KeyError(f"no actuator for {ev.kind!r}")
                fn(ev)
                with self._mu:
                    self._applied.append(ev.as_tuple())
            except Exception as e:  # noqa: BLE001 — storm must continue
                with self._mu:
                    self._errors.append((ev.as_tuple(),
                                         f"{type(e).__name__}: {e}"))
            if self.on_event is not None:
                self.on_event(ev)

    def applied(self) -> list[tuple]:
        with self._mu:
            return list(self._applied)

    def errors(self) -> list[tuple]:
        with self._mu:
            return list(self._errors)

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()
