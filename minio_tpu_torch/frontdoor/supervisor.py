"""Worker-pool supervisor: spawn, respawn-on-death, drain (counterpart
of minio_tpu/frontdoor/supervisor.py).

One supervisor process owns N worker processes (worker.py), the shared
lane ring, and the restart policy:

- before any worker starts, the hand-written kernels are built once
  (`ops/kernels.py` `build()`): every worker would otherwise run nvcc at
  its first launch. The supervisor loads nothing and creates no CUDA
  context; each worker is its own process (`subprocess.Popen`, never a
  fork) with its own context.

- boot is staggered: worker 0 comes up first and formats fresh drives
  / replays WAL segments alone (two workers racing an initial format
  would mint conflicting set layouts); the rest spawn once worker 0
  answers its liveness probe.
- a worker that dies unexpectedly is respawned with per-worker
  exponential backoff (`minio_tpu_frontdoor_respawns_total{worker}`),
  and its lane-ring slot range is fenced back to FREE first, so a
  SIGKILL mid-submission can never wedge ring slots.
- drain (SIGTERM to the supervisor, or `drain()`): SIGTERM every
  worker, wait out `MTPU_FRONTDOOR_DRAIN_S`, SIGKILL stragglers,
  unlink the ring.

Its log goes to stdlib `logging` ("minio_tpu_torch.frontdoor").
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time

from minio_tpu_torch import frontdoor, obs

_WORKERS = obs.gauge(
    "minio_tpu_frontdoor_workers",
    "Live front-door worker processes under this supervisor")
_RESPAWNS = obs.counter(
    "minio_tpu_frontdoor_respawns_total",
    "Worker processes respawned after unexpected death", ("worker",))

_BOOT_PROBE_TIMEOUT = 120.0


class Supervisor:
    """Library form of the front door (the CLI in __main__.py and the
    tests both drive this)."""

    def __init__(self, drives: list[str], address: str,
                 workers: int | None = None, *,
                 parity: int | None = None,
                 set_drives: int | None = None,
                 versioned: bool = False,
                 shared_lanes: bool | None = None,
                 env: dict | None = None,
                 log_dir: str = "",
                 device: str = "cuda"):
        self.drives = list(drives)
        self.device = device
        self.address = address
        self.workers = workers if workers is not None \
            else frontdoor.worker_count()
        self.parity = parity
        self.set_drives = set_drives
        self.versioned = versioned
        self.shared_lanes = (frontdoor.shared_lanes()
                             if shared_lanes is None else shared_lanes)
        self.extra_env = dict(env or {})
        self.log_dir = log_dir
        self.shard = frontdoor.shard_policy()
        self.procs: dict[int, subprocess.Popen | None] = {}
        self.ring = None
        self.router = None
        self._draining = False
        self._mu = threading.Lock()
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self._backoff: dict[int, float] = {}
        self._respawn_at: dict[int, float] = {}
        self._spawned_at: dict[int, float] = {}
        self.flight_base = f"mtpu_flt_{os.getpid()}_"
        self._log = logging.getLogger("minio_tpu_torch.frontdoor")

    # -- lifecycle ------------------------------------------------------

    def start(self, wait_live: bool = True) -> "Supervisor":
        if self.device != "cpu":
            from minio_tpu_torch.ops import kernels

            kernels.build()
        if self.shared_lanes:
            from minio_tpu_torch.frontdoor import shm

            self.ring = shm.Ring.create(
                nslots=self.workers * shm.DEFAULT_SLOTS_PER_WORKER)
        if self.shard == "router":
            import tempfile

            from minio_tpu_torch.frontdoor.router import AcceptRouter

            host, _, port = self.address.rpartition(":")
            ctl = os.path.join(tempfile.gettempdir(),
                               f"mtpu-fd-{os.getpid()}-{port}.sock")
            self.router = AcceptRouter(host or "127.0.0.1",
                                       int(port or 9000), ctl)
        self._spawn(0)
        if wait_live or self.workers > 1:
            # Worker 0 must finish the one-time mount work (format,
            # WAL replay fold) before siblings touch the drives.
            self._wait_live(_BOOT_PROBE_TIMEOUT)
        for i in range(1, self.workers):
            self._spawn(i)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="mtpu-frontdoor-supervise")
        self._monitor.start()
        return self

    def _worker_env(self, i: int) -> dict:
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update({
            frontdoor.WORKER_ID_ENV: str(i),
            frontdoor.WORKERS_ENV: str(self.workers),
            # Single-writer WAL ownership: each worker journals into
            # its own per-drive segment (docs/FRONTDOOR.md).
            "MTPU_WAL_SEGMENT": f"w{i}",
            # Flight-recorder spool base: worker i owns shm segment
            # f"{base}w{i}"; siblings attach read-only at query time.
            "MTPU_FLIGHT_SPOOL": self.flight_base,
            # SLO state mailbox base: worker i owns f"{base}slo{i}".
            "MTPU_SLO_SPOOL": self.flight_base,
        })
        if self.ring is not None:
            env[frontdoor.RING_ENV] = self.ring.name
            env[frontdoor.SHARED_LANES_ENV] = "1"
        if self.router is not None:
            env[frontdoor.SHARD_ENV] = "router"
            env[frontdoor.CONTROL_ENV] = self.router.control_path
        else:
            env[frontdoor.SHARD_ENV] = "reuseport"
        return env

    def _spawn(self, i: int) -> None:
        cmd = [sys.executable, "-m", "minio_tpu_torch.frontdoor.worker",
               "--address", self.address, "--device", self.device]
        if self.parity is not None:
            cmd += ["--parity", str(self.parity)]
        if self.set_drives is not None:
            cmd += ["--set-drives", str(self.set_drives)]
        if self.versioned:
            cmd += ["--versioned"]
        cmd += self.drives
        out = subprocess.DEVNULL
        if self.log_dir:
            out = open(os.path.join(self.log_dir, f"worker{i}.log"), "ab")
        try:
            self.procs[i] = subprocess.Popen(
                cmd, env=self._worker_env(i), stdout=out, stderr=out)
        finally:
            if out is not subprocess.DEVNULL:
                out.close()   # the worker holds its own copy
        self._spawned_at[i] = time.monotonic()
        _WORKERS.set(self.alive_count())

    def _wait_live(self, timeout: float) -> None:
        import http.client

        host, _, port = self.address.rpartition(":")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            p = self.procs.get(0)
            if p is not None and p.poll() is not None:
                raise RuntimeError(
                    f"front-door worker 0 exited rc={p.returncode} "
                    "during boot")
            try:
                conn = http.client.HTTPConnection(
                    host or "127.0.0.1", int(port or 9000), timeout=2)
                conn.request("GET", "/minio/health/live")
                ok = conn.getresponse().status == 200
                conn.close()
                if ok:
                    return
            except OSError:
                pass
            time.sleep(0.25)
        raise TimeoutError("front-door worker 0 never became live")

    def wait_workers(self, timeout: float = _BOOT_PROBE_TIMEOUT) -> None:
        """Block until every worker has joined the router (router shard
        policy; a no-op under reuseport), or raise TimeoutError."""
        deadline = time.monotonic() + timeout
        while self.router is not None and time.monotonic() < deadline:
            if len(self.router.workers_connected()) >= self.workers:
                return
            for i, p in list(self.procs.items()):
                if p is not None and p.poll() is not None and not self._monitor:
                    raise RuntimeError(f"front-door worker {i} exited "
                                       f"rc={p.returncode} during boot")
            time.sleep(0.1)
        if self.router is not None:
            raise TimeoutError("front-door workers never all joined the router")

    # -- monitoring -----------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.2):
            with self._mu:
                if self._draining:
                    return
                for i, p in list(self.procs.items()):
                    if p is None or p.poll() is None:
                        # A worker that has served stably earns its
                        # backoff back (a crash loop keeps it).
                        if (p is not None and self._backoff.get(i)
                                and time.monotonic()
                                - self._spawned_at.get(i, 0.0) > 30.0):
                            self._backoff[i] = 0.0
                        continue
                    # Unexpected death: fence the worker's ring slots
                    # (a SIGKILL mid-submission must not wedge them),
                    # then respawn under per-worker backoff.
                    now = time.monotonic()
                    at = self._respawn_at.get(i, 0.0)
                    if now < at:
                        continue
                    back = self._backoff.get(i, 0.0)
                    self._backoff[i] = min(5.0, (back * 2) or 0.5)
                    self._respawn_at[i] = now + self._backoff[i]
                    if self.ring is not None:
                        per = max(1, self.ring.nslots // self.workers)
                        self.ring.reset_range(i * per, (i + 1) * per)
                    if self.router is not None:
                        # Out of the rotation now, not at the next failed
                        # send: workers_connected() then counts only live
                        # workers, and wait_workers() the respawn.
                        self.router.drop(i)
                    self._log.warning(
                        "frontdoor: worker %d died rc=%s; respawning", i,
                        p.returncode)
                    _RESPAWNS.labels(worker=str(i)).inc()
                    self._spawn(i)
            _WORKERS.set(self.alive_count())

    def alive(self) -> list[int]:
        return [i for i, p in self.procs.items()
                if p is not None and p.poll() is None]

    def alive_count(self) -> int:
        return len(self.alive())

    def pid(self, i: int) -> int | None:
        p = self.procs.get(i)
        return p.pid if p is not None and p.poll() is None else None

    # -- chaos / drain --------------------------------------------------

    def kill_worker(self, i: int, sig: int = signal.SIGKILL) -> None:
        """Chaos actuator: signal one worker (the monitor respawns it)."""
        p = self.procs.get(i)
        if p is not None and p.poll() is None:
            p.send_signal(sig)

    def drain(self, timeout: float | None = None) -> None:
        """Graceful stop: SIGTERM all workers, wait out the drain
        window, SIGKILL stragglers, release the ring."""
        timeout = frontdoor.drain_timeout() if timeout is None else timeout
        with self._mu:
            self._draining = True
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(5.0)
        if self.router is not None:
            # Stop accepting FIRST: in-flight requests drain inside the
            # workers' SIGTERM window with no new arrivals behind them.
            self.router.stop()
            self.router = None
        for p in self.procs.values():
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        for p in self.procs.values():
            if p is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    continue
        _WORKERS.set(0)
        if self.ring is not None:
            self.ring.close()
            self.ring.unlink()
            self.ring = None
        # Workers unlink their own flight and SLO spools on a clean drain; sweep
        # whatever a SIGKILLed straggler left behind.
        from multiprocessing import shared_memory

        for i in range(self.workers):
            for name in (f"{self.flight_base}w{i}", f"{self.flight_base}slo{i}"):
                try:
                    stale = shared_memory.SharedMemory(name=name)
                except OSError:
                    continue
                stale.close()
                try:
                    stale.unlink()
                except OSError:
                    pass
