"""Three port node processes on real sockets, for the port's composed
chaos storm (tests/test_torch_chaos.py): the counterpart of
tests/crash_cluster.py, whose nodes are the JAX package's.

Each node is `python -m minio_tpu_torch.s3.server --device cpu` over one
12-drive set at EC 8+4 (4 drives a node, parity 4: write quorum is 8, so
the set takes writes with one node dead), booted with the chaos hooks
armed but inert: `MTPU_FAULT_INJECTION=1` (the guarded admin `faults`
route) and `MTPU_CHAOS_DRIVE_WRAP=1` (a NaughtyDisk over each local
drive). Every wait has a deadline; `stop_all` SIGKILLs whatever is left.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from minio_tpu_torch.chaos.workload import S3Client

ACCESS, SECRET = "chaosroot", "chaosroot-secret1"
N_NODES = 3
DRIVES_PER_NODE = 4
BOOT_TIMEOUT = 90
REPO = str(Path(__file__).resolve().parents[1])


def _free_port_block(n: int, span: int = 1000) -> list[int]:
    """n S3 ports whose RPC companions (+span, the port's default) are
    also free."""
    out: list[int] = []
    p = 21000 + (os.getpid() * 13) % 20000
    while len(out) < n and p < 64000:
        ok = True
        for cand in (p, p + span):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", cand))
            except OSError:
                ok = False
            finally:
                s.close()
        if ok:
            out.append(p)
        p += 1
    assert len(out) == n, "no free port block"
    return out


class Cluster:
    def __init__(self, work: Path, extra_env: dict | None = None):
        self.work = work
        self.ports = _free_port_block(N_NODES)
        self.procs: dict[int, subprocess.Popen | None] = {}
        self.extra_env = dict(extra_env or {})
        self.endpoints = []
        for i in range(N_NODES):
            for d in range(DRIVES_PER_NODE):
                path = work / f"n{i}" / f"d{d}"
                path.parent.mkdir(parents=True, exist_ok=True)
                self.endpoints.append(f"http://127.0.0.1:{self.ports[i]}{path}")

    def env(self) -> dict:
        env = dict(os.environ)
        env.pop("MTPU_BATCHED_DATAPLANE", None)
        env.pop("MTPU_METAPLANE", None)
        env.update({
            "MTPU_ROOT_USER": ACCESS,
            "MTPU_ROOT_PASSWORD": SECRET,
            "MTPU_FAULT_INJECTION": "1",
            "MTPU_CHAOS_DRIVE_WRAP": "1",
            # Degraded writes drain within the test once faults lift.
            "MTPU_MRF_RETRY_INTERVAL": "0.2",
            "PYTHONPATH": os.pathsep.join(
                [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]),
        })
        env.update(self.extra_env)
        return env

    def node_name(self, i: int) -> str:
        return f"127.0.0.1:{self.ports[i]}"

    def start(self, i: int) -> None:
        log = open(self.work / f"node{i}.log", "ab")
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.s3.server",
             "--address", f"127.0.0.1:{self.ports[i]}", "--parity", "4",
             "--scan-interval", "0", "--device", "cpu", *self.endpoints],
            stdout=log, stderr=log, env=self.env(), cwd=REPO)
        log.close()

    def kill9(self, i: int) -> None:
        p = self.procs[i]
        assert p is not None
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
        self.procs[i] = None

    def stop_all(self) -> None:
        for p in self.procs.values():
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs.values():
            if p is not None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass

    def base(self, i: int) -> str:
        return f"http://127.0.0.1:{self.ports[i]}"

    def client(self, i: int, timeout: float = 60.0) -> S3Client:
        return S3Client(self.base(i), ACCESS, SECRET, timeout=timeout)

    def wait_healthy(self, i: int, timeout: float = BOOT_TIMEOUT) -> None:
        deadline = time.monotonic() + timeout
        last = ""
        while time.monotonic() < deadline:
            p = self.procs[i]
            assert p is not None
            if p.poll() is not None:
                raise AssertionError(f"node{i} exited {p.returncode}: " + self.log_tail(i))
            try:
                r = self.client(i, timeout=2).get("/minio/health/live")
                if r.status_code == 200:
                    return
                last = f"HTTP {r.status_code}"
            except OSError as e:
                last = str(e)
            time.sleep(0.2)
        raise AssertionError(f"node{i} not healthy in {timeout}s ({last}): "
                             + self.log_tail(i))

    def log_tail(self, i: int) -> str:
        return (self.work / f"node{i}.log").read_text(errors="replace")[-2000:]

    # -- the chaos plane ---------------------------------------------------

    def fault(self, i: int, doc: dict) -> dict:
        """One fault document on node i's guarded admin route."""
        r = self.client(i, timeout=15).post("/minio/admin/v3/faults",
                                            data=json.dumps(doc).encode())
        assert r.status_code == 200, f"fault {doc} on node{i}: {r.content[:300]!r}"
        return json.loads(r.content)

    def admin_info(self, i: int) -> dict:
        r = self.client(i, timeout=15).get("/minio/admin/v3/info")
        assert r.status_code == 200, r.content[:300]
        return json.loads(r.content)

    def deep_heal(self, i: int, bucket: str, timeout: float = 120) -> list:
        r = self.client(i, timeout=timeout).post(
            f"/minio/admin/v3/heal/{bucket}",
            data=json.dumps({"dryRun": False, "scanMode": "deep"}).encode())
        assert r.status_code == 200, r.content[:300]
        return json.loads(r.content)["items"]

    def wait_drives_online(self, timeout: float = 60) -> None:
        want = N_NODES * DRIVES_PER_NODE
        deadline = time.monotonic() + timeout
        counts: list = []
        while time.monotonic() < deadline:
            counts = [self.admin_info(i).get("drivesOnline", 0)
                      for i in range(N_NODES) if self.procs.get(i) is not None]
            if counts and all(n == want for n in counts):
                return
            time.sleep(0.3)
        raise AssertionError(f"drives did not come online: {counts} != {want}")
