"""One front-door worker: the port's full S3 server in a process of its own
(counterpart of minio_tpu/frontdoor/worker.py, on the stdlib server).

Spawned by the supervisor (`python -m minio_tpu_torch.frontdoor.worker`)
with its identity in the environment: `MTPU_FRONTDOOR_WORKER` (id),
`MTPU_FRONTDOOR_WORKERS` (pool width), `MTPU_WAL_SEGMENT` (its WAL
segment), and optionally `MTPU_FRONTDOOR_RING` (the shared lane ring) and
`MTPU_FRONTDOOR_CONTROL` (the router's control socket). The worker:

- builds its server without binding (`build_server(..., listen=False)`):
  under the router it serves the connections the supervisor passes it,
  under `reuseport` it listens on the shared address itself;
- threads its identity into obs (`node` = `<addr>#w<id>` on every trace
  record, `X-Mtpu-Worker` on every response,
  `minio_tpu_frontdoor_requests_total{worker}`,
  `minio_tpu_frontdoor_worker_up{worker}`);
- worker 0 serves the lane ring and hosts the hot tier and the
  auto-healer; the others submit their lane work over the ring;
- drains on SIGTERM (or when the router's end closes): stops taking
  connections, lets the requests in flight finish inside
  `MTPU_FRONTDOOR_DRAIN_S`, closes its WAL segments and exits 0.

Each worker also mirrors its flight recorder and its SLO engine's latest
evaluation into shm spools of its own (`_arm_flight`, `_arm_slo`), which
its siblings read at query time: perf/timeline and slo answer for the
whole pool from any worker.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from minio_tpu_torch import frontdoor, obs

_REQS = obs.counter(
    "minio_tpu_frontdoor_requests_total",
    "Requests served, by front-door worker", ("worker",))
_UP = obs.gauge(
    "minio_tpu_frontdoor_worker_up",
    "1 while this front-door worker is serving", ("worker",))

_log = logging.getLogger("minio_tpu_torch.frontdoor")


def _arm_shared_lanes(wid: int, srv, device):
    """Wire this worker into the lane ring (worker 0 serves it, the rest
    submit to it); returns a stop callable. The hot tier rides the same
    ring: worker 0 owns the one tier and registers its object layer as
    the tier's admit reader; siblings probe it over OP_HOTGET."""
    from minio_tpu_torch import dataplane, hottier
    from minio_tpu_torch.frontdoor import laneserver, shm

    name = frontdoor.ring_name()
    if not (frontdoor.shared_lanes() and name and dataplane.enabled()):
        return lambda: None
    try:
        ring = shm.Ring.attach(name)
    except (OSError, ValueError):
        return lambda: None  # no ring: the local plane serves
    if wid == 0:
        server = laneserver.LaneServer(ring, worker=wid, device=device)
        if hottier.enabled():
            hottier.set_reader(lambda b, o, _l=srv.obj: _l.get_object(b, o))

        def stop():
            hottier.set_reader(None)
            server.stop()
            ring.close()

        return stop
    client = laneserver.LaneClient(ring, wid, frontdoor.worker_count(),
                                   device=device)
    dataplane.set_router(lambda: client)
    if hottier.enabled():
        hot = laneserver.HotRingClient(client)
        hottier.set_router(lambda: hot)

    def stop():
        dataplane.set_router(None)
        hottier.set_router(None)
        client.close()

    return stop


def _arm_flight(wid: int):
    """Mirror every finished timeline into this worker's shm FlightSpool
    (`<base>w<id>`, base from MTPU_FLIGHT_SPOOL) and read the siblings'
    spools on query, so perf/timeline answers for the whole pool from any
    worker. Returns a stop callable."""
    from minio_tpu_torch.frontdoor import shm
    from minio_tpu_torch.obs import flight

    flight.set_worker(wid)
    base = os.environ.get("MTPU_FLIGHT_SPOOL", "")
    if not (base and flight.armed()):
        return lambda: None
    try:
        spool = shm.FlightSpool.create(f"{base}w{wid}")
    except (OSError, ValueError):
        return lambda: None  # no spool: the local recorder still serves
    flight.attach_sink(spool.put)
    nworkers = frontdoor.worker_count()

    def read_siblings() -> list[dict]:
        # Attach per query: a sibling may have respawned and made its
        # spool anew since the last read.
        out = []
        for o in range(nworkers):
            if o == wid:
                continue
            try:
                sib = shm.FlightSpool.attach(f"{base}w{o}")
            except (OSError, ValueError):
                continue
            try:
                out.extend(sib.read_all())
            finally:
                sib.close()
        return out

    flight.set_sibling_reader(read_siblings)

    def stop():
        flight.attach_sink(None)
        flight.set_sibling_reader(None)
        spool.close()
        spool.unlink()

    return stop


def _arm_slo(wid: int):
    """Mirror this worker's SLO evaluations into its shm StateSpool
    mailbox (`<base>slo<id>`, base from MTPU_SLO_SPOOL) and read the
    siblings' mailboxes on query (obs.slo.collect_local), as _arm_flight
    does for timelines. Returns a stop callable."""
    from minio_tpu_torch.frontdoor import shm
    from minio_tpu_torch.obs import slo, tsdb

    slo.set_worker(wid)
    base = os.environ.get("MTPU_SLO_SPOOL", "")
    if not (base and tsdb.armed()):
        return lambda: None
    try:
        spool = shm.StateSpool.create(f"{base}slo{wid}")
    except (OSError, ValueError):
        return lambda: None  # no spool: this worker's state still serves
    slo.attach_sink(spool.put)
    nworkers = frontdoor.worker_count()

    def read_siblings() -> list[dict]:
        # Attach per query, for the same respawn reason as _arm_flight.
        out = []
        for o in range(nworkers):
            if o == wid:
                continue
            try:
                sib = shm.StateSpool.attach(f"{base}slo{o}")
            except (OSError, ValueError):
                continue
            try:
                out.extend(sib.read_all())
            finally:
                sib.close()
        return out

    slo.set_sibling_reader(read_siblings)

    def stop():
        slo.attach_sink(None)
        slo.set_sibling_reader(None)
        spool.close()
        spool.unlink()

    return stop


def _drain_requests(srv, timeout: float) -> None:
    """Wait until no request is in flight, at most `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while srv.stats.current_requests > 0 and time.monotonic() < deadline:
        time.sleep(0.02)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="minio_tpu_torch front-door worker")
    ap.add_argument("drives", nargs="+")
    ap.add_argument("--address", default="0.0.0.0:9000")
    ap.add_argument("--parity", type=int, default=None)
    ap.add_argument("--set-drives", type=int, default=None)
    ap.add_argument("--versioned", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    # A SIGTERM while the worker boots drains it as soon as it is up.
    draining = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: draining.set())
    signal.signal(signal.SIGINT, lambda *_a: draining.set())

    from minio_tpu_torch.frontdoor import listener
    from minio_tpu_torch.frontdoor.router import WorkerReceiver
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.storage import healthcheck
    from minio_tpu_torch.utils import errors as se
    from minio_tpu_torch.utils import sysres

    sysres.maximize_nofile()
    wid = frontdoor.worker_id() or 0
    wlabel = str(wid)
    srv = build_server(args.drives, os.environ.get("MTPU_ROOT_USER", "minioadmin"),
                       os.environ.get("MTPU_ROOT_PASSWORD", "minioadmin"),
                       device=args.device, address=args.address,
                       parity=args.parity, set_drive_count=args.set_drives,
                       versioned=args.versioned, listen=False)
    obs.set_default_node(f"{args.address}#w{wid}")
    up = _UP.labels(worker=wlabel)
    reqs = _REQS.labels(worker=wlabel)

    def stamp_worker(headers: dict) -> None:
        headers.setdefault("X-Mtpu-Worker", wlabel)
        reqs.inc()

    srv.on_response.append(stamp_worker)
    device = srv.obj.pools[0].sets[0].device
    stop_lanes = _arm_shared_lanes(wid, srv, device)
    stop_flight = _arm_flight(wid)
    stop_slo = _arm_slo(wid)
    if wid == 0:
        # One healer per pool of workers: N healers racing over the same
        # sets would repeat every heal.
        srv.start_auto_heal()

    receiver = None
    control = frontdoor.control_path()
    if frontdoor.shard_policy() == "router" and control:
        # The supervisor gone (drained or dead) means no connection can
        # reach this worker again: drain rather than linger.
        receiver = WorkerReceiver(control, wid, srv.adopt, on_eof=draining.set)
    else:
        host, _, port = args.address.rpartition(":")
        srv.serve_socket(listener.make_listener(
            host or "0.0.0.0", int(port or 9000),
            reuse_port=listener.supports_reuseport()))
    up.set(1)
    _log.info("frontdoor: worker %d serving on %s (%s, pid %d)", wid,
              args.address, device, os.getpid())
    while not draining.wait(0.5):
        pass

    # Stop taking connections first, then let the requests in flight run
    # out inside the drain window.
    if receiver is not None:
        receiver.stop()
    srv.stop_accepting()
    _drain_requests(srv, frontdoor.drain_timeout())
    up.set(0)
    stop_lanes()
    stop_flight()
    stop_slo()
    srv.close()
    # Close this worker's WAL segments: a clean drain leaves nothing for
    # the next mount's replay fold.
    for d in srv.obj.all_drives():
        base = healthcheck.unwrap(d)
        try:
            base.close_wal()
        except (OSError, se.StorageError) as e:
            # Replay at the next mount converges what is left.
            _log.warning("frontdoor drain: wal close: %s", e)
    _log.info("frontdoor: worker %d drained; kernel launches %s", wid,
              kernels.launches())
    return 0


if __name__ == "__main__":
    sys.exit(main())
