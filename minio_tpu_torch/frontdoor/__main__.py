"""CLI: boot the multi-process front door.

    python -m minio_tpu_torch.frontdoor --workers 4 --device cuda \
        --address 127.0.0.1:9000 /tmp/d0 ... /tmp/d11

The supervisor stays in the foreground; SIGTERM or SIGINT drains the pool
(stop accepting, finish the requests in flight, close the WAL segments).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from minio_tpu_torch import frontdoor
from minio_tpu_torch.frontdoor.supervisor import Supervisor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="minio_tpu_torch multi-process S3 front door")
    ap.add_argument("drives", nargs="+")
    ap.add_argument("--address", default="0.0.0.0:9000")
    ap.add_argument("--workers", type=int, default=frontdoor.worker_count())
    ap.add_argument("--parity", type=int, default=None)
    ap.add_argument("--set-drives", type=int, default=None)
    ap.add_argument("--versioned", action="store_true")
    ap.add_argument("--shared-lanes", action="store_true",
                    default=frontdoor.shared_lanes())
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")

    sup = Supervisor(args.drives, args.address, args.workers,
                     parity=args.parity, set_drives=args.set_drives,
                     versioned=args.versioned,
                     shared_lanes=args.shared_lanes, device=args.device)
    done = threading.Event()

    def _drain(_sig, _frm):
        done.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    sup.start()
    while not done.wait(0.5):
        pass
    sup.drain()


if __name__ == "__main__":
    main()
