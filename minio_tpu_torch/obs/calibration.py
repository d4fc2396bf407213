"""Per-host calibration profiles: was this node tuned for THIS host?
(counterpart of minio_tpu/obs/calibration.py; the profile file and its
schema are the JAX package's, so either package reads the other's).

The performance gates in env defaults (`MTPU_DP_MAX_WIDTH`,
`MTPU_DP_MAX_RECON_WIDTH`, the hedge-delay policy) were measured on one
host class; a node moved to other hardware would silently serve with
the wrong crossover points. This module makes that drift observable:

- `fingerprint()` — the hardware identity the gates were tuned against:
  cores, page size, the device platform and count and, given a drive
  root, an fsync probe classifying the journal medium.
- `boot(drive0_root)` — at server boot, write the profile (fingerprint
  and gates) to `<drive0>/.mtpu.sys/calibration.json` the first time,
  and on later boots compare against the stored one: a mismatch raises
  `minio_tpu_calibration_stale` to 1 (the stored profile stays in place
  as the tuning evidence).
- `publish_build_info()` exposes the standing
  `minio_tpu_build_info{version,platform,devices}` gauge.

The platform is "gpu" with the count of CUDA devices on a machine with
a card, else "cpu" (the `backend` label of the kernel families); the JAX
package writes its JAX backend's name there.
"""

from __future__ import annotations

import json
import mmap
import os
import sys
import tempfile
import time

from minio_tpu_torch import __version__
from minio_tpu_torch.obs.histogram import gauge

SYS_VOL = ".mtpu.sys"
PROFILE_NAME = "calibration.json"

# Fingerprint keys that must match for a stored profile to still apply to
# this host. `fsync_medium` is the probe's class (order-of-magnitude
# bands), not the raw latency.
COMPARE_KEYS = ("cores", "page_size", "platform", "devices",
                "fsync_medium")

_STALE = gauge(
    "minio_tpu_calibration_stale",
    "1 when the stored calibration profile was tuned on different "
    "hardware than this host")
_BUILD = gauge(
    "minio_tpu_build_info",
    "Constant 1; labels carry build/runtime identity",
    ("version", "platform", "devices"))


def _accel() -> tuple[str, int]:
    """(platform, CUDA device count): ("gpu", n) with a card, else
    ("cpu", 0)."""
    try:
        import torch

        if torch.cuda.is_available():
            return "gpu", torch.cuda.device_count()
    # No working CUDA stack is a valid host class (the CPU), not an error.
    except Exception:  # noqa: BLE001
        pass
    return "cpu", 0


def _probe_fsync(root: str) -> tuple[str, float]:
    """(medium class, median fsync microseconds) measured by fsyncing a
    small file on the drive medium itself. The bands are an order of
    magnitude wide on purpose (see COMPARE_KEYS)."""
    try:
        fd, path = tempfile.mkstemp(prefix=".mtpu-cal-", dir=root)
        try:
            os.write(fd, b"\0" * 4096)
            lats = []
            for _ in range(3):
                os.write(fd, b"\1")
                t0 = time.perf_counter()
                os.fsync(fd)
                lats.append((time.perf_counter() - t0) * 1e6)
        finally:
            os.close(fd)
            os.unlink(path)
        med = sorted(lats)[len(lats) // 2]
        if med < 300.0:
            return "nvme-or-cache", med
        if med < 3000.0:
            return "ssd", med
        return "disk", med
    # An unprobeable medium (read-only, odd mount) reads "unknown": boot
    # must not fail on it.
    except OSError:
        return "unknown", 0.0


def fingerprint(probe_root: str | None = None) -> dict:
    """The host identity. With `probe_root`, it includes the fsync probe
    of that directory's file system."""
    platform, devices = _accel()
    fp = {
        "cores": os.cpu_count() or 1,
        "page_size": mmap.PAGESIZE,
        "platform": platform,
        "devices": devices,
        "python": ".".join(str(v) for v in sys.version_info[:2]),
    }
    if probe_root is not None:
        medium, med_us = _probe_fsync(probe_root)
        fp["fsync_medium"] = medium
        fp["fsync_us"] = round(med_us, 1)
    return fp


def gates() -> dict:
    """The tuned performance gates in force — the values the fingerprint
    vouches for. The port reads every gate the JAX package lists here:
    the two widths of dataplane/batcher.py and the hedge policy of
    erasure/objects.py (four times the rolling shard latency)."""
    env = os.environ.get
    return {
        "MTPU_DP_MAX_WIDTH": int(env("MTPU_DP_MAX_WIDTH", "65536")),
        "MTPU_DP_MAX_RECON_WIDTH": int(
            env("MTPU_DP_MAX_RECON_WIDTH", "16384")),
        "hedge_delay": "adaptive-ewma-4x",
    }


def profile(probe_root: str | None = None) -> dict:
    return {"v": 1, "time": time.time(), "mtpu_version": __version__,
            "fingerprint": fingerprint(probe_root), "gates": gates()}


def stale_against(stored: dict, current: dict) -> list[str]:
    """COMPARE_KEYS whose stored and current fingerprints disagree (a key
    missing on either side is ignored: an older profile is not stale
    after the fact)."""
    sf = (stored or {}).get("fingerprint") or {}
    cf = (current or {}).get("fingerprint") or {}
    return [k for k in COMPARE_KEYS
            if k in sf and k in cf and sf[k] != cf[k]]


def boot(drive0_root: str) -> dict:
    """Write or compare the calibration profile on drive 0 at server
    boot. -> {"profile": current, "stored": previous or None, "stale":
    [mismatched keys]}; sets minio_tpu_calibration_stale."""
    sys_dir = os.path.join(drive0_root, SYS_VOL)
    try:
        os.makedirs(sys_dir, exist_ok=True)
    except OSError:
        pass
    path = os.path.join(sys_dir, PROFILE_NAME)
    cur = profile(probe_root=sys_dir if os.path.isdir(sys_dir)
                  else drive0_root)
    # A corrupt stored profile is treated as absent and rewritten:
    # calibration never blocks a boot.
    try:
        with open(path, encoding="utf-8") as f:
            stored = json.load(f)
    except (OSError, ValueError):
        stored = None
    stale = stale_against(stored, cur) if stored else []
    if stored is None:
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(cur, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass
    _STALE.labels().set(1.0 if stale else 0.0)
    return {"profile": cur, "stored": stored, "stale": stale}


def publish_build_info() -> None:
    """Expose minio_tpu_build_info{version,platform,devices} = 1."""
    platform, devices = _accel()
    _BUILD.set(1.0, version=__version__, platform=platform,
               devices=str(devices))
