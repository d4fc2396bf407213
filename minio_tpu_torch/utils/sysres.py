"""System resource helpers (counterpart of minio_tpu/utils/sysres.py).

A worker raises its own fd limit at boot, as the reference server does
(pkg/sys rlimits): a drive fleet plus many client connections easily
exceed the default soft limit of 1024.
"""

from __future__ import annotations


def maximize_nofile() -> tuple[int, int]:
    """Raise RLIMIT_NOFILE soft -> hard (reference setMaxResources).
    Returns the resulting (soft, hard); never raises."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
            soft = hard
        return soft, hard
    except (ImportError, OSError, ValueError):   # a platform without rlimits
        return -1, -1
