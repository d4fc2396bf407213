"""Per-request condition context for the non-S3 auth planes (the
port's copy of minio_tpu/iam/reqctx.py).

The S3 front door threads its condition context explicitly into every
`_check_access` call (that explicitness is the subsystem's contract).
The console and admin planes authorize through helpers whose call sites
don't carry the request, so they share this single task-local slot: set
once at dispatch, read inside the authorization check. One mechanism —
a future auth entry point that forgets to set it gets the empty context
(conditioned Allows never match; unevaluable blocks still deny), and
there is exactly one place to look for why.

Thread-local via contextvars (the port's front door answers each
connection on its own thread, and dispatch sets the slot anew for every
request), so concurrent requests cannot observe each other's context.
"""

from __future__ import annotations

import contextvars

_CTX: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "mtpu-cond-ctx", default=None)


def set_condition_context(ctx: dict) -> None:
    """Install the request's condition values for this task (call at
    dispatch, after identity resolution)."""
    _CTX.set(ctx)


def get_condition_context() -> dict:
    """The installed context, or {} when the entry point didn't set one."""
    return _CTX.get() or {}
