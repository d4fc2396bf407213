"""Per-API HTTP statistics (counterpart of minio_tpu/admin/stats.py,
reference cmd/http-stats.go:32,139).

Feeds both the admin server-info API and the Prometheus exporter.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class _APIStat:
    count: int = 0
    errors: int = 0
    e4xx: int = 0
    e5xx: int = 0
    canceled: int = 0
    total_seconds: float = 0.0
    rx_bytes: int = 0
    tx_bytes: int = 0


class HTTPStats:
    def __init__(self):
        self._mu = threading.Lock()
        self._apis: dict[str, _APIStat] = {}
        # Wall clock kept for display only; every duration computes from
        # the monotonic anchor so an NTP step can never yield a negative
        # uptime or latency.
        self.started = time.time()
        self._started_mono = time.monotonic()
        self.current_requests = 0
        # Live in-flight registry keyed by request id: feeds the
        # minio_tpu_s3_requests_inflight{api} gauge and the admin
        # `top api` view (age, API, trace id per active request).
        self._inflight: dict[str, dict] = {}

    def uptime(self) -> float:
        return time.monotonic() - self._started_mono

    def begin(self, request_id: str = "", api_hint: str = "",
              remote: str = "", api_get=None, tenant_get=None) -> float:
        """api_get: optional zero-arg callable resolving the request's
        API once dispatch has classified it (the hint is the HTTP method
        until then). tenant_get: same lazy contract for the tenant key
        (bound by dispatch after auth)."""
        t0 = time.perf_counter()
        with self._mu:
            self.current_requests += 1
            if request_id:
                self._inflight[request_id] = {
                    "t0": t0, "api": api_hint or "unknown",
                    "remote": remote, "api_get": api_get,
                    "tenant_get": tenant_get}
        return t0

    def _resolve_api(self, entry: dict) -> str:
        get = entry.get("api_get")
        if get is not None:
            try:
                api = get()
                if api:
                    return api
            except Exception:  # noqa: BLE001 - view must never fail
                pass
        return entry["api"]

    @staticmethod
    def _resolve_tenant(entry: dict) -> str:
        get = entry.get("tenant_get")
        if get is not None:
            try:
                tenant = get()
                if tenant:
                    return tenant
            # The callback reads state of the handler thread; a race there
            # degrades one cell of the admin view to "-", never the view.
            except Exception:  # noqa: BLE001
                pass
        return "-"

    def inflight(self) -> list[dict]:
        """Snapshot of active requests, oldest first. trace_id == the
        request id (the shared identifier across trace/audit records);
        tenant is the key dispatch bound after auth, "-" before it."""
        now = time.perf_counter()
        with self._mu:
            items = list(self._inflight.items())
        out = [{"trace_id": rid,
                "api": self._resolve_api(e),
                "tenant": self._resolve_tenant(e),
                "ageMs": round((now - e["t0"]) * 1000, 3),
                "remote": e["remote"]}
               for rid, e in items]
        out.sort(key=lambda d: -d["ageMs"])
        return out

    def inflight_by_api(self) -> dict[str, int]:
        with self._mu:
            items = list(self._inflight.values())
        by_api: dict[str, int] = {}
        for e in items:
            api = self._resolve_api(e)
            by_api[api] = by_api.get(api, 0) + 1
        return by_api

    def leave(self, request_id: str = "") -> None:
        """Take one request out of the in-flight count, before `end`
        counts it (the server leaves just before an answer's last byte
        and ends once it is written)."""
        with self._mu:
            self.current_requests -= 1
            if request_id:
                self._inflight.pop(request_id, None)

    def end(self, api: str, t0: float, status: int,
            rx: int = 0, tx: int = 0, canceled: bool = False,
            request_id: str = "", left: bool = False) -> None:
        """Count one finished request; `left`: it already left the
        in-flight count."""
        if not left:
            self.leave(request_id)
        dt = time.perf_counter() - t0
        with self._mu:
            st = self._apis.setdefault(api, _APIStat())
            st.count += 1
            st.total_seconds += dt
            st.rx_bytes += rx
            st.tx_bytes += tx
            if canceled:
                # A client disconnect is neither a 4xx nor a 5xx — it gets
                # its own counter and stays out of the error rate.
                st.canceled += 1
            elif status >= 500:
                st.errors += 1
                st.e5xx += 1
            elif status >= 400:
                st.errors += 1
                st.e4xx += 1

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "uptime": self.uptime(),
                "currentRequests": self.current_requests,
                "apis": {
                    name: {"count": s.count, "errors": s.errors,
                           "4xx": s.e4xx, "5xx": s.e5xx,
                           "canceled": s.canceled,
                           "totalSeconds": round(s.total_seconds, 6),
                           "rxBytes": s.rx_bytes, "txBytes": s.tx_bytes}
                    for name, s in self._apis.items()},
            }
