"""Prometheus exposition (counterpart of minio_tpu/admin/metrics.py).

Role-equivalent of cmd/metrics-v2.go: cluster/node metric families
rendered in the text format at /minio/v2/metrics/cluster and /node.
Collectors are lazy — gathered per scrape. On a node of a cluster
(dist/), the cluster scrape also pulls every peer's node scrape over the
peer plane and merges them under a `server` label
(collect_cluster_metrics, merge_expositions); the JAX package's SLO
collector is not carried.
"""

from __future__ import annotations

import os

from minio_tpu_torch import obs

# Prometheus text exposition 0.0.4 — scrapers content-negotiate on the
# version parameter; bare text/plain is rejected by strict clients.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4"

# OpenMetrics flavor: same families, plus exemplar annotations on
# histogram buckets and a trailing `# EOF`. Served when the scraper's
# Accept header asks for it.
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")


# Per-peer budget for the federated cluster scrape: stragglers become
# scrape errors, never a hung scrape (the whole fan-out runs under one
# parallel_map deadline).
PEER_SCRAPE_DEADLINE = float(os.environ.get(
    "MTPU_METRICS_PEER_DEADLINE", "2.0"))

_PEER_SCRAPE_ERRORS = obs.counter(
    "minio_tpu_peer_scrape_errors_total",
    "Peer node scrapes that failed or timed out during the federated "
    "cluster scrape", ("peer",))


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class PromText:
    """Text sink for the duck-typed family/sample render contract.
    `openmetrics=True` switches on the exemplar-bearing flavor:
    histogram vecs see `wants_exemplars` and pass captured
    (trace_id, value, ts) tuples, rendered as
    `... # {trace_id="..."} value ts` per the OpenMetrics exemplar
    syntax, and `render()` appends the mandatory `# EOF`."""

    def __init__(self, openmetrics: bool = False):
        self.lines: list[str] = []
        self.openmetrics = openmetrics
        self.wants_exemplars = openmetrics

    def family(self, name: str, help_: str, typ: str = "gauge") -> None:
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {typ}")

    def sample(self, name: str, value, labels: dict | None = None,
               exemplar: tuple | None = None) -> None:
        if labels:
            lbl = ",".join(f'{k}="{_esc(str(v))}"'
                           for k, v in sorted(labels.items()))
            line = f"{name}{{{lbl}}} {value}"
        else:
            line = f"{name} {value}"
        if exemplar is not None and self.openmetrics:
            tid, ex_val, ex_ts = exemplar
            line += (f' # {{trace_id="{_esc(str(tid))}"}} '
                     f"{ex_val} {round(float(ex_ts), 3)}")
        self.lines.append(line)

    def render(self) -> bytes:
        body = "\n".join(self.lines) + "\n"
        if self.openmetrics:
            body += "# EOF\n"
        return body.encode()


def wants_openmetrics(accept: str | None) -> bool:
    """Content negotiation: any Accept mentioning the OpenMetrics media
    type gets the exemplar-bearing flavor."""
    return "application/openmetrics-text" in (accept or "")


def maybe_gzip(body: bytes, accept_encoding: str | None,
               min_size: int = 256) -> tuple[bytes, str | None]:
    """(body, Content-Encoding header value or None): gzip when the
    client advertises it and the body is big enough for the header
    overhead to pay off."""
    if "gzip" in (accept_encoding or "").lower() and len(body) >= min_size:
        import gzip as _gzip

        return _gzip.compress(body, 5), "gzip"
    return body, None


def collect_metrics(object_layer, stats, *, openmetrics: bool = False) -> bytes:
    """The cluster scrape of a deployment of one node (the JAX package's
    collect_metrics, and its federated scrape's answer without peers)."""
    p = PromText(openmetrics)

    # -- process --
    p.family("minio_tpu_process_uptime_seconds", "Server uptime", "counter")
    p.sample("minio_tpu_process_uptime_seconds", round(stats.uptime(), 3))

    # -- per-API request stats --
    snap = stats.snapshot()
    p.family("minio_tpu_s3_requests_total",
             "Total S3 requests by API", "counter")
    p.family("minio_tpu_s3_requests_errors_total",
             "Total S3 requests that errored, by API", "counter")
    p.family("minio_tpu_s3_requests_4xx_errors_total",
             "Total S3 requests that errored with 4xx, by API", "counter")
    p.family("minio_tpu_s3_requests_5xx_errors_total",
             "Total S3 requests that errored with 5xx, by API", "counter")
    p.family("minio_tpu_s3_requests_canceled_total",
             "Total S3 requests canceled by the client, by API", "counter")
    p.family("minio_tpu_s3_requests_seconds_total",
             "Cumulative time serving each API", "counter")
    p.family("minio_tpu_s3_traffic_received_bytes",
             "Bytes received by API", "counter")
    p.family("minio_tpu_s3_traffic_sent_bytes", "Bytes sent by API", "counter")
    for api, s in sorted(snap["apis"].items()):
        lbl = {"api": api}
        p.sample("minio_tpu_s3_requests_total", s["count"], lbl)
        p.sample("minio_tpu_s3_requests_errors_total", s["errors"], lbl)
        p.sample("minio_tpu_s3_requests_4xx_errors_total", s["4xx"], lbl)
        p.sample("minio_tpu_s3_requests_5xx_errors_total", s["5xx"], lbl)
        p.sample("minio_tpu_s3_requests_canceled_total", s["canceled"], lbl)
        p.sample("minio_tpu_s3_requests_seconds_total", s["totalSeconds"], lbl)
        p.sample("minio_tpu_s3_traffic_received_bytes", s["rxBytes"], lbl)
        p.sample("minio_tpu_s3_traffic_sent_bytes", s["txBytes"], lbl)
    p.family("minio_tpu_s3_requests_current", "In-flight S3 requests")
    p.sample("minio_tpu_s3_requests_current", snap["currentRequests"])
    _render_inflight(p, stats)

    # -- drives / capacity --
    online = offline = 0
    total_cap = free_cap = 0
    for d in getattr(object_layer, "all_drives", lambda: [])():
        try:
            di = d.disk_info()
            online += 1
            total_cap += di.total
            free_cap += di.free
        except Exception:  # noqa: BLE001
            offline += 1
    p.family("minio_tpu_cluster_disk_online_total", "Drives online")
    p.sample("minio_tpu_cluster_disk_online_total", online)
    p.family("minio_tpu_cluster_disk_offline_total", "Drives offline")
    p.sample("minio_tpu_cluster_disk_offline_total", offline)
    p.family("minio_tpu_cluster_capacity_raw_total_bytes", "Raw capacity")
    p.sample("minio_tpu_cluster_capacity_raw_total_bytes", total_cap)
    p.family("minio_tpu_cluster_capacity_raw_free_bytes", "Raw free")
    p.sample("minio_tpu_cluster_capacity_raw_free_bytes", free_cap)

    # -- health --
    try:
        healthy = 1 if object_layer.health().get("healthy") else 0
    except Exception:  # noqa: BLE001
        healthy = 0
    p.family("minio_tpu_cluster_health_status",
             "1 when every set holds write quorum")
    p.sample("minio_tpu_cluster_health_status", healthy)

    # -- observability registry (latency/TTFB/drive/kernel histograms,
    #    plane counters, encode gauge — whatever the planes registered) --
    obs.render_into(p)
    _render_trace_dropped(p)
    return p.render()


def _render_trace_dropped(p: PromText) -> None:
    p.family("minio_tpu_trace_dropped_total",
             "Trace records dropped on slow trace subscribers", "counter")
    p.sample("minio_tpu_trace_dropped_total", obs.trace_bus().dropped)


def _render_inflight(p: PromText, stats) -> None:
    """Per-API in-flight gauge from the stats inflight registry (the
    scrape itself always shows as one in-flight `metrics` request)."""
    p.family("minio_tpu_s3_requests_inflight",
             "In-flight S3 requests by API")
    by_api = getattr(stats, "inflight_by_api", dict)()
    for api, n in sorted(by_api.items()):
        p.sample("minio_tpu_s3_requests_inflight", n, {"api": api})


def collect_node_metrics(stats, *, openmetrics: bool = False) -> bytes:
    """Node-scope scrape (/minio/v2/metrics/node): this process's own
    planes — request/TTFB latency, per-drive op latency, RPC fabric —
    without the cluster-wide capacity/usage/health collectors (the
    reference's node vs cluster metrics-v2 split)."""
    p = PromText(openmetrics)
    p.family("minio_tpu_process_uptime_seconds", "Server uptime", "counter")
    p.sample("minio_tpu_process_uptime_seconds", round(stats.uptime(), 3))
    p.family("minio_tpu_s3_requests_current", "In-flight S3 requests")
    p.sample("minio_tpu_s3_requests_current", stats.current_requests)
    _render_inflight(p, stats)
    obs.render_into(p)
    _render_trace_dropped(p)
    return p.render()


# --- cluster federation ------------------------------------------------------


def collect_cluster_metrics(object_layer, stats, *, notification=None,
                            local_name: str = "",
                            deadline: float | None = None,
                            openmetrics: bool = False) -> bytes:
    """The federated cluster scrape (minio_tpu/admin/metrics.py:223): this
    node's cluster collectors plus every peer's node scrape (the peer
    `metrics` route), merged with each source's samples under a `server`
    label. The fan-out runs under one parallel_map deadline: a hung or
    dead peer becomes a `minio_tpu_peer_scrape_errors_total{peer=}`
    increment, and the scrape returns within the deadline. Without peers
    the single-node exposition is returned unchanged."""
    peers = list(notification.peers) if notification is not None else []
    if peers:
        from minio_tpu_torch.erasure.metadata import parallel_map

        results = parallel_map(
            [p.metrics for p in peers],
            deadline=PEER_SCRAPE_DEADLINE if deadline is None else deadline)
        # Counted before the local families render, so this very scrape
        # carries them; an empty body (no metrics hook) is a failure too.
        for p, r in zip(peers, results):
            if isinstance(r, Exception) or not r:
                _PEER_SCRAPE_ERRORS.labels(peer=p.name).inc()
    # Exemplars do not survive the relabeling: the federated scrape is
    # always 0.0.4.
    body = collect_metrics(object_layer, stats,
                           openmetrics=openmetrics and not peers)
    if not peers:
        return body
    texts: list[tuple[str, str]] = [(local_name or "local", body.decode())]
    for p, r in zip(peers, results):
        if isinstance(r, Exception) or not r:
            continue
        texts.append((p.name, bytes(r).decode()))
    return merge_expositions(texts)


def collect_cluster_slo(notification=None, local_name: str = "",
                        deadline: float | None = None) -> dict:
    """The federated /slo answer (minio_tpu/admin/metrics.py:266): this
    node's worker-merged state plus every peer's, pulled over the peer
    `slo` route under the cluster scrape's deadline. A hung or dead peer
    becomes an entry of `errors` and a
    `minio_tpu_peer_scrape_errors_total{peer=}` increment: the fan-out
    returns within the deadline."""
    from minio_tpu_torch.obs import slo as _slo

    out: dict = {"nodes": {local_name or "local": _slo.collect_local()},
                 "errors": []}
    peers = list(notification.peers) if notification is not None else []
    if peers:
        from minio_tpu_torch.erasure.metadata import parallel_map

        results = parallel_map(
            [p.slo for p in peers],
            deadline=PEER_SCRAPE_DEADLINE if deadline is None else deadline)
        for p, r in zip(peers, results):
            if isinstance(r, Exception) or not isinstance(r, dict):
                _PEER_SCRAPE_ERRORS.labels(peer=p.name).inc()
                out["errors"].append(p.name)
                continue
            out["nodes"][p.name] = r
    return out


def merge_expositions(sources: list[tuple[str, str]]) -> bytes:
    """Merge per-node exposition texts into one document: families keep
    one HELP/TYPE block (first seen wins) with every source's samples
    grouped under it, each sample relabeled with server="<node>"."""
    order: list[str] = []                      # family emit order
    heads: dict[str, list[str]] = {}           # family -> HELP/TYPE lines
    rows: dict[str, list[str]] = {}            # family -> relabeled samples
    for server, text in sources:
        for line in text.split("\n"):
            if not line:
                continue
            if line.startswith("# "):
                parts = line.split(" ", 3)
                if len(parts) < 3:
                    continue
                fam = parts[2]
                if fam not in heads:
                    heads[fam] = []
                    order.append(fam)
                    rows[fam] = []
                if len(heads[fam]) < 2:
                    heads[fam].append(line)
                continue
            name_lbl, _, value = line.rpartition(" ")
            if not name_lbl:
                continue
            name = name_lbl.split("{", 1)[0]
            fam = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in heads:
                    fam = name[: -len(suffix)]
                    break
            if fam not in heads:   # sample with no TYPE: pass through
                heads[fam] = []
                order.append(fam)
                rows[fam] = []
            tag = f'server="{_esc(server)}"'
            if name_lbl.endswith("}"):
                relabeled = f"{name_lbl[:-1]},{tag}}} {value}"
            else:
                relabeled = f"{name_lbl}{{{tag}}} {value}"
            rows[fam].append(relabeled)
    out: list[str] = []
    for fam in order:
        out.extend(heads[fam])
        out.extend(rows[fam])
    return ("\n".join(out) + "\n").encode()
