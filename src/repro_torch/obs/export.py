"""Host-side metrics snapshots and export (Prometheus text / JSON lines).

``MetricsSnapshot`` is a plain host container assembled by
``engine.metrics()`` at step boundaries: counters and gauges keyed by
Prometheus-style series names (``name{label="v",...}``) plus fixed-bucket
``Histogram`` objects for request latency distributions. Rendering
follows the Prometheus text exposition format (version 0.0.4);
``parse_prometheus`` round-trips what ``render_prometheus`` emits so
tests and the serve CLI's self-scrape can validate scrapes end to end.
"""
from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# default buckets for request-latency histograms (seconds)
LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+Inf, count)."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, self.count))
        return out


@dataclass
class MetricsSnapshot:
    """One point-in-time scrape of an engine's metrics."""
    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    histograms: Dict[str, Histogram] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)

    # series names are "name" or 'name{label="v",label2="v2"}'
    def counter(self, name: str, value: float, **labels: object) -> None:
        self.counters[_series(name, labels)] = float(value)

    def gauge(self, name: str, value: float, **labels: object) -> None:
        self.gauges[_series(name, labels)] = float(value)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets)
        return h

    def merge(self, other: "MetricsSnapshot") -> None:
        self.counters.update(other.counters)
        self.gauges.update(other.gauges)
        self.histograms.update(other.histograms)


def _series(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _base_name(series: str) -> str:
    return series.split("{", 1)[0]


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(snap: MetricsSnapshot) -> str:
    """Prometheus text exposition (0.0.4) of a snapshot."""
    lines: List[str] = []
    seen_type: set = set()

    def type_line(base: str, kind: str) -> None:
        if base not in seen_type:
            seen_type.add(base)
            lines.append(f"# TYPE {base} {kind}")

    for series in sorted(snap.counters):
        type_line(_base_name(series), "counter")
        lines.append(f"{series} {_fmt(snap.counters[series])}")
    for series in sorted(snap.gauges):
        type_line(_base_name(series), "gauge")
        lines.append(f"{series} {_fmt(snap.gauges[series])}")
    for name in sorted(snap.histograms):
        h = snap.histograms[name]
        type_line(name, "histogram")
        for le, c in h.cumulative():
            lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {c}')
        lines.append(f"{name}_sum {repr(float(h.sum))}")
        lines.append(f"{name}_count {h.count}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> MetricsSnapshot:
    """Parse text produced by :func:`render_prometheus` back into a
    snapshot (histograms are reconstructed bucket-exact)."""
    snap = MetricsSnapshot()
    types: Dict[str, str] = {}
    hist_rows: Dict[str, Dict[str, float]] = {}
    hist_buckets: Dict[str, List[Tuple[float, int]]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        series, sval = line.rsplit(" ", 1)
        val = math.inf if sval == "+Inf" else float(sval)
        base = _base_name(series)
        # histogram sample lines belong to a declared histogram base name
        hbase = None
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and \
                    types.get(base[: -len(suffix)]) == "histogram":
                hbase = base[: -len(suffix)]
                break
        if hbase is not None:
            rows = hist_rows.setdefault(hbase, {})
            if base.endswith("_bucket"):
                le_s = series.split('le="', 1)[1].split('"', 1)[0]
                le = math.inf if le_s == "+Inf" else float(le_s)
                hist_buckets.setdefault(hbase, []).append((le, int(val)))
            elif base.endswith("_sum"):
                rows["sum"] = val
            else:
                rows["count"] = val
        elif types.get(base) == "gauge":
            snap.gauges[series] = val
        else:
            snap.counters[series] = val
    for name, pairs in hist_buckets.items():
        pairs.sort(key=lambda p: p[0])
        finite = [p for p in pairs if p[0] != math.inf]
        h = Histogram([le for le, _ in finite])
        prev = 0
        for i, (_, cum) in enumerate(finite):
            h.counts[i] = cum - prev
            prev = cum
        rows = hist_rows.get(name, {})
        h.count = int(rows.get("count", pairs[-1][1] if pairs else 0))
        h.counts[-1] = h.count - prev
        h.sum = float(rows.get("sum", 0.0))
        snap.histograms[name] = h
    return snap


def snapshot_json_line(snap: MetricsSnapshot, **extra: object) -> str:
    """One structured JSON log line for ``--metrics-log``."""
    doc = {
        "ts": snap.timestamp,
        "counters": dict(snap.counters),
        "gauges": dict(snap.gauges),
        "histograms": {
            name: {"buckets": list(h.buckets), "counts": list(h.counts),
                   "sum": h.sum, "count": h.count}
            for name, h in snap.histograms.items()},
    }
    doc.update(extra)
    return json.dumps(doc, sort_keys=True)


class MetricsServer:
    """Minimal stdlib HTTP scrape endpoint serving ``/metrics``.

    ``source`` is called per scrape and must return a MetricsSnapshot;
    pass ``port=0`` to bind an ephemeral port (see ``.port``).
    """

    def __init__(self, source: Callable[[], MetricsSnapshot],
                 port: int = 0, host: str = "127.0.0.1"):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(server.source()).encode()
                except Exception as e:  # surface scrape errors as 500s
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self.source = source
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"
