"""Metrics registry, Prometheus text exposition and the HTTP port, a
copy of ``marian_tpu/serving/metrics.py`` (the port imports nothing of
the JAX package): the same series names, help texts, labels and text,
so one dashboard reads either package's server.

Stdlib only — ``http.server`` for the endpoint, ``lockdep.make_lock``
locks for safety across the asyncio loop, the device worker thread, the
bundle watcher and the scraping thread.

Exposition format: https://prometheus.io/docs/instrumenting/exposition_formats/
(text format 0.0.4 — the stable plain-text one).
"""


from __future__ import annotations

import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common import lockdep
from ..common import logging as log

# Default histogram buckets: latency-shaped (seconds), 1ms..60s. Chosen so
# one bucket table serves both the ~5ms coalescing window and multi-second
# device batches under load.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# Ratio-shaped buckets (fill ratios, waste fractions) in [0, 1].
RATIO_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without exponent, floats as
    repr (Go-parseable); +Inf for the histogram top bucket."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    pairs = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for n, v in zip(names, values))
    return "{" + pairs + "}"


class _Metric:
    """Base: name, help, optional label names; children per label values."""

    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = lockdep.make_lock("_Metric._lock")
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}

    def labels(self, *values: str) -> "_Metric":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._child()
                self._children[key] = child
            return child

    def _child(self) -> "_Metric":
        raise NotImplementedError

    def children(self) -> Dict[Tuple[str, ...], "_Metric"]:
        """Snapshot of label-value tuple -> child metric — the public
        read for summing a counter across one label dimension without
        touching private state."""
        with self._lock:
            return dict(self._children)

    def _sample_lines(self, label_values: Tuple[str, ...],
                      exemplars: bool = False) -> List[str]:
        raise NotImplementedError

    def render(self, exemplars: bool = False) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = dict(self._children)
        if self.label_names:
            for key, child in sorted(children.items()):
                lines.extend(child._sample_lines(key, exemplars))
        else:
            lines.extend(self._sample_lines((), exemplars))
        return lines


class Counter(_Metric):
    """Monotonically increasing count (requests, sheds, timeouts...)."""

    kind = "counter"

    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = ()):
        super().__init__(name, help_, labels)
        self._value = 0.0

    def _child(self) -> "Counter":
        return Counter(self.name, self.help, labels=self.label_names)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _sample_lines(self, lv: Tuple[str, ...],
                      exemplars: bool = False) -> List[str]:
        return [f"{self.name}{_label_str(self.label_names, lv)} "
                f"{_fmt(self.value)}"]


class Gauge(_Metric):
    """A value that goes up and down (queue depth, inflight batches...)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = ()):
        super().__init__(name, help_, labels)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def _child(self) -> "Gauge":
        return Gauge(self.name, self.help, labels=self.label_names)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample a callable at scrape time (e.g. live queue depth)."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never raise
                return float("nan")
        with self._lock:
            return self._value

    def _sample_lines(self, lv: Tuple[str, ...],
                      exemplars: bool = False) -> List[str]:
        return [f"{self.name}{_label_str(self.label_names, lv)} "
                f"{_fmt(self.value)}"]


class Histogram(_Metric):
    """Cumulative-bucket histogram (latency, batch fill ratio...).

    ``observe(v, trace_id=...)`` additionally keeps the LAST trace id
    observed per bucket as an exemplar: scraping
    ``/metrics?exemplars=1`` renders OpenMetrics-style ``# {trace_id=..}``
    suffixes on the bucket series, so a p99 outlier links straight to
    its span tree on ``/tracez`` / in a flight dump. The default
    exposition stays plain text-format 0.0.4 (exemplar suffixes would
    break strict 0.0.4 parsers).
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +1 for +Inf
        # last (value, trace_id, unix_ts) per bucket — see class docstring
        self._exemplars: List[Optional[Tuple[float, str, float]]] = \
            [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def _child(self) -> "Histogram":
        return Histogram(self.name, self.help, labels=self.label_names,
                         buckets=self.buckets)

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    if trace_id:
                        self._exemplars[i] = (float(v), str(trace_id),
                                              time.time())
                    return
            self._counts[-1] += 1
            if trace_id:
                self._exemplars[-1] = (float(v), str(trace_id), time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], int, float]:
        """(bucket edges, per-bucket counts incl. the +Inf tail, total
        count, sum) — one consistent read (how many observations sat at
        or under a bucket edge)."""
        with self._lock:
            return self.buckets, list(self._counts), self._count, self._sum

    def _sample_lines(self, lv: Tuple[str, ...],
                      exemplars: bool = False) -> List[str]:
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
            exs = list(self._exemplars) if exemplars else None
        lines = []
        cum = 0
        edges = list(self.buckets) + [float("inf")]
        for i, (c, edge) in enumerate(zip(counts, edges)):
            cum += c
            le = _label_str(self.label_names + ("le",), lv + (_fmt(edge),))
            line = f"{self.name}_bucket{le} {cum}"
            if exs is not None and exs[i] is not None:
                ev, etid, ets = exs[i]
                line += (f' # {{trace_id="{etid}"}} {_fmt(ev)} '
                         f"{ets:.3f}")
            lines.append(line)
        ls = _label_str(self.label_names, lv)
        lines.append(f"{self.name}_sum{ls} {_fmt(s)}")
        lines.append(f"{self.name}_count{ls} {total}")
        return lines


class Registry:
    """Named metric collection; get-or-create semantics so any layer can
    declare its series idempotently (re-instantiating a Scheduler or a
    Translate in one process must not collide)."""

    def __init__(self):
        self._lock = lockdep.make_lock("Registry._lock")
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
                return m
            m = cls(name, help_, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labels=labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels=labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels=labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self, exemplars: bool = False) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: List[str] = []
        for m in metrics:
            out.extend(m.render(exemplars))
        return "\n".join(out) + "\n"


# The process-wide default registry: train, translate, and serve all emit
# here, so one /metrics endpoint exposes the whole process.
REGISTRY = Registry()

# process start, anchored at import (close enough to exec for the
# standard process_start_time_seconds semantics)
_PROCESS_START = time.time()


def _rss_bytes() -> float:
    """Resident set size. /proc on Linux; ru_maxrss (peak) as the
    portable fallback — better a labeled approximation than no memory
    signal at all. ru_maxrss units differ by platform: kilobytes on
    Linux (where /proc usually wins anyway), BYTES on macOS/BSD — an
    unconditional *1024 would read 1024x high exactly where the
    fallback is the path taken."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as fh:
            pages = int(fh.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            import resource
            import sys
            scale = 1 if sys.platform == "darwin" else 1024
            return float(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * scale)
        except Exception:  # noqa: BLE001 — a scrape must never raise
            return float("nan")


def _open_fds() -> float:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return float("nan")


def register_process_metrics(registry: Optional[Registry] = None) -> None:
    """Standard process self-metrics: the scrape
    surface previously had no view of host-side health — a leaking
    server looked identical to a healthy one until the OOM killer said
    otherwise. Names follow the Prometheus client-library convention so
    stock dashboards/alerts work unchanged. Idempotent (get-or-create),
    called by every MetricsServer start."""
    r = registry if registry is not None else REGISTRY
    m_start = r.gauge(
        "process_start_time_seconds",
        "Unix time the process started (well, imported the metrics "
        "layer)")
    m_start.set(_PROCESS_START)
    m_up = r.gauge(
        "process_uptime_seconds", "Seconds since process start")
    m_up.set_function(lambda: time.time() - _PROCESS_START)
    m_rss = r.gauge(
        "process_resident_memory_bytes",
        "Resident set size (NaN where /proc and getrusage are both "
        "unavailable)")
    m_rss.set_function(_rss_bytes)
    m_fds = r.gauge(
        "process_open_fds",
        "Open file descriptors (NaN without /proc)")
    m_fds.set_function(_open_fds)


def counter(name: str, help_: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help_, labels)


def gauge(name: str, help_: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help_, labels)


def histogram(name: str, help_: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help_, labels, buckets)


class MetricsServer:
    """/metrics + /healthz + /readyz on a ThreadingHTTPServer daemon thread.

    - /metrics — Prometheus text of the given registry.
    - /healthz — 200 as long as the process serves HTTP (liveness).
    - /readyz  — 200 only while ``ready_fn()`` is truthy (readiness: model
      loaded, warmed and live, scheduler running, not draining); 503
      otherwise, so load balancers stop routing to a replica that is
      draining — or still warming a model.
    - ``routes`` — extra path handlers (the lifecycle's /lifecyclez state
      dump and /admin/* verbs): ``path -> fn(method, query) ->
      (status, body_bytes, content_type)``. GET and POST both dispatch
      here; a raising handler is a 500, never a dead endpoint thread.
      POST (the mutating admin verbs) is accepted from LOOPBACK peers
      only — the scrape port is routinely opened cluster-wide for
      Prometheus, and rollback/pin must not be a network-wide control
      surface; operators ssh/port-forward to the replica.

    Port 0 binds an ephemeral port (tests); ``.port`` reports the bound one.
    """

    def __init__(self, port: int, registry: Optional[Registry] = None,
                 ready_fn: Optional[Callable[[], bool]] = None,
                 host: str = "0.0.0.0",
                 routes: Optional[Dict[str, Callable[[str, str],
                                                     Tuple[int, bytes,
                                                           str]]]] = None):
        self.registry = registry if registry is not None else REGISTRY
        self.ready_fn = ready_fn or (lambda: True)
        self.routes = dict(routes or {})
        self._started = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    # ?exemplars=1: OpenMetrics-style trace-id exemplar
                    # suffixes on histogram buckets — opt-in,
                    # the default stays strict text-format 0.0.4
                    ex = "exemplars=1" in query
                    body = outer.registry.render(
                        exemplars=ex).encode("utf-8")
                    self._send(200, body,
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._send(200, b"ok\n", "text/plain")
                elif path == "/readyz":
                    try:
                        ready = bool(outer.ready_fn())
                    except Exception:  # noqa: BLE001
                        ready = False
                    self._send(200 if ready else 503,
                               b"ready\n" if ready else b"not ready\n",
                               "text/plain")
                elif path in outer.routes:
                    self._route(path, "GET", query)
                else:
                    self._send(404, b"not found\n", "text/plain")

            def do_POST(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if self.client_address[0] not in ("127.0.0.1", "::1",
                                                  "::ffff:127.0.0.1"):
                    self._send(403, b"admin verbs are loopback-only\n",
                               "text/plain")
                elif path in outer.routes:
                    self._route(path, "POST", query)
                else:
                    self._send(404, b"not found\n", "text/plain")

            def _route(self, path: str, method: str, query: str) -> None:
                try:
                    code, body, ctype = outer.routes[path](method, query)
                except Exception as e:  # noqa: BLE001 — endpoint stays up
                    code, body, ctype = (500, f"error: {e}\n".encode(),
                                         "text/plain")
                self._send(code, body, ctype)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not log-worthy
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-http")

    def start(self) -> "MetricsServer":
        # any scrape surface gets the standard process self-metrics
        # — host-side health next to the app series
        register_process_metrics(self.registry)
        self._thread.start()
        log.info("Metrics endpoint on port {} (/metrics /healthz /readyz)",
                 self.port)
        return self

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass


def maybe_start_metrics_server(options,
                               ready_fn: Optional[Callable[[], bool]] = None,
                               routes: Optional[Dict] = None,
                               registry: Optional[Registry] = None
                               ) -> Optional[MetricsServer]:
    """--metrics-port PORT (0 = off): start the scrape endpoint of
    ``registry`` (the process-wide one by default) for a long-running
    entry point. Failure to bind degrades to a warning — observability
    must never take down the serving path."""
    port = int(options.get("metrics-port", 0) or 0)
    if port <= 0:
        return None
    try:
        return MetricsServer(port, registry=registry, ready_fn=ready_fn,
                             routes=routes).start()
    except OSError as e:
        log.warn("--metrics-port {}: failed to bind ({}); metrics endpoint "
                 "disabled", port, e)
        return None
