"""Live performance and capacity accounting, ported from
``marian_tpu/obs/perf.py``: the analytic cost model (common/flops.py)
turned into live gauges, fed by the serving scheduler with every device
batch (request mode) and every engine round (iteration mode): rows,
width, real tokens, and device seconds measured to the host-side result
fence (``translate_lines`` returns host strings and an engine round ends
in its one copy to the host, so the return IS the drain; the timestamp
is taken after it, never at enqueue).

Exported series:

- ``marian_perf_device_seconds_total`` / ``marian_perf_tokens_total`` /
  ``marian_perf_trg_tokens_total`` {model_version} — the raw capacity
  integrals;
- ``marian_perf_chip_seconds_per_token`` {model_version} — rolling
  chip-seconds per real source token (chip = wall seconds on the device
  worker x device count), the autoscaling signal;
- ``marian_perf_tokens_per_second`` {model_version},
  ``marian_perf_device_busy_ratio`` — rolling throughput and
  utilization, read at scrape time (they decay to 0 at idle);
- ``marian_perf_mfu`` {model_version} — rolling model-FLOPs utilization
  against the peak of the model's compute dtype on the card
  (``set_geometry``); 0 on an unknown device (the CPU);
- ``marian_capacity_headroom_ratio`` — one scrape-time gauge combining
  device utilization and admission-queue pressure (``headroom``);
- ``marian_compile_total`` / ``marian_compile_seconds_total``
  {trigger, bucket} — registered under the reference's names; they stay
  at 0 here, because the port compiles nothing per shape (eager
  PyTorch, hand-built kernels). CUDA graph captures will give them
  something to count. The reference's jax.monitoring series
  (``marian_compile_backend_seconds_total``) has no counterpart;
- ``marian_train_chip_seconds_per_token`` and ``marian_train_mfu`` — the
  trainer's display window (``record_train_window``, fed by
  training/scheduler.py with the window's seconds clocked after its one
  host sync).

Off by default and free on the scheduler's batch path: ``PERF.enabled``
is one attribute read, and nothing below it runs. ``--perf-accounting``
(on by default for the server) or ``PERF.enable()`` turns it on.

Threading: ``record_batch`` runs on the event loop,
``record_train_window`` on the training thread, ``headroom`` on the
metrics scrape thread; the rolling window lives under
``PerfMeter._lock``, and metric emission happens outside it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, Optional, Tuple

from ..common import lockdep

# rolling-window horizon for the rate gauges (seconds): long enough to
# smooth batch-to-batch jitter, short enough that an autoscaler acting
# on the headroom gauge sees load changes within one scrape interval
DEFAULT_WINDOW_S = 60.0


class _Geometry:
    """Model geometry for the analytic MFU estimate (common/flops.py)."""

    __slots__ = ("emb", "ffn", "enc_depth", "dec_depth", "vocab", "beam",
                 "n_devices", "peak_flops")

    def __init__(self, emb: int, ffn: int, enc_depth: int, dec_depth: int,
                 vocab: int, beam: int, n_devices: int,
                 peak_flops: Optional[float]):
        self.emb = emb
        self.ffn = ffn
        self.enc_depth = enc_depth
        self.dec_depth = dec_depth
        self.vocab = vocab
        self.beam = max(1, beam)
        self.n_devices = max(1, n_devices)
        self.peak_flops = peak_flops      # per device; None = unknown


class PerfMeter:
    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.enabled = False
        self.window_s = float(window_s)
        self._lock = lockdep.make_lock("PerfMeter._lock")
        # rolling (ts, version, device_s, src_tokens, trg_tokens, flops,
        # rows) samples, newest right; pruned to window_s on every
        # append/read, with RUNNING sums kept alongside (global + per
        # version label; subtracted on prune), so one batch or one
        # scrape is O(pruned), not O(window). Per-version sums keep a
        # hot-swap's NEW version's cost gauge unpolluted by the old
        # version's samples still inside the window.
        self._window: Deque[Tuple[float, str, float, float, float,
                                  float, float]] = \
            collections.deque()                     # guarded-by: _lock
        # [device_s, src_tokens, trg_tokens, flops, rows]
        self._sums = [0.0] * 5                      # guarded-by: _lock
        self._vsums: Dict[str, list] = {}           # guarded-by: _lock
        # versions whose tokens/s gauge child already has its sampler
        self._tps_wired: set = set()                # guarded-by: _lock
        self._geo: Optional[_Geometry] = None       # guarded-by: _lock
        self._depth_fn: Optional[Callable[[], int]] = None
        self._max_queue = 0
        self._registry = None

    # -- lifecycle ----------------------------------------------------------
    def enable(self, registry=None, window_s: Optional[float] = None
               ) -> None:
        from ..serving import metrics as msm    # lazy: no import cycle
        if window_s:
            self.window_s = float(window_s)
        target = registry if registry is not None else msm.REGISTRY
        if self._registry is not None and target is not self._registry:
            # re-enabled onto a DIFFERENT scrape surface (a second
            # ServingApp in one process): the accumulated state belongs
            # to the previous app — a stale _tps_wired would leave the
            # new registry's tokens/s series without its sampler, and
            # old window samples would pollute the fresh cost gauges
            with self._lock:
                self._window.clear()
                self._sums = [0.0] * 5
                self._vsums.clear()
                self._tps_wired.clear()
        self._registry = target
        self._declare_metrics()
        self.enabled = True

    def reset(self) -> None:
        self.enabled = False
        self.window_s = DEFAULT_WINDOW_S
        with self._lock:
            self._window.clear()
            self._sums = [0.0] * 5
            self._vsums.clear()
            self._tps_wired.clear()
            self._geo = None
        self._depth_fn = None
        self._max_queue = 0
        self._registry = None

    def _declare_metrics(self) -> None:
        r = self._registry
        self.m_device_s = r.counter(
            "marian_perf_device_seconds_total",
            "Device-worker seconds spent in translate calls, measured to "
            "the host-side result fence (sync-honest)",
            labels=("model_version",))
        self.m_tokens = r.counter(
            "marian_perf_tokens_total",
            "Real (unpadded) source tokens through the device",
            labels=("model_version",))
        self.m_trg_tokens = r.counter(
            "marian_perf_trg_tokens_total",
            "Real target tokens produced by the device",
            labels=("model_version",))
        self.m_cspt = r.gauge(
            "marian_perf_chip_seconds_per_token",
            "Rolling chip-seconds per real source token (device seconds x "
            "device count / tokens over the last window) — the capacity / "
            "autoscaling signal",
            labels=("model_version",))
        self.m_tps = r.gauge(
            "marian_perf_tokens_per_second",
            "Rolling real source tokens per second through the device "
            "(scrape-time over the window — decays to 0 at idle)",
            labels=("model_version",))
        self.m_busy = r.gauge(
            "marian_perf_device_busy_ratio",
            "Rolling fraction of wall-clock the device worker spent "
            "inside translate calls (scrape-time over the window — "
            "decays to 0 at idle, so an autoscaler never sees phantom "
            "saturation on an idle replica)")
        self.m_busy.set_function(self._busy_now)
        self.m_devices = r.gauge(
            "marian_perf_devices",
            "CUDA device count the chip-seconds gauges are scaled by")
        self.m_devices.set(1)
        self.m_mfu = r.gauge(
            "marian_perf_mfu",
            "Rolling model-FLOPs utilization vs the analytic roofline "
            "for the configured geometry (0 = unknown device / no "
            "geometry)",
            labels=("model_version",))
        self.m_peak = r.gauge(
            "marian_perf_roofline_peak_flops",
            "Peak FLOPs/s of the model's compute dtype assumed by the MFU "
            "gauge across all devices (0 = unknown device)")
        self.m_headroom = r.gauge(
            "marian_capacity_headroom_ratio",
            "Scrape-time capacity headroom in [0,1]: (1 - rolling device "
            "busy fraction) x (1 - admission queue pressure). 1 = idle, "
            "0 = saturated or queue full — feed this to the autoscaler")
        self.m_headroom.set_function(self.headroom)
        self.m_compiles = r.counter(
            "marian_compile_total",
            "Inferred jit compilations by width bucket and trigger "
            "(boot-warmup | swap-warmup | steady-state; steady-state "
            "recompiles are latency incidents and also land on the "
            "event timeline)",
            labels=("trigger", "bucket"))
        self.m_compile_s = r.counter(
            "marian_compile_seconds_total",
            "Wall seconds attributed to the inferred compilations (for "
            "steady-state: the first batch's device seconds, an upper "
            "bound — compile and run are fused)",
            labels=("trigger", "bucket"))
        self.m_train_cspt = r.gauge(
            "marian_train_chip_seconds_per_token",
            "Training: wall seconds x device count per target label over "
            "the last display window (window duration is clocked after "
            "the window's deferred device sync — honest)")
        self.m_train_mfu = r.gauge(
            "marian_train_mfu",
            "Training: rolling model-FLOPs utilization of the last "
            "display window vs the analytic roofline (0 = unknown chip "
            "/ no geometry)")

    # -- configuration ------------------------------------------------------
    def set_geometry(self, emb: int, ffn: int, enc_depth: int,
                     dec_depth: int, vocab: int, beam: int = 1,
                     n_devices: Optional[int] = None,
                     peak_flops: Optional[float] = None,
                     device_kind: Optional[str] = None,
                     compute_dtype: str = "float32") -> None:
        """Model geometry and device peak for the MFU gauge. When
        ``peak_flops`` (per device) is not given, it is the data-sheet
        peak of ``compute_dtype`` on ``device_kind`` (a CUDA device
        name; None or another device: unknown, MFU 0)."""
        if peak_flops is None:
            from ..common.flops import peak_flops as _peak
            peak_flops = _peak(device_kind or "", compute_dtype)
        geo = _Geometry(int(emb), int(ffn), int(enc_depth), int(dec_depth),
                        int(vocab), int(beam), int(n_devices or 1),
                        peak_flops)
        with self._lock:
            self._geo = geo
        if self.enabled:
            self.m_peak.set((peak_flops or 0.0) * geo.n_devices)
            self.m_devices.set(geo.n_devices)

    def set_capacity_inputs(self, depth_fn: Optional[Callable[[], int]],
                            max_queue_units: int) -> None:
        """Wire the admission-pressure half of the headroom gauge: the
        scheduler's live queue depth and the admission bound (0 =
        unbounded — pressure is then queue debt in device-seconds
        relative to the rolling window). The units follow the batching
        mode: sentences against --max-queue in request mode, KV-pool
        pages against --max-queue-pages in iteration mode. Pass ``None``
        to unwire (a closed ServingApp must not leave the process-global
        gauge sampling a dead scheduler)."""
        self._depth_fn = depth_fn
        self._max_queue = int(max_queue_units)

    # -- training window (training thread) ----------------------------------
    def record_train_window(self, labels: float, src_words: float,
                            sentences: int, dt: float) -> None:
        """One training display window: ``dt`` its wall seconds, clocked
        after the window's one host sync (training/scheduler.py), and
        ``labels`` its real target labels. Chip-seconds per token is
        wall x devices: the card is held for the whole window, which is
        what a capacity planner pays for."""
        if not self.enabled or labels <= 0 or dt <= 0:
            return
        with self._lock:
            geo = self._geo
        n_dev = geo.n_devices if geo is not None else 1
        self.m_train_cspt.set(dt * n_dev / labels)
        mfu = 0.0
        if geo is not None and geo.peak_flops:
            from ..common.flops import transformer_train_flops
            sents = max(1, int(sentences))
            src_w = max(1, int(round((src_words or labels) / sents)))
            trg_w = max(1, int(round(labels / sents)))
            # unpadded average widths understate the attention a padded
            # batch pays, so this MFU reads slightly high
            flops = transformer_train_flops(
                geo.emb, geo.ffn, geo.enc_depth, geo.dec_depth, geo.vocab,
                src_tokens=float(src_words or labels),
                trg_tokens=float(labels),
                src_width=src_w, trg_width=trg_w)
            mfu = flops / (dt * geo.peak_flops * n_dev)
        self.m_train_mfu.set(mfu)

    # -- serving batch accounting (event-loop thread) -----------------------
    def record_batch(self, model_version: str, rows: int, width: int,
                     src_tokens: int, trg_tokens: int,
                     device_s: float) -> None:
        """One device batch (or engine round): integrate the counters
        and refresh the rolling gauges. ``device_s`` must be measured to
        the result fence (the caller's contract). ``model_version`` is
        the label the caller stamps (the lifecycle's live version at
        batch time)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        version = str(model_version)
        flops = 0.0
        with self._lock:
            geo = self._geo
        if geo is not None:
            from ..common.flops import transformer_serve_flops
            # trg width = the AVERAGE generated length (trg_tokens over
            # real rows), not the source bucket: the decoder's
            # self-attention cache grows with what was actually generated
            trg_w = max(1, int(round(trg_tokens / max(1, rows))))
            flops = transformer_serve_flops(
                geo.emb, geo.ffn, geo.enc_depth, geo.dec_depth, geo.vocab,
                src_tokens=float(src_tokens), trg_tokens=float(trg_tokens),
                src_width=int(width), trg_width=trg_w,
                beam=geo.beam)
        with self._lock:
            self._window.append((now, version, float(device_s),
                                 float(src_tokens), float(trg_tokens),
                                 flops, float(rows)))
            vs = self._vsums.setdefault(version, [0.0] * 5 + [0])
            for tgt in (self._sums, vs):
                tgt[0] += float(device_s)
                tgt[1] += float(src_tokens)
                tgt[2] += float(trg_tokens)
                tgt[3] += flops
                tgt[4] += float(rows)
            vs[5] += 1
            v_first = version not in self._tps_wired
            self._tps_wired.add(version)
            self._prune(now)
            v_dev, v_src, v_flops = vs[0], vs[1], vs[3]
            n_dev = geo.n_devices if geo is not None else 1
            peak = (geo.peak_flops or 0.0) * n_dev if geo is not None \
                else 0.0
        self.m_device_s.labels(version).inc(float(device_s))
        self.m_tokens.labels(version).inc(int(src_tokens))
        self.m_trg_tokens.labels(version).inc(int(trg_tokens))
        if v_src > 0:
            # the COST of this version's recent traffic: deliberately
            # holds its last value at idle (a cost per token does not
            # decay; the rate/utilization gauges are the ones that must)
            self.m_cspt.labels(version).set(v_dev * n_dev / v_src)
        if v_first:
            # throughput is scrape-time: this version's window-rate
            # sampler is assigned on its FIRST batch (it reads the live
            # sums) — an idle replica reads 0, not the last burst's rate
            self.m_tps.labels(version).set_function(
                lambda v=version: self._rate_now(v))
        mfu = 0.0
        if peak > 0 and v_dev > 0:
            mfu = v_flops / (v_dev * peak)
        self.m_mfu.labels(version).set(mfu)

    def _prune(self, now: float) -> None:
        """Evict samples older than the window, decrementing the global
        and per-version running sums; caller holds the lock. A version
        whose last sample ages out drops its sums entry."""
        w, s = self._window, self._sums
        while w and now - w[0][0] > self.window_s:
            _ts, ver, dev, src, trg, fl, rows = w.popleft()
            for tgt in (s, self._vsums.get(ver)):
                if tgt is None:
                    continue
                tgt[0] -= dev
                tgt[1] -= src
                tgt[2] -= trg
                tgt[3] -= fl
                tgt[4] -= rows
            vs = self._vsums.get(ver)
            if vs is not None:
                vs[5] -= 1
                if vs[5] <= 0:
                    del self._vsums[ver]
        if not w:
            s[0] = s[1] = s[2] = s[3] = s[4] = 0.0   # absorb float drift

    def _window_sums(self, now: float) -> Tuple[float, float, float, float,
                                                float]:
        """Prune, then return the global running sums (device_s,
        src_tokens, trg_tokens, flops, span_s); caller holds the lock.
        Span is the elapsed wall clock the samples cover (capped at the
        window horizon)."""
        self._prune(now)
        s = self._sums
        if not self._window:
            return 0.0, 0.0, 0.0, 0.0, 0.0
        span = max(now - self._window[0][0], s[0], 1e-9)
        return s[0], s[1], s[2], s[3], min(span, self.window_s)

    def _busy_now(self) -> float:
        """Scrape-time device-busy fraction over the rolling window."""
        now = time.perf_counter()
        with self._lock:
            dev, _s, _t, _f, span = self._window_sums(now)
        return min(1.0, dev / span) if span > 0 else 0.0

    def _rate_now(self, version: Optional[str] = None) -> float:
        """Scrape-time source tokens/s over the rolling window (one
        version's share, or global when ``version`` is None)."""
        now = time.perf_counter()
        with self._lock:
            _d, src, _t, _f, span = self._window_sums(now)
            if version is not None:
                vs = self._vsums.get(version)
                src = vs[1] if vs is not None else 0.0
        return src / span if span > 0 else 0.0

    # -- capacity headroom (metrics scrape thread) --------------------------
    def headroom(self) -> float:
        """(1 - busy) x (1 - queue pressure), clamped to [0, 1]. Busy is
        the rolling device-seconds fraction of the window; pressure is
        queued units over the admission bound, or (unbounded queue) the
        queued work priced at the rolling device-seconds-per-row rate
        relative to the window horizon."""
        now = time.perf_counter()
        with self._lock:
            dev_sum, _src, _t, _f, span = self._window_sums(now)
            rows_sum = self._sums[4]
        busy = min(1.0, dev_sum / span) if span > 0 else 0.0
        pressure = 0.0
        if self._depth_fn is not None:
            try:
                depth = max(0, int(self._depth_fn()))
            except Exception:  # noqa: BLE001 — a scrape must never raise
                depth = 0
            if self._max_queue > 0:
                pressure = min(1.0, depth / self._max_queue)
            elif depth and rows_sum > 0 and dev_sum > 0:
                per_sentence = dev_sum / rows_sum
                pressure = min(1.0, depth * per_sentence / self.window_s)
        return max(0.0, (1.0 - busy) * (1.0 - pressure))

    # -- introspection ------------------------------------------------------
    def state(self) -> Dict:
        """JSON-ready snapshot (rides /sloz and flight dumps)."""
        if not self.enabled:
            return {"enabled": False}
        now = time.perf_counter()
        with self._lock:
            dev, src, trg, fl, span = self._window_sums(now)
            geo = self._geo
            n_dev = geo.n_devices if geo is not None else 1
            versions = {
                v: {"device_seconds": round(vs[0], 6),
                    "src_tokens": vs[1], "batches": vs[5],
                    "chip_seconds_per_token":
                        round(vs[0] * n_dev / vs[1], 9) if vs[1] else None}
                for v, vs in sorted(self._vsums.items())}
        out = {
            "enabled": True,
            "window_s": self.window_s,
            "window": {
                "device_seconds": round(dev, 6),
                "src_tokens": src, "trg_tokens": trg,
                "busy_ratio": round(min(1.0, dev / span), 4)
                if span > 0 else 0.0,
                "chip_seconds_per_token":
                    round(dev * n_dev / src, 9) if src > 0 else None,
            },
            "headroom": round(self.headroom(), 4),
            "versions": versions,
        }
        if geo is not None:
            out["geometry"] = {
                "emb": geo.emb, "ffn": geo.ffn,
                "enc_depth": geo.enc_depth, "dec_depth": geo.dec_depth,
                "vocab": geo.vocab, "beam": geo.beam,
                "n_devices": geo.n_devices,
                "peak_flops_per_device": geo.peak_flops,
            }
        return out


# The process-wide meter, like TRACER, FLIGHT and the metrics REGISTRY.
PERF = PerfMeter()
