"""marian-server of the port, ported from ``marian_tpu/server/server.py``:
request-mode serving (the reference's default) and iteration-mode
serving over a paged KV pool, greedy at ``--beam-size 1`` and beam
search above it (the fused on-device merge by default, or the host
merge), with the cross-request prefix cache (``--prefix-cache``) and
the decode surface (``--shortlist``, ``--output-sampling``,
``--force-decode``, ``--n-best``; in request mode ``--word-scores`` too).

Protocol kept Marian-compatible: a request frame holds newline-joined
source sentences, the reply the newline-joined translations. Transports,
the reference's choice: WebSocket text frames (the Marian protocol)
through the ``websockets`` package where it is installed (``HAVE_WS``);
otherwise, with a warning, the dependency-free length-prefixed TCP
framing, ``MTPU <nbytes>\\n`` + UTF-8 payload in both directions. Both
share one ServingApp, so admission, scheduling and metrics behave alike.

All requests flow through ONE scheduler (serving/scheduler.py) behind
bounded admission (serving/admission.py):

- ``--batching-mode request``: the scheduler packs sentences of many
  requests into device batches by token budget (``--batch-token-budget``,
  by default ``--mini-batch`` x the bucketed ``--max-length``) and runs
  each through the decoder's dense beam search (``translate_lines``);
  admission bounds queued sentences.
- ``--batching-mode iteration``: sentences join a running decode every
  round (translator/iteration.py; at beam > 1 the copy-on-write beam
  engine, translator/beam_iteration.py, ``--iteration-beam-merge fused``
  with ``--iteration-steps`` steps a round, or ``host``, one); admission
  prices queue debt in sentences and in pool pages, against the free
  pages plus what the prefix cache could give back.

In iteration mode the decode surface is the engines' per-row
feature plane (translator/decode_features.py): a ``--force-decode``
line is ``source<TAB>target-prefix`` (request mode reads it the same
way), ``--n-best`` runs the beam engine even at beam 1 and turns the
prefix cache off (a cached block would carry another request's sentence
numbers), and ``--output-sampling`` turns it off too.

Streaming: a request whose first header line is ``#stream:1`` gets, in
iteration mode, one ``#partial:<sentence idx> <text so far>`` frame a
round for each of its sentences still decoding, then its final reply
frame. Greedy partials are prefixes of the final text; beam partials
are the best hypothesis so far and may be revised. Request mode accepts
the header and sends no partials.

Error replies are explicit: ``!!SERVER-OVERLOADED`` (shed),
``!!SERVER-TIMEOUT`` (deadline), ``!!SERVER-RETRY`` (row evicted by a
failed round or a dry pool, or a device batch or round failed by the
dispatch watchdog) and ``!!SERVER-ERROR`` (bad frame, or a request
header whose feature is not ported).

The zero-downtime model lifecycle (``--model-watch S``, both modes;
``serving/lifecycle/``): a watcher polls ``<model>.bundles/`` every S
seconds (and is pushed by an in-process trainer's commit hook), warms
each newly committed bundle off the serving path (compat check against
the live version's manifest, load onto the card, golden decode; an
iteration engine at each of its row buckets), then swaps it in — in
request mode between device batches (``SwapController.route`` is the
scheduler's ``translate_lines``; ``--canary-fraction`` routes that
share of batches to the candidate first), in iteration mode through the
scheduler's quiesce protocol (``--quiesce-deadline``; the canary takes
all joins for its window). A failing canary's batches are re-served on
live and it is rolled back (``--rollback-error-rate``,
``--rollback-p99-factor``, ``--canary-min-batches``); the previous live
version stays warm as the rollback target, every other version's model
is released. ``--metrics-port P`` serves ``/metrics`` (``?exemplars=1``
adds the latency histograms' trace-id exemplars), ``/healthz``,
``/readyz`` (503 until a live version routes), ``/tracez``, ``/sloz``,
``/poolz`` and, with the lifecycle, ``/lifecyclez`` and loopback
``POST /admin/{pin,unpin,rollback}``.

The observability plane (obs/): ``--trace`` records every request's
span tree (``request`` -> ``serve.queue`` -> ``serve.dispatch``, the
batch's ``serve.batch`` -> ``serve.translate`` or the round's
``serve.round`` and the sentence's ``serve.row``, then ``reply.write``)
into a ring that ``/tracez?last=N`` exports as Chrome trace JSON (open
it in Perfetto); ``--trace-dump DIR`` (implies ``--trace``) arms the
flight recorder, which writes the ring, the timeline, ``/metrics`` and
the pool, SLO and perf state to ``DIR/flight-*.json`` at a watchdog
trip, a rollback, a poison isolation, an unhealthy quiesce, a failed
pool audit or a fast SLO burn. ``--perf-accounting`` (on by default)
keeps the perf plane's gauges (chip-seconds per token, tokens/s, busy
ratio, MFU against the card's peak for the model's compute dtype,
capacity headroom). ``--slo-availability`` / ``--slo-p99-ms`` start the
SLO burn-rate engine (``/sloz``, ``marian_slo_*``). ``/poolz`` shows the
iteration engine's page map (``enabled: false`` in request mode).

Request tracing: a frame whose first line is ``#trace:<id>`` (up to 64
characters of letters, digits, ``-`` and ``_``; anything else is
payload) labels the request's span tree with the id, and the reply
starts with the line ``#trace:<id> outcome=.. queue_ms=.. service_ms=..
model_version=..`` (iteration mode adds ``rounds= ttfj_ms= prefix_hit=
evictions=``). Headers stack in the order ``#trace``, ``#model``,
``#priority``, ``#stream``.

The brownout ladder (``--brownout``, serving/brownout.py): while the perf
plane's capacity headroom stays at or below ``--brownout-headroom`` (or
the SLO engine's fast burn at or above ``--brownout-burn``) for
``--brownout-hold`` seconds, the ladder climbs one level: 1 scales new
rows' decode caps by ``--brownout-cap-factor``, 2 evicts one
lower-priority decoding row a round when higher-priority work waits
(``!!SERVER-RETRY``), 3 sheds requests below ``--brownout-min-priority``
at admission (``!!SERVER-OVERLOADED``); ``--brownout-cool`` healthy
seconds step it down. A request picks its lane with ``#priority:N``.
``/sloz`` shows the ladder's state, and every escalation writes a flight
dump.

Fleet serving (``--fleet tag=model.npz,...``, request mode only;
serving/fleet/): one process serves several models, each a tenant with
its own lifecycle stack, warmed on demand (the newest committed bundle,
or the flat model) under ``--fleet-hbm-budget-mb`` (the coldest idle
tenant is evicted to make room; ``--fleet-watch`` hot-swaps each
resident tenant's new bundles). A request picks its tenant with
``#model:<tag>`` (or ``--fleet-default-tenant``); a well-formed tag
naming no tenant gets ``!!SERVER-ERROR``. With ``--slo-*`` each tenant
has its own SLO engine, and a tenant in fast burn sheds its own
low-priority requests. ``/fleetz`` shows the fleet's table.

``--dispatch-stall-timeout S`` (both modes) arms the scheduler's
dispatch watchdog: a device batch or engine round still running after S
seconds fails its requests with ``!!SERVER-RETRY`` and serving goes on
on a fresh worker thread (iteration mode on a rebuilt engine, whose KV
pool is allocated beside the wedged round's until that round returns).
It guards host-side stalls and overlong batches; a kernel that never
returns cannot be cancelled, and later work on its CUDA stream queues
behind it, so the watchdog does not revive a hung card.

Refused by name at startup: in iteration mode ``--alignment``,
``--word-scores`` and ``--output-approx-knn`` (``ITERATION_DECODE_SURFACE``
gives the reasons; a decode flag with no verdict there is refused as
UNCLASSIFIED), ``--shortlist`` with ``--force-decode`` in either mode,
ensembles, and ``--fleet`` with iteration mode or ``--model-watch``.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import obs
from ..common import logging as log
from ..data.batching import bucket_length
from ..obs import poolz as mpoolz
from ..obs import slo as mslo
from ..serving import metrics as msm
from ..serving.admission import AdmissionController, Overloaded
from ..serving.scheduler import (ContinuousScheduler, DispatchStalled,
                                 RequestTimeout, RowEvicted)

try:
    import websockets
    HAVE_WS = True
except ImportError:  # pragma: no cover — TCP where it is missing
    HAVE_WS = False

# graceful-drain budget on shutdown
DRAIN_TIMEOUT_S = 30.0
# per-connection cap on bytes the EOF watch may read ahead of the framing
# parser while a reply is pending
MAX_READAHEAD = 1 << 20

# Request headers, in the reference's stacking order #trace, #model,
# #priority, #stream (a malformed header is payload, never an error).
TRACE_PREFIX = "#trace:"
_MAX_TRACE_ID = 64
MODEL_PREFIX = "#model:"
_MAX_MODEL_TAG = 64
PRIORITY_PREFIX = "#priority:"
PRIORITY_MIN, PRIORITY_MAX = -9, 9
STREAM_PREFIX = "#stream:"
PARTIAL_PREFIX = "#partial:"


def _split_header(text: str, prefix: str, parse):
    """(parse(value) | None, body): a first line ``<prefix><value>`` whose
    value ``parse`` accepts is stripped; anything else is payload."""
    if not text.startswith(prefix):
        return None, text
    first, sep, rest = text.partition("\n")
    value = parse(first[len(prefix):].strip())
    if value is None:
        return None, text
    return value, rest if sep else ""


def _token(alphabet: str, limit: int):
    def parse(raw: str):
        ok = raw and len(raw) <= limit \
            and all(c.isalnum() or c in alphabet for c in raw)
        return raw if ok else None
    return parse


def _priority(raw: str):
    # clamped: the scheduler keeps one lane per distinct priority
    try:
        return max(PRIORITY_MIN, min(PRIORITY_MAX, int(raw)))
    except ValueError:
        return None


def split_trace_header(text: str) -> Tuple[Optional[str], str]:
    """(trace id | None, body): the reference's ``#trace:`` split; a
    malformed id is payload, never an error."""
    return _split_header(text, TRACE_PREFIX, _token("-_", _MAX_TRACE_ID))


def split_model_header(text: str) -> Tuple[Optional[str], str]:
    """(tenant tag | None, body): the reference's ``#model:`` split. Tags
    share the trace-id alphabet plus ``.``, so the first ``/`` of a pool
    owner label is an unambiguous tenant prefix; a malformed tag is
    payload, never an error."""
    return _split_header(text, MODEL_PREFIX, _token("-_.", _MAX_MODEL_TAG))


def split_headers(text: str) -> Tuple[Optional[str], Optional[str],
                                      Optional[int], Optional[bool], str]:
    """(trace id, model tag, priority, stream, body) of one request
    frame. Without ``--fleet`` the model tag is ignored, as the
    reference's single-model server does."""
    trace_id, body = split_trace_header(text)
    model_tag, body = split_model_header(body)
    priority, body = _split_header(body, PRIORITY_PREFIX, _priority)
    stream, body = _split_header(
        body, STREAM_PREFIX,
        lambda raw: raw == "1" if raw in ("0", "1") else None)
    return trace_id, model_tag, priority, stream, body


def _fleet_unrouted(lines: List[str]) -> List[str]:
    """The fleet scheduler's translate_lines: every request resolves
    through the tenant router, so reaching this is a routing bug (the
    server refuses an untagged request without a default tenant before
    it queues), never a client error."""
    raise RuntimeError(
        "fleet-mode batch reached the un-routed translate path — a "
        "request was queued without a tenant tag")


class TranslationService:
    """The loaded model, vocabularies and parameters, through the port's
    ``Translate`` (reference: TranslationService in marian_server.cpp)."""

    def __init__(self, options,
                 device: Optional[Union[str, torch.device]] = None):
        from ..translator.translator import Translate
        self.translator = Translate(options, device)
        self.options = options

    def translate_lines(self, lines: List[str]) -> List[str]:
        """One device batch of ``lines`` through ``Translate.run``, one
        translation a line. The current CUDA device is per thread, and a
        watchdog trip moves the calls onto a fresh worker thread: the
        model's card is made current for each call."""
        dev = self.translator.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            got = self.translator.run(lines=lines, stream=io.StringIO())
        if len(got) != len(lines):
            # the batched reply slicing relies on one entry a line: a
            # mismatch would route one client's text to another
            raise RuntimeError(
                f"translator returned {len(got)} lines for {len(lines)} "
                f"inputs — per-request reply slicing would misalign")
        return got


def resolve_token_budget(options) -> int:
    """--batch-token-budget, or ``--mini-batch`` x the bucketed
    ``--max-length`` + 1 when it is unset."""
    budget = int(options.get("batch-token-budget", 0) or 0)
    if budget > 0:
        return budget
    mb = max(1, int(options.get("mini-batch", 1) or 1))
    ml = max(1, int(options.get("max-length", 50) or 50))
    return mb * bucket_length(ml + 1)


def _flag_set(options, flag: str) -> bool:
    return options.get(flag, None) not in (None, False, [], "", 0)


class ServingApp:
    """One serving stack: the model (TranslationService), the scheduler
    in the configured batching mode (with the paged engine in iteration
    mode), admission control, the metrics port and, with
    ``--model-watch``, the model lifecycle, with ``--brownout`` the
    ladder, with ``--fleet`` the tenants instead of one boot model.
    ``translate_lines`` (request mode) and ``engine`` (iteration mode)
    inject what would otherwise be built from the options,
    ``executor_factory`` the lifecycle's (or each tenant's) loader of a
    bundle and ``registry`` the metrics registry; ``device`` overrides
    the device the options resolve."""

    # The decode-output flags iteration mode must take a position on, and
    # that position: True = carried by the engines' feature plane, a
    # string = why the paged path refuses it. A set flag with no entry is
    # refused as UNCLASSIFIED, never decoded without its feature.
    DECODE_SURFACE_FLAGS = ("n-best", "output-sampling", "force-decode",
                            "shortlist", "alignment", "word-scores",
                            "output-approx-knn")
    ITERATION_DECODE_SURFACE = {
        "n-best": True,
        "output-sampling": True,
        "force-decode": True,
        "shortlist": True,
        "alignment": "alignment output — the paged step keeps no "
                     "per-row attention tap",
        "word-scores": "per-word scores — the paged step keeps no "
                       "per-token logp trail",
        "output-approx-knn": "approximate-knn output layers — the LSH "
                             "projection is batch-shaped, not per-row",
    }

    def __init__(self, options, engine=None,
                 device: Optional[Union[str, torch.device]] = None,
                 translate_lines: Optional[
                     Callable[[List[str]], List[str]]] = None,
                 registry: Optional[msm.Registry] = None,
                 executor_factory=None):
        self.options = options
        self._validate_options(options)
        # --fleet: the tenants replace the one boot model; a bad spec or
        # default tenant fails here, before anything is built
        fleet_specs = self._fleet_specs(options)
        # the observability plane: --trace enables the span tracer,
        # --trace-dump arms the flight recorder, --perf-accounting the
        # perf plane; /tracez, /sloz and /poolz ride the metrics port
        obs.configure(options)
        self.batching_mode = str(options.get("batching-mode", "request"))
        self.registry = registry if registry is not None else msm.REGISTRY
        self.device = device
        self.service: Optional[TranslationService] = None
        stall = float(options.get("dispatch-stall-timeout", 0) or 0)
        budget = resolve_token_budget(options)
        max_queue = int(options.get("max-queue", 512) or 0)
        if self.batching_mode == "request":
            if translate_lines is None and fleet_specs:
                # no boot model: every batch resolves through the tenant
                # router; the tenants' decoders cut batches by the budget
                options.set("mini-batch-words", budget)
                options.set("mini-batch", budget)
                options.set("maxi-batch", 1)
                translate_lines = _fleet_unrouted
            if translate_lines is None:
                # one scheduler batch is one device batch: the decoder
                # cuts by the same budget, and its window (maxi-batch x
                # mini-batch sentences) holds any batch (rows are at
                # most budget / the narrowest bucket)
                options.set("mini-batch-words", budget)
                options.set("mini-batch", budget)
                options.set("maxi-batch", 1)
                self.service = TranslationService(options, device)
                translate_lines = self.service.translate_lines
            self.max_queue_pages = 0
            self.scheduler = ContinuousScheduler(
                translate_lines, token_budget=budget,
                batching_mode="request", stall_timeout=stall,
                registry=self.registry)
            # request mode bounds queued sentences only: no pool
            self.admission = AdmissionController(
                max_queue, self.scheduler.queued_units,
                registry=self.registry)
        else:
            if engine is None:
                self.service = TranslationService(options, device)
                engine = self._build_engine()
            # admission prices queue debt in pages: by default 4x the pool
            self.max_queue_pages = \
                int(options.get("max-queue-pages", 0) or 0) \
                or 4 * engine.pool.usable_pages
            # the rebuild after a watchdog trip or a failed round resolves
            # through the lifecycle when one is attached: the fresh
            # engine must serve the CURRENT live version
            self.scheduler = ContinuousScheduler(
                batching_mode="iteration", engine=engine,
                engine_factory=(self._rebuild_live_engine if self.service
                                else None),
                stall_timeout=stall, registry=self.registry)
            self.admission = AdmissionController(
                max_queue, self.scheduler.queued_units,
                max_queue_pages=self.max_queue_pages,
                pages_fn=self.scheduler.queued_pages,
                registry=self.registry)
            # every flight dump embeds the KV page map of its moment,
            # resolved through the scheduler (swaps and rebuilds re-point
            # its engine)
            obs.FLIGHT.add_snapshot_provider(
                "pool", lambda: mpoolz.snapshot(self.scheduler))
        self._pool_provider = self.batching_mode == "iteration"
        self.request_timeout = float(options.get("request-timeout", 0) or 0)
        self.metrics_server: Optional[msm.MetricsServer] = None
        self._started = False
        # the perf plane: the headroom gauge's queue pressure (sentences
        # against --max-queue in request mode, pages against the page
        # bound in iteration mode) and the MFU gauge's geometry
        self._perf_wired = obs.PERF.enabled
        if obs.PERF.enabled:
            if self.registry is not msm.REGISTRY:
                # configure() declared the perf series on the global
                # registry; this app scrapes its own
                obs.PERF.enable(registry=self.registry)
            if self.batching_mode == "iteration":
                obs.PERF.set_capacity_inputs(self.scheduler.queued_pages,
                                             self.max_queue_pages)
            else:
                obs.PERF.set_capacity_inputs(
                    self.scheduler.queued_units,
                    self.admission.max_queue_units)
            self._set_perf_geometry()
        # the SLO burn-rate engine, only with an objective declared; it
        # reads the scheduler's series on its own thread
        self.slo: Optional[mslo.SloEngine] = \
            mslo.maybe_build_engine(options, self.registry)
        if self.slo is not None:
            obs.FLIGHT.add_snapshot_provider("slo", self.slo.state)
        # the brownout ladder (--brownout): degradation levels over the
        # perf plane's headroom and the SLO engine's fast burn
        self.brownout = None
        self._brownout_cap_factor = float(
            options.get("brownout-cap-factor", 0.5) or 0.5)
        self._brownout_min_priority = int(
            options.get("brownout-min-priority", 1) or 1)
        if options.get("brownout", False):
            self._init_brownout(options)
        # zero-downtime lifecycle (--model-watch SECONDS): registry +
        # watcher + warmup + swap controller over <model>.bundles/
        self.lifecycle = None
        self.watcher = None
        watch_s = float(options.get("model-watch", 0) or 0)
        if watch_s > 0:
            self._init_lifecycle(watch_s, translate_lines, executor_factory)
        self.fleet = None
        if fleet_specs:
            self._init_fleet(fleet_specs, executor_factory)

    def _fleet_specs(self, options):
        """The parsed ``--fleet`` tenants ([] without a fleet), with the
        reference's refusals: iteration mode, ``--model-watch`` and a
        ``--fleet-default-tenant`` that names no tenant."""
        self._fleet_default = str(
            options.get("fleet-default-tenant", "") or "")
        spec = str(options.get("fleet", "") or "")
        if not spec:
            return []
        if str(options.get("batching-mode", "request")) == "iteration":
            raise ValueError(
                "--fleet serves --batching-mode request only: the "
                "paged iteration engine is single-model (route "
                "iteration tenants to dedicated replicas)")
        if float(options.get("model-watch", 0) or 0) > 0:
            raise ValueError(
                "--fleet and --model-watch are mutually exclusive: "
                "the fleet already runs one bundle watcher per "
                "tenant (--fleet-watch)")
        from ..serving import fleet as mfleet
        specs = mfleet.parse_fleet_spec(spec)
        tags = {sp.tag for sp in specs}
        if self._fleet_default and self._fleet_default not in tags:
            raise ValueError(
                f"--fleet-default-tenant '{self._fleet_default}' is not "
                f"a configured tenant (have: {', '.join(sorted(tags))})")
        return specs

    @classmethod
    def _validate_options(cls, options) -> None:
        """The option surface this slice serves; everything else fails
        loudly here, before a model loads, rather than serving something
        other than asked."""
        mode = str(options.get("batching-mode", "request") or "request")
        if mode not in ("request", "iteration"):
            raise ValueError(f"--batching-mode must be request or "
                             f"iteration, got {mode!r}")
        if _flag_set(options, "shortlist") \
                and _flag_set(options, "force-decode"):
            # the dense search refuses the pair a batch, the plane at
            # construction: caught here, before a model loads
            raise ValueError(
                "--shortlist together with --force-decode (forced prefix "
                "ids are full-vocab, shortlisted logits are not)")
        if mode == "request":
            return          # the decoder refuses its own unported flags
        refused = []
        for flag in cls.DECODE_SURFACE_FLAGS:
            if not _flag_set(options, flag):
                continue
            verdict = cls.ITERATION_DECODE_SURFACE.get(flag)
            if verdict is True:
                continue
            if not verdict:
                verdict = ("UNCLASSIFIED decode flag — add it to "
                           "ITERATION_DECODE_SURFACE before serving it in "
                           "iteration mode")
            refused.append(f"--{flag} ({verdict})")
        if refused:
            raise NotImplementedError(
                "--batching-mode iteration does not support: "
                + "; ".join(refused))
        beam = int(options.get("beam-size", 6) or 6)
        steps = int(options.get("iteration-steps", 1) or 1)
        merge = str(options.get("iteration-beam-merge", "fused") or "fused")
        problems = []
        if beam < 1:
            problems.append("--beam-size must be >= 1")
        if steps < 1:
            problems.append(f"--iteration-steps must be >= 1 (got {steps})")
        if merge not in ("fused", "host"):
            problems.append(f"--iteration-beam-merge {merge!r} (choose "
                            f"'fused' or 'host')")
        elif merge == "host" and steps > 1 \
                and (beam > 1 or _flag_set(options, "n-best")):
            problems.append(
                f"--iteration-beam-merge host with --iteration-steps "
                f"{steps}: the host merge needs the host between steps "
                f"(rounds run single-step) — drop to --iteration-steps 1")
        rows = int(options.get("iteration-rows", 32) or 32)
        if beam > rows:
            problems.append(f"--beam-size {beam} exceeds --iteration-rows "
                            f"{rows} (one sentence needs beam-size decode "
                            f"slots)")
        if len(list(options.get("models", []) or [])) > 1:
            problems.append("--models ensembles are not supported")
        if problems:
            raise ValueError("--batching-mode iteration does not support: "
                             + "; ".join(problems))

    def _build_engine(self):
        """A fresh paged engine over the boot model."""
        return self._engine_for(self.service)

    def _engine_for(self, service: TranslationService):
        """A fresh paged engine over ``service``'s model: greedy at
        --beam-size 1, the copy-on-write beam engine above it (and at
        beam 1 under --n-best); the decode-feature plane of the decode
        flags; with --prefix-cache its own cache, stamped with the model
        path (a rebuilt or swapped-in engine starts with an empty one)."""
        from ..translator.decode_features import FeaturePlane
        from ..translator.iteration import PagedDecodeEngine
        tr = service.translator
        opts = service.options
        ml = max(1, int(opts.get("max-length", 50) or 50))
        plane = FeaturePlane.from_options(opts, tr.src_vocab, tr.trg_vocab)
        if plane is not None:
            log.info("iteration decode-feature plane: {}", plane.describe())
        prefix = None
        if opts.get("prefix-cache", False):
            from ..translator.prefix_cache import PrefixCache
            prefix = PrefixCache(
                max_entries=int(opts.get("prefix-cache-entries", 64) or 64),
                version=str((opts.get("models", None) or ["model"])[0]))
            if plane is not None and plane.n_best:
                # a cached n-best block carries the first request's
                # sentence numbers: replayed, it would mislabel every line
                log.info("--n-best disables the prefix cache: cached n-best "
                         "replies would carry another request's sentence "
                         "ids")
                prefix = None
        kw = dict(
            max_rows=int(opts.get("iteration-rows", 32) or 32),
            page_len=int(opts.get("kv-page-len", 16) or 16),
            pool_bytes=int(opts.get("kv-pool-bytes", 0) or 0),
            src_len_cap=bucket_length(ml + 1),
            max_length_cap=ml,
            max_length_factor=float(
                opts.get("max-length-factor", 3.0) or 3.0),
            steps_per_round=int(opts.get("iteration-steps", 1) or 1),
            prefix_cache=prefix, features=plane)
        beam = int(opts.get("beam-size", 6) or 6)
        if beam == 1 and not (plane is not None and plane.n_best):
            return PagedDecodeEngine(tr.model, tr.params, tr.src_vocab,
                                     tr.trg_vocab, **kw)
        from ..translator.beam_iteration import PagedBeamEngine
        norm = opts.get("normalize", 0.0)
        if norm is True:
            norm = 1.0
        return PagedBeamEngine(
            tr.model, tr.params, tr.src_vocab, tr.trg_vocab,
            beam_size=beam, normalize=float(norm or 0.0),
            word_penalty=float(opts.get("word-penalty", 0.0) or 0.0),
            allow_unk=bool(opts.get("allow-unk", False)),
            merge=str(opts.get("iteration-beam-merge", "fused") or "fused"),
            **kw)

    def _set_perf_geometry(self) -> None:
        """The MFU gauge's geometry: the served model's widths and
        depths, the beam, and the peak of its compute dtype on its card
        (an unknown device, the CPU, reads MFU 0). An injected
        ``translate_lines`` without a model leaves the geometry unset."""
        engine = self.scheduler.engine
        if self.service is not None:
            tr = self.service.translator
            model, vocab, device = tr.model, len(tr.trg_vocab), tr.device
        elif engine is not None and hasattr(engine, "model"):
            model, vocab, device = (engine.model, len(engine.trg_vocab),
                                    engine.device)
        else:
            return
        cfg = model.cfg
        beam = (getattr(engine, "beam_size", 1) if engine is not None
                else int(self.options.get("beam-size", 12) or 12))
        kind = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "")
        obs.PERF.set_geometry(
            emb=cfg.dim_emb, ffn=cfg.dim_ffn, enc_depth=cfg.enc_depth,
            dec_depth=cfg.dec_depth, vocab=vocab, beam=beam, n_devices=1,
            device_kind=kind, compute_dtype=str(cfg.compute_dtype))

    # -- the brownout ladder (--brownout) -----------------------------------
    def _init_brownout(self, options) -> None:
        """The ladder over the perf plane's headroom and the SLO engine's
        fast burn (its own accounting: none), its level applied to the
        scheduler and admission, its state a flight-dump member."""
        from ..serving.brownout import BrownoutController
        burn_thr = float(options.get("brownout-burn", 0) or 0)
        if burn_thr <= 0:
            # the SLO engine's fast-burn factor; with no SLO declared the
            # burn signal is off and headroom drives the ladder alone
            burn_thr = self.slo.fast_factor if self.slo is not None \
                else 0.0
        self.brownout = BrownoutController(
            apply_fn=self._apply_brownout,
            headroom_fn=obs.PERF.headroom if obs.PERF.enabled else None,
            burn_fn=self.slo.fast_burn if self.slo is not None else None,
            registry=self.registry,
            headroom_floor=float(
                options.get("brownout-headroom", 0.1) or 0.1),
            burn_threshold=burn_thr,
            hold_s=float(options.get("brownout-hold", 5.0) or 5.0),
            cool_s=float(options.get("brownout-cool", 15.0) or 15.0))
        obs.FLIGHT.add_snapshot_provider("brownout", self.brownout.state)
        if not obs.PERF.enabled and burn_thr <= 0:
            # both signals dead: the ladder would tick forever without
            # escalating while the operator believes it protects them
            log.warn("--brownout is armed but BOTH of its signals "
                     "are disabled (--perf-accounting off and no "
                     "--slo-* objective declared): the ladder will "
                     "never escalate. Enable --perf-accounting or "
                     "declare an SLO (or set --brownout-burn > 0).")

    def _apply_brownout(self, level: int) -> None:
        """The ladder's effect: the level into the scheduler (cap scale,
        row eviction) and admission (lane shedding)."""
        self.scheduler.set_brownout_level(
            level, cap_factor=self._brownout_cap_factor)
        self.admission.set_brownout(level, self._brownout_min_priority)

    # -- fleet serving (--fleet) --------------------------------------------
    def _init_fleet(self, specs, executor_factory) -> None:
        """The FleetManager (per-tenant lifecycle stacks under a shared
        budget), wired into the scheduler's tenant router and per-tenant
        version labels, with per-tenant SLO engines under ``--slo-*``
        and the fleet's table as a flight-dump member."""
        from ..device import resolve_device
        from ..serving import fleet as mfleet
        from ..serving.lifecycle import load_golden
        opts = self.options
        # the tenants' models land on the card resolved now: warms run
        # on the device worker thread, whose current device is its own
        dev = resolve_device(self.device,
                             int(opts.get("cpu-threads", 0) or 0))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._fleet_device = dev
        self.fleet = mfleet.FleetManager(
            specs,
            executor_factory or self._fleet_executor_factory,
            metrics_registry=self.registry,
            hbm_budget_bytes=int(
                float(opts.get("fleet-hbm-budget-mb", 0) or 0) * (1 << 20)),
            watch_interval=float(opts.get("fleet-watch", 0) or 0),
            golden=load_golden(opts.get("warmup-golden", "") or None),
            canary_fraction=float(opts.get("canary-fraction", 0) or 0),
            rollback_error_rate=float(
                opts.get("rollback-error-rate", 0.5) or 0.5),
            rollback_p99_factor=float(
                opts.get("rollback-p99-factor", 0) or 0),
            canary_min_batches=int(
                opts.get("canary-min-batches", 8) or 8),
            brownout_min_priority=self._brownout_min_priority)
        n = self.fleet.build_slos(
            availability=float(opts.get("slo-availability", 0) or 0),
            p99_ms=float(opts.get("slo-p99-ms", 0) or 0))
        if n:
            log.info("fleet: per-tenant SLO engines armed for {} "
                     "tenant(s)", n)
        self.scheduler.tenant_router = self.fleet.executor_for
        self.scheduler.tenant_version_fn = self.fleet.live_version_name
        obs.FLIGHT.add_snapshot_provider("fleet", self.fleet.status)

    def _fleet_executor_factory(self, bundle_dir: str, manifest):
        """A tenant's executor: a TranslationService over the bundle's
        model member, or over ``bundle_dir`` itself when the tenant warms
        from its flat model (no bundle committed yet), loaded on the
        fleet's card."""
        if os.path.isfile(bundle_dir):
            model = bundle_dir
        else:
            members = (manifest or {}).get("members", {}) or {}
            model = next(
                (os.path.join(bundle_dir, rel) for rel in sorted(members)
                 if rel.endswith(".npz") and "optimizer" not in rel),
                None)
            if model is None:
                raise ValueError(
                    f"fleet: bundle {bundle_dir} carries no model "
                    f"member (members: {sorted(members) or 'none'})")
        dev = self._fleet_device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return TranslationService(self.options.with_(models=[model]),
                                      dev).translate_lines

    # -- the model lifecycle (--model-watch) --------------------------------
    def _device_context(self):
        """The boot model's card made current: the watcher, the admin
        HTTP thread and a rebuilding worker each start with device 0
        current, and a bundle's model must land beside the boot one."""
        dev = self.service.translator.device if self.service is not None \
            else None
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _bundle_service(self, bundle_dir: str) -> TranslationService:
        """A TranslationService over a bundle's model member, on the boot
        model's device, loaded outside every other thread's sync-debug
        guard (the copy to the card syncs the host)."""
        from ..translator.iteration import sync_exclusive
        member = os.path.basename(self._model_path())
        bopts = self.options.with_(models=[os.path.join(bundle_dir,
                                                        member)])
        dev = self.service.translator.device if self.service is not None \
            else self.device
        with self._device_context(), sync_exclusive():
            return TranslationService(bopts, dev)

    def _bundle_executor_factory(self, bundle_dir: str, manifest):
        """Request mode's executor_factory: a fresh TranslationService
        against a bundle's model member, warmed off the serving path,
        then swapped in whole."""
        return self._bundle_service(bundle_dir).translate_lines

    def _bundle_engine_factory(self, bundle_dir: str, manifest):
        """Iteration mode's executor_factory: a warmed candidate is a
        whole paged engine (the bundle's model and its own KV pool) in an
        ``EngineExecutor``, callable for the golden decode, with
        ``.engine`` for the quiesce re-point."""
        from ..translator.iteration import EngineExecutor, sync_exclusive
        service = self._bundle_service(bundle_dir)
        with self._device_context(), sync_exclusive():
            return EngineExecutor(self._engine_for(service))

    def _rebuild_live_engine(self):
        """The scheduler's engine_factory (after a watchdog trip or a
        failed round): a fresh engine for the CURRENT live version. With
        the lifecycle attached it is built from the live version's
        bundle, and the controller adopts it, so round attribution and
        rollbacks follow the engine actually serving. The build runs on
        the event loop: a bounded stall, paid only on a trip."""
        from ..translator.iteration import EngineExecutor
        lc = self.lifecycle
        if lc is not None:
            v = lc.live_version()
            if v is not None and getattr(v, "bundle_dir", ""):
                ex = self._bundle_engine_factory(v.bundle_dir,
                                                 v.manifest or {})
                lc.adopt_live_executor(ex)
                return ex.engine
        with self._device_context():
            engine = self._build_engine()
        if lc is not None:
            lc.adopt_live_executor(EngineExecutor(engine))
        return engine

    def _model_path(self) -> str:
        models = self.options.get("models", []) or []
        return str(models[0] if models
                   else self.options.get("model", "") or "")

    @staticmethod
    def _adopt_boot_bundle(model_path: str, valid):
        """Which committed bundle IS the flat (published) model file?
        Same inode in the normal hardlink-publish case; otherwise ONE
        content hash of the flat file compared against each manifest's
        recorded member sha256 (copy-fallback publish). None when it
        matches no bundle (stale publish, hand-copied model)."""
        from ..training import bundle as bdl
        base = os.path.basename(model_path)
        for b in reversed(valid):
            try:
                if os.path.samefile(model_path,
                                    os.path.join(b.bundle_dir, base)):
                    return b
            except OSError:
                continue
        try:
            flat_sha = bdl.file_sha256(model_path)
        except OSError:
            return None
        for b in reversed(valid):
            rec = (b.manifest or {}).get("members", {}).get(base) or {}
            if rec.get("sha256") == flat_sha:
                return b
        return None

    def _init_lifecycle(self, interval: float, boot_translate,
                        executor_factory) -> None:
        from ..serving.lifecycle import (BundleWatcher, SwapController,
                                         load_golden, scan_bundles)
        from ..training import bundle as bdl
        from ..translator.iteration import EngineExecutor
        model_path = self._model_path()
        if not model_path:
            log.warn("--model-watch: no model path to watch; lifecycle "
                     "disabled")
            return
        iteration = self.batching_mode == "iteration"
        factory = executor_factory or (
            self._bundle_engine_factory if iteration
            else self._bundle_executor_factory)
        self.lifecycle = SwapController(
            executor_factory=factory,
            metrics_registry=self.registry,
            canary_fraction=float(
                self.options.get("canary-fraction", 0) or 0),
            rollback_error_rate=float(
                self.options.get("rollback-error-rate", 0.5) or 0.5),
            rollback_p99_factor=float(
                self.options.get("rollback-p99-factor", 0) or 0),
            canary_min_batches=int(
                self.options.get("canary-min-batches", 8) or 8),
            golden=load_golden(
                self.options.get("warmup-golden", "") or None))
        # seed the boot model as the live version, under the name of the
        # bundle the flat model file verifiably IS: a crash between the
        # bundle commit and the flat publish, or a hand-copied model,
        # leaves the flat file older, and the watcher must then warm and
        # swap to anything newer instead of serving stale weights under
        # the newest bundle's name
        boot_seq, boot_name, boot_compat = 0, "boot", None
        valid = [b for b in scan_bundles(model_path) if b.ok]
        adopted = self._adopt_boot_bundle(model_path, valid)
        if adopted is not None:
            boot_seq = adopted.seq
            boot_name = os.path.basename(adopted.bundle_dir)
            boot_compat = bdl.manifest_compat(adopted.manifest)
            if adopted is not valid[-1]:
                log.warn("--model-watch: boot model {} matches {} but "
                         "newer committed bundles exist (stale publish?); "
                         "the watcher will hot-swap to the newest",
                         model_path, boot_name)
        elif valid:
            # valid bundles exist but the flat file matches none of them:
            # seed one seq below the newest so the watcher ingests it
            boot_seq = valid[-1].seq - 1
            log.warn("--model-watch: boot model {} matches no committed "
                     "bundle; seeding as '{}' (seq {}) so the newest "
                     "bundle is warmed and swapped in", model_path,
                     boot_name, boot_seq)
        if boot_compat is None and self.service is not None:
            opts = self.service.translator.options
            boot_compat = bdl.compat_block(
                opts, list(opts.get("vocabs", None) or []))
        if iteration:
            # the boot executor wraps the engine the scheduler runs; the
            # quiesce protocol re-points at successors' engines
            self.lifecycle.seed_live(
                boot_seq, boot_name, EngineExecutor(self.scheduler.engine),
                compat=boot_compat)
            self.lifecycle.attach_iteration(
                self.scheduler,
                float(self.options.get("quiesce-deadline", 2.0) or 2.0))
        else:
            self.lifecycle.seed_live(boot_seq, boot_name, boot_translate,
                                     compat=boot_compat)
            self.scheduler.translate_lines = self.lifecycle.route
        self.scheduler.version_fn = self.lifecycle.live_version_name
        self.watcher = BundleWatcher(bdl.bundle_root(model_path),
                                     self.lifecycle.ingest,
                                     interval=interval,
                                     last_seq=boot_seq)
        # a trainer in this process pushes the watcher on each commit
        # instead of waiting out the poll interval
        bdl.add_commit_hook(self._on_bundle_commit)

    def _on_bundle_commit(self, model_path: str, bundle_dir: str,
                          manifest) -> None:
        if self.watcher is not None \
                and os.path.dirname(os.path.abspath(bundle_dir)) \
                == os.path.abspath(self.watcher.root):
            self.watcher.notify()

    def _admin_routes(self) -> Dict:
        """Lifecycle endpoints on the metrics port: GET /lifecyclez
        (version table + health), POST /admin/pin | /admin/unpin |
        /admin/rollback (operator verbs). They run on the metrics HTTP
        thread: an iteration-mode rollback waits there for the serving
        loop's quiesce, never on the loop itself."""
        lc = self.lifecycle

        def _lifecyclez(method: str, query: str):
            body = json.dumps(lc.status(), indent=1).encode() + b"\n"
            return 200, body, "application/json"

        def _verb(fn, name):
            def handler(method: str, query: str):
                if method != "POST":
                    return (405, b"POST only\n", "text/plain")
                with self._device_context():
                    ok = fn()
                ok = True if ok is None else bool(ok)
                body = json.dumps({"ok": ok, "verb": name,
                                   "live": lc.live_version_name()}
                                  ).encode() + b"\n"
                return (200 if ok else 409, body, "application/json")
            return handler

        return {
            "/lifecyclez": _lifecyclez,
            "/admin/pin": _verb(lc.pin, "pin"),
            "/admin/unpin": _verb(lc.unpin, "unpin"),
            "/admin/rollback": _verb(lc.rollback, "rollback"),
        }

    def ready(self) -> bool:
        """/readyz: accepting traffic (started, not draining, and — with
        the lifecycle — a live version is routing)."""
        if not self._started or self.admission.draining:
            return False
        return self.lifecycle is None or self.lifecycle.has_live()

    def _boot_warmup(self) -> None:
        """--warmup-on-boot: a golden decode of the boot model at each
        width bucket BEFORE the first client lands. Failure degrades to
        a warning: a cold-but-correct server beats no server."""
        from ..serving.lifecycle.warmup import (DEFAULT_GOLDEN,
                                                load_golden, smoke_buckets,
                                                smoke_engine_grid)
        from ..translator.iteration import EngineExecutor
        try:
            golden = load_golden(
                self.options.get("warmup-golden", "") or None) \
                or list(DEFAULT_GOLDEN)
            if self.scheduler.engine is not None:
                ex = EngineExecutor(self.scheduler.engine)
                smoke_buckets(ex, golden, "boot model")
                smoke_engine_grid(ex, golden, "boot model")
            else:
                smoke_buckets(self.scheduler.translate_lines, golden,
                              "boot model")
        except Exception as e:  # noqa: BLE001
            log.warn("--warmup-on-boot failed ({}); first requests pay "
                     "their first launches inline", e)

    def start(self) -> None:
        """Start the scheduler on the RUNNING loop, then the metrics
        port, the SLO engine, the boot warmup and the bundle watcher."""
        self.scheduler.start()
        # /tracez, /sloz and /poolz always answer (a disabled plane says
        # so rather than 404); the admin verbs exist with the lifecycle
        routes = obs.trace_routes()
        routes.update(mslo.slo_routes(lambda: self.slo,
                                      lambda: self.brownout))
        routes.update(obs.pool_routes(lambda: self.scheduler))
        if self.lifecycle is not None:
            routes.update(self._admin_routes())
        if self.fleet is not None:
            # /fleetz: per-tenant residency, live version, batches in
            # flight, cold starts, SLO burn and page sums
            routes["/fleetz"] = lambda method, query: (
                200, json.dumps(self.fleet.status(), indent=1).encode()
                + b"\n", "application/json")
        self.metrics_server = msm.maybe_start_metrics_server(
            self.options, ready_fn=self.ready, routes=routes,
            registry=self.registry)
        if self.slo is not None:
            self.slo.start()
        if self.brownout is not None:
            self.brownout.start()
        if self.options.get("warmup-on-boot", False):
            self._boot_warmup()
        if self.watcher is not None:
            self.watcher.start()
        if self.fleet is not None:
            # pre-warm every tenant the budget allows (in tag order, so
            # the earliest are the first victims) and start the
            # per-tenant SLO evaluator and bundle watchers
            self.fleet.start()
        self._started = True
        timeout = (f"{self.request_timeout}s" if self.request_timeout
                   else "none")
        limit = self.admission.max_queue_units or "unbounded"
        engine = self.scheduler.engine
        if engine is None:
            log.info("Serving: request mode, beam {}, batches of {} "
                     "tokens, queue limit {} sentences, request timeout {}",
                     self.options.get("beam-size", 12),
                     self.scheduler.token_budget, limit, timeout)
            return
        prefix = getattr(engine, "prefix", None)
        log.info("Serving on {}: iteration mode, beam {} ({} merge), {} rows, "
                 "{} steps a round, KV pool of {} pages of {} tokens, prefix "
                 "cache {}, queue limit {} sentences / {} pages, request "
                 "timeout {}", engine.device, getattr(engine, "beam_size", 1),
                 getattr(engine, "merge", "no"), engine.max_rows,
                 engine.steps_per_round, engine.pool.usable_pages,
                 engine.page_len,
                 f"of {prefix.max_entries} entries" if prefix else "off",
                 limit, self.max_queue_pages, timeout)

    async def handle_frame(self, text: str,
                           send_partial: Optional[Callable[[str], None]]
                           = None) -> str:
        """One request frame in, one reply frame out: headers, admission,
        scheduler, reply. ``send_partial`` writes a ``#stream:1``
        request's partial frames (on the event-loop thread, in order,
        before this returns the final reply); without it the header is
        ignored. A ``#trace:<id>`` request's reply starts with its
        metadata line."""
        reply, done = await self.serve_frame(text, send_partial)
        done(0)
        return reply

    async def serve_frame(self, text: str,
                          send_partial: Optional[Callable[[str], None]]
                          = None) -> Tuple[str, Callable[[int], None]]:
        """``handle_frame`` for a transport: (reply, done), where the
        transport calls ``done(nbytes)`` once the reply's bytes are
        written, which records the ``reply.write`` span and ends the
        request's root span (a no-op with the tracer off)."""
        t0 = time.perf_counter()
        trace_id, model_tag, priority, stream, body = split_headers(text)
        priority = priority or 0
        on_partial = None
        if stream and send_partial is not None:
            def on_partial(idx: int, partial: str, _ntok: int) -> None:
                send_partial(f"{PARTIAL_PREFIX}{idx} {partial}")
        lines = body.split("\n")
        # fleet mode: the #model: tag picks the tenant (or the default);
        # without a fleet the header is ignored
        tenant = ""
        if self.fleet is not None:
            tenant = model_tag or self._fleet_default
        span = None
        if obs.enabled():
            span = obs.start_span("request", trace_id=trace_id or None,
                                  n_sentences=len(lines),
                                  priority=priority, tenant=tenant)
        # the queue/service breakdown is collected iff the client asked
        # for it with a trace header
        meta: Optional[Dict] = {} if trace_id is not None else None

        def finish(outcome: str, reply: str):
            if self.fleet is not None and tenant:
                # the tenant-labeled series its SLO engine burns against
                self.fleet.note_outcome(tenant, outcome,
                                        time.perf_counter() - t0)
            return self._finish_frame(trace_id, meta, span, outcome, reply)

        if self.fleet is not None and not self.fleet.has_tenant(tenant):
            # a well-formed tag naming no tenant (or no tag and no
            # default) is an explicit error: translating with the wrong
            # model is the one thing a fleet must never do. The shed
            # label is "?": a client-controlled label value would be
            # unbounded
            self.fleet.note_shed("?", "unknown_tenant")
            tenant = ""     # the unknown tag bills no outcome
            return finish(
                "failure",
                f"!!SERVER-ERROR unknown model tag "
                f"'{model_tag or self._fleet_default or '(none)'}' — "
                f"send #model:<tag> "
                f"(configured: {', '.join(self.fleet.tags())})")
        engine = self.scheduler.engine
        try:
            # admitted inside the span's context, so a shed's timeline
            # event carries the trace id; a tenant burning its own error
            # budget sheds before it costs global queue space
            with obs.TRACER.use(span):
                if self.fleet is not None:
                    self.fleet.gate(tenant, priority)
                self.admission.admit(
                    len(lines), n_pages=sum(engine.pages_for_text(l)
                                            for l in lines)
                    if engine else 0, priority=priority)
        except Overloaded as e:
            return finish("shed", f"!!SERVER-OVERLOADED {e}")
        with obs.TRACER.use(span):
            fut = self.scheduler.submit(
                lines, priority=priority,
                timeout=self.request_timeout or None,
                on_partial=on_partial, meta=meta, trace_id=trace_id,
                tenant=tenant)
        try:
            out = await fut
        except RequestTimeout as e:
            return finish("timeout", f"!!SERVER-TIMEOUT {e}")
        except DispatchStalled as e:
            return finish("stalled", f"!!SERVER-RETRY {e}")
        except RowEvicted as e:
            return finish("evicted", f"!!SERVER-RETRY {e}")
        except asyncio.CancelledError:
            # a client abort: the root span is recorded before unwinding
            if self.fleet is not None and tenant:
                self.fleet.note_outcome(tenant, "cancelled",
                                        time.perf_counter() - t0)
            obs.end(span, outcome="cancelled")
            raise
        except Exception:  # noqa: BLE001 — logged by the scheduler
            return finish("failure", "")
        return finish("ok", "\n".join(out))

    @staticmethod
    def _finish_frame(trace_id: Optional[str], meta: Optional[Dict],
                      span, outcome: str, reply: str
                      ) -> Tuple[str, Callable[[int], None]]:
        """The reply with its metadata line for a tracing client, and
        the ``done`` callback that records the write and ends the root
        span."""
        if trace_id is not None:
            m = meta or {}
            line = (f"{TRACE_PREFIX}{trace_id} "
                    f"outcome={m.get('outcome', outcome)} "
                    f"queue_ms={m.get('queue_s', 0.0) * 1e3:.1f} "
                    f"service_ms={m.get('service_s', 0.0) * 1e3:.1f} "
                    f"model_version={m.get('model_version', '-')}")
            if "rounds" in m:
                # iteration mode's row breakdown: rounds ridden, time to
                # first join (-1: never joined), a prefix-cache hit,
                # retriable evictions
                line += (f" rounds={m['rounds']} "
                         f"ttfj_ms={m.get('ttfj_ms', -1.0):.1f} "
                         f"prefix_hit={m.get('prefix_hit', 0)} "
                         f"evictions={m.get('evictions', 0)}")
            reply = line + "\n" + reply
        if span is None:
            return reply, lambda nbytes=0: None
        t_reply = time.perf_counter()

        def done(nbytes: int = 0) -> None:
            obs.TRACER.record("reply.write", t_reply, time.perf_counter(),
                              parent=span, nbytes=nbytes)
            obs.end(span, outcome=outcome)
        return reply, done

    def close_nowait(self) -> None:
        """Synchronous cleanup (after a drain, cancelled contexts, test
        teardown): the perf plane's inputs are unwired, the flight
        recorder's providers removed, and the SLO engine, the brownout
        ladder (back at level 0), the bundle watcher, the fleet's
        watchers and the metrics port stop."""
        self._started = False
        if self._perf_wired:
            # a scrape after close must not sample a dead scheduler
            obs.PERF.set_capacity_inputs(None, 0)
            self._perf_wired = False
        if self._pool_provider:
            obs.FLIGHT.remove_snapshot_provider("pool")
            self._pool_provider = False
        if self.slo is not None:
            self.slo.stop()
            obs.FLIGHT.remove_snapshot_provider("slo")
        if self.brownout is not None:
            self.brownout.stop()
            obs.FLIGHT.remove_snapshot_provider("brownout")
            self.brownout = None
        if self.watcher is not None:
            from ..training import bundle as bdl
            bdl.remove_commit_hook(self._on_bundle_commit)
            self.watcher.stop()
            self.watcher = None
        if self.fleet is not None:
            obs.FLIGHT.remove_snapshot_provider("fleet")
            self.fleet.stop()
            self.fleet = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None

    async def shutdown(self, drain_timeout: float = DRAIN_TIMEOUT_S) -> bool:
        """Stop admitting (/readyz answers 503), finish queued and
        decoding work, then stop; the watcher and the metrics port close
        last."""
        self.admission.begin_drain()
        queued = self.scheduler.queued_units()
        if queued:
            log.info("Draining {} queued sentences (up to {}s)", queued,
                     drain_timeout)
        ok = await self.scheduler.drain(drain_timeout)
        if not ok:
            log.warn("Drain timed out after {}s — queued requests failed",
                     drain_timeout)
        # the handlers write the last replies in later loop steps
        await asyncio.sleep(0.2)
        self.close_nowait()
        return ok


def _make_ws_handler(app: ServingApp):
    """The per-connection WebSocket protocol: one text frame in, one
    reply frame out. A dropped connection cancels the handler task
    mid-await, which cancels the request, so its queued sentences are
    dropped and its decoding rows evicted. A ``#stream:1`` request's
    partial frames and then its final reply go through ONE per-connection
    queue drained in order, so a client never sees the reply before (or
    between) its partials; ``done(nbytes)`` always ends the request's
    root span, also when the send fails."""
    async def handler(ws):
        q: "asyncio.Queue[str]" = asyncio.Queue()

        async def _drain():
            while True:
                frame = await q.get()
                try:
                    await ws.send(frame)
                finally:
                    q.task_done()

        drainer = asyncio.ensure_future(_drain())
        try:
            async for message in ws:
                reply, done = await app.serve_frame(message, q.put_nowait)
                nbytes = 0
                try:
                    q.put_nowait(reply)
                    flushed = asyncio.ensure_future(q.join())
                    # a dead drainer (a failed send: the client is gone)
                    # leaves items unacknowledged: never await the join
                    # unguarded
                    await asyncio.wait({flushed, drainer},
                                       return_when=asyncio.FIRST_COMPLETED)
                    if not flushed.done():
                        flushed.cancel()
                        drainer.result()     # raises the send's error
                    # UTF-8 bytes, as the TCP transport counts them
                    nbytes = len(reply.encode("utf-8"))
                finally:
                    done(nbytes)
        finally:
            drainer.cancel()
    return handler


def _make_tcp_handler(app: ServingApp):
    """Length-prefixed TCP framing, ``MTPU <nbytes>\\n`` + payload, both
    directions. While a reply is pending the connection is watched for
    EOF: a client that disconnects cancels its request, so its queued
    sentences are dropped and its decoding rows evicted. The watch is
    re-armed after every pipelined chunk; read-ahead lands in a buffer
    that the framing reads drain first."""
    async def on_connection(reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter):
        buf = b""

        async def _readline() -> bytes:
            nonlocal buf
            if b"\n" in buf:
                line, _, rest = buf.partition(b"\n")
                buf = rest
                return line + b"\n"
            line, buf = buf, b""
            return line + await reader.readline()

        async def _readexactly(n: int) -> bytes:
            nonlocal buf
            take, buf = buf[:n], buf[n:]
            if len(take) < n:
                take += await reader.readexactly(n - len(take))
            return take

        try:
            while True:
                header = await _readline()
                if not header:
                    break
                parts = header.split()
                # a non-negative integer length, or the bad-frame reply
                nbytes = (int(parts[1])
                          if len(parts) == 2 and parts[0] == b"MTPU"
                          and parts[1].isdigit() else -1)
                if nbytes < 0:
                    writer.write(b"MTPU 24\n!!SERVER-ERROR bad frame")
                    await writer.drain()
                    break
                payload = await _readexactly(nbytes)

                def send_partial(frame: str) -> None:
                    # one MTPU frame a partial, written before the reply
                    # frame; the writer buffers, the reply drains it
                    b = frame.encode("utf-8")
                    writer.write(b"MTPU %d\n" % len(b) + b)

                reply_t = asyncio.ensure_future(
                    app.serve_frame(payload.decode("utf-8"), send_partial))
                eof = False
                while not reply_t.done():
                    if len(buf) >= MAX_READAHEAD:
                        # bounded read-ahead: let TCP backpressure throttle
                        # a flooding pipeliner
                        await asyncio.wait({reply_t})
                        break
                    watch = asyncio.ensure_future(reader.read(65536))
                    await asyncio.wait({reply_t, watch},
                                       return_when=asyncio.FIRST_COMPLETED)
                    if watch.done():
                        data = watch.result()
                        if not data:    # EOF: client gone mid-request
                            eof = True
                            break
                        buf += data     # pipelined bytes: keep, re-watch
                    else:
                        # cancelling an un-fired read() consumes nothing
                        watch.cancel()
                        try:
                            await watch
                        except asyncio.CancelledError:
                            pass
                if eof and not reply_t.done():
                    reply_t.cancel()
                    try:
                        await reply_t
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass
                    break
                reply, done = await reply_t
                out = reply.encode("utf-8")
                try:
                    writer.write(b"MTPU %d\n" % len(out) + out)
                    await writer.drain()
                finally:
                    # the root span ends even when the write fails
                    done(len(out))
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass                     # client went away / malformed frame
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
    return on_connection


async def _serve(options, ready: Optional[asyncio.Future] = None) -> None:
    """Serve until cancelled, then drain. The transport is the
    reference's choice: WebSocket when the ``websockets`` package is
    there (``HAVE_WS``), else the MTPU-framed TCP, with a warning.
    ``ready`` is resolved with the bound port once listening (``--port
    0`` binds an ephemeral one)."""
    app = ServingApp(options)
    app.start()
    port = int(options.get("port", 8080))

    def _announce(bound: int, transport: str) -> None:
        log.info("Server is listening on port {} ({})", bound, transport)
        if ready is not None and not ready.cancelled():
            ready.set_result(bound)

    async def _serve_until_cancelled() -> None:
        # runs inside the transport's serve context, so the drain ends
        # while client connections are still open: in-flight clients get
        # their replies before the listener goes down
        try:
            await asyncio.Future()
        except asyncio.CancelledError:
            await asyncio.shield(app.shutdown())
            raise

    try:
        if HAVE_WS:
            async with websockets.serve(_make_ws_handler(app), "0.0.0.0",
                                        port) as server:
                _announce(next(iter(server.sockets)).getsockname()[1],
                          "websocket")
                await _serve_until_cancelled()
        else:
            log.warn("the 'websockets' package is unavailable — serving "
                     "the length-prefixed TCP framing instead (Marian ws "
                     "clients cannot connect)")
            server = await asyncio.start_server(_make_tcp_handler(app),
                                                "0.0.0.0", port)
            async with server:
                _announce(server.sockets[0].getsockname()[1],
                          "tcp, MTPU framing")
                await _serve_until_cancelled()
    finally:
        app.close_nowait()


def serve_main(options) -> None:
    async def _main():
        import signal
        loop = asyncio.get_event_loop()
        task = asyncio.ensure_future(_serve(options))
        # SIGTERM and SIGINT both go through _serve's drain
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, task.cancel)
            except (NotImplementedError, RuntimeError):  # pragma: no cover
                pass
        try:
            await task
        except asyncio.CancelledError:
            pass

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
