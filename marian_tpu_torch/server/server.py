"""marian-server of the port, ported from ``marian_tpu/server/server.py``:
request-mode serving (the reference's default) and iteration-mode
serving over a paged KV pool, greedy at ``--beam-size 1`` and beam
search above it (the fused on-device merge by default, or the host
merge), with the cross-request prefix cache (``--prefix-cache``) and
the decode surface (``--shortlist``, ``--output-sampling``,
``--force-decode``, ``--n-best``; in request mode ``--word-scores`` too).

Protocol as the reference's dependency-free transport: length-prefixed
TCP frames ``MTPU <nbytes>\\n`` + UTF-8 payload in both directions; a
request frame holds newline-joined source sentences, the reply the
newline-joined translations. The WebSocket transport is not ported yet.

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
and ensembles; by an ``!!SERVER-ERROR`` reply, the ``#trace:`` request
header (not ported yet).
"""

from __future__ import annotations

import asyncio
import contextlib
import io
from typing import Callable, List, Optional, Tuple, Union

import torch

from ..common import logging as log
from ..data.batching import bucket_length
from ..serving.admission import AdmissionController, Overloaded
from ..serving.scheduler import (ContinuousScheduler, DispatchStalled,
                                 RequestTimeout, RowEvicted)

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


def split_headers(text: str) -> Tuple[Optional[str], Optional[int],
                                      Optional[bool], str]:
    """(trace id, priority, stream, body) of one request frame. A
    ``#model:`` tag is stripped and ignored, as the reference's
    single-model server does."""
    trace_id, body = _split_header(text, TRACE_PREFIX,
                                   _token("-_", _MAX_TRACE_ID))
    _, body = _split_header(body, MODEL_PREFIX, _token("-_.", _MAX_MODEL_TAG))
    priority, body = _split_header(body, PRIORITY_PREFIX, _priority)
    stream, body = _split_header(
        body, STREAM_PREFIX,
        lambda raw: raw == "1" if raw in ("0", "1") else None)
    return trace_id, priority, stream, body


class TranslationService:
    """The loaded model, vocabularies and parameters, through the port's
    ``Translate`` (reference: TranslationService in marian_server.cpp)."""

    def __init__(self, options,
                 device: Optional[Union[str, torch.device]] = None):
        from ..translator.translator import Translate
        self.translator = Translate(options, device)

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
    mode) and admission control. ``translate_lines`` (request mode) and
    ``engine`` (iteration mode) inject what would otherwise be built from
    the options; ``device`` overrides the device the options resolve."""

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
                     Callable[[List[str]], List[str]]] = None):
        self.options = options
        self._validate_options(options)
        self.batching_mode = str(options.get("batching-mode", "request"))
        self.service: Optional[TranslationService] = None
        stall = float(options.get("dispatch-stall-timeout", 0) or 0)
        budget = resolve_token_budget(options)
        max_queue = int(options.get("max-queue", 512) or 0)
        if self.batching_mode == "request":
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
                batching_mode="request", stall_timeout=stall)
            # request mode bounds queued sentences only: no pool
            self.admission = AdmissionController(
                max_queue, self.scheduler.queued_units)
        else:
            if engine is None:
                self.service = TranslationService(options, device)
                engine = self._build_engine()
            # admission prices queue debt in pages: by default 4x the pool
            self.max_queue_pages = \
                int(options.get("max-queue-pages", 0) or 0) \
                or 4 * engine.pool.usable_pages
            self.scheduler = ContinuousScheduler(
                batching_mode="iteration", engine=engine,
                engine_factory=self._build_engine if self.service else None,
                stall_timeout=stall)
            self.admission = AdmissionController(
                max_queue, self.scheduler.queued_units,
                max_queue_pages=self.max_queue_pages,
                pages_fn=self.scheduler.queued_pages)
        self.request_timeout = float(options.get("request-timeout", 0) or 0)

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
        """A fresh paged engine over the loaded model: greedy at
        --beam-size 1, the copy-on-write beam engine above it (and at
        beam 1 under --n-best); the decode-feature plane of the decode
        flags; with --prefix-cache its own cache, stamped with the model
        path (a rebuilt engine starts with an empty one)."""
        from ..translator.decode_features import FeaturePlane
        from ..translator.iteration import PagedDecodeEngine
        tr = self.service.translator
        opts = self.options
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

    def start(self) -> None:
        """Start the scheduler on the RUNNING loop."""
        self.scheduler.start()
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
        ignored."""
        trace_id, priority, stream, body = split_headers(text)
        if trace_id is not None:
            return ("!!SERVER-ERROR the #trace: header (request tracing) is "
                    "not ported to marian_tpu_torch yet")
        on_partial = None
        if stream and send_partial is not None:
            def on_partial(idx: int, partial: str, _ntok: int) -> None:
                send_partial(f"{PARTIAL_PREFIX}{idx} {partial}")
        lines = body.split("\n")
        engine = self.scheduler.engine
        try:
            self.admission.admit(
                len(lines), n_pages=sum(engine.pages_for_text(l)
                                        for l in lines) if engine else 0)
        except Overloaded as e:
            return f"!!SERVER-OVERLOADED {e}"
        fut = self.scheduler.submit(lines, priority=priority or 0,
                                    timeout=self.request_timeout or None,
                                    on_partial=on_partial)
        try:
            out = await fut
        except RequestTimeout as e:
            return f"!!SERVER-TIMEOUT {e}"
        except (RowEvicted, DispatchStalled) as e:
            return f"!!SERVER-RETRY {e}"
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — logged by the scheduler
            return ""
        return "\n".join(out)

    async def shutdown(self, drain_timeout: float = DRAIN_TIMEOUT_S) -> bool:
        """Stop admitting, finish queued and decoding work, then stop."""
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
        return ok


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
                    app.handle_frame(payload.decode("utf-8"), send_partial))
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
                out = (await reply_t).encode("utf-8")
                writer.write(b"MTPU %d\n" % len(out) + out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass                     # client went away / malformed frame
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
    return on_connection


async def _serve(options, ready: Optional[asyncio.Future] = None) -> None:
    """Serve until cancelled, then drain. ``ready`` is resolved with the
    bound port once listening (``--port 0`` binds an ephemeral one)."""
    app = ServingApp(options)
    app.start()
    server = await asyncio.start_server(_make_tcp_handler(app), "0.0.0.0",
                                        int(options.get("port", 8080)))
    async with server:
        bound = server.sockets[0].getsockname()[1]
        log.info("Server is listening on port {} (tcp, MTPU framing)", bound)
        if ready is not None and not ready.cancelled():
            ready.set_result(bound)
        try:
            await asyncio.Future()
        except asyncio.CancelledError:
            # drain while client connections are still open, so in-flight
            # clients get their replies before the listener goes down
            await asyncio.shield(app.shutdown())
            raise


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
