"""Iteration-level (continuous) greedy decoding over a paged KV pool, the
port of ``marian_tpu/translator/iteration.py`` (``PagedDecodeEngine``
with the cross-request prefix cache, translator/prefix_cache.py, and the
decode-feature plane, translator/decode_features.py, the pool and round
series, the ``/poolz`` page map and the ``pool.audit_failed`` flight
trip; without the compile witness).

Decode rows are SLOTS over one shared paged KV pool
(ops/kernels/kv_pool.py):

- a sentence JOINS a running decode at any round boundary, claiming a
  slot and the pages of its own decode cap, and starts at its own
  position 0 beside rows deep into theirs;
- a finished sentence LEAVES at the step it emits EOS (or reaches its
  cap), releasing its pages at once;
- each round runs ``steps_per_round`` decode steps over the occupied
  slot prefix, rounded UP to a row bucket (``ROW_BUCKETS``), with one
  copy of the tokens to the host per round. Joins encode at
  ``JOIN_BUCKETS`` rows and halving source widths. Eager PyTorch needs
  no closed shape set; the buckets keep the reference's computed rows
  and widths, and they are the shapes a CUDA graph would capture;
- with a ``PrefixCache`` an exact source repeat of a finished sentence
  replays its text at join (no slot), and a repeat of a sentence
  decoding now forks from it copy-on-write (``_try_fork``); a finished
  row's pages move to the cache, which gives them back under pressure;
- with a ``FeaturePlane`` (``features``) each row carries its own
  decode surface: a shortlist (the step's logits in the row's [K]
  coordinates, masked past its true width before the softmax, the pick
  mapped back to vocabulary ids on the device, since the next step
  embeds it), a noise lane (``--output-sampling``; the prefix cache is
  off then) and a forced trunk (``source<TAB>prefix`` lines: the trunk
  salts the cache key, and the row's cap covers it). A join may carry a
  third element, a dict with ``sid`` (n-best numbering) and ``stream``:
  a streaming row reports its text so far every round
  (``StepResult.partials``).

Threading: ``admit_and_step`` runs on the serving scheduler's single
device worker thread, and the event loop touches the engine only
between rounds, so engine state has one thread at a time (the pool's
own lock covers its readers). The reference's engine has a lock of its
own (``PagedDecodeEngine._lock``) for the readers of its slots; the
port's readers read the slot list without one, and the module's
``_SYNC_LOCK`` is the only lock here. The grad mode and the current CUDA device
are per thread, so ``admit_and_step`` enters ``torch.inference_mode``
and the engine's device itself.

Determinism: joins take the LOWEST free slot in caller order, page
claims pop a deterministic free list and idle slots write zeros into the
trash page, so a replayed join/evict schedule gives identical outputs.
With ``MARIAN_POOL_AUDIT=1`` every round ends with a full pool audit
that raises :class:`PoolCorruption` on a violation. Every round starts
by crossing the corruption drills (``pool.double_free``,
``pool.refcount_corrupt``, ``pool.table_corrupt``): no-ops unless armed,
armed they corrupt the pool's host state or the page table the round
uploads to the card, so the audit is held against real corruption.

Metrics (``_declare_metrics``, called by the serving scheduler with its
registry): the pool's gauges are sampled at scrape time from the pool
and the slots; the round, page-traffic and fork counters move once a
round, at the end of ``admit_and_step``, from the round's pool-counter
deltas and the engine's ``counters``. Every series reads host-side
state: none adds a copy from the card to the host.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..common import faultpoints as fp
from ..common import lockdep
from ..common import logging as log
from ..data.vocab import EOS_ID
from ..models.transformer import fork_paged_rows
from ..ops.kernels.kv_pool import (DEFAULT_PAGE_LEN, KVPool, PoolCorruption,
                                   PoolExhausted, ROW_BUCKETS, bucket_rows,
                                   pages_for_tokens, pool_fork_partial,
                                   state_key_groups)
from .beam_search import NEG_INF, gumbel_noise, sample_pick, sampling_params
from .decode_features import RowFeatures
from .prefix_cache import PrefixCache

# with MARIAN_POOL_AUDIT=1 every admit+step round ends with a full
# invariant audit; without it the audit runs when a caller asks and the
# row-exit leak check stays on
ENV_POOL_AUDIT = "MARIAN_POOL_AUDIT"

# join rejections that can never succeed: the scheduler fails the
# request instead of re-queueing it (an unadmittable head-of-line
# sentence must not park the queue)
FATAL_REASONS = ("src_too_long", "too_large")

# torch.cuda.set_sync_debug_mode is process-wide, not per thread: the
# guard that set the mode last owns it (its token holds the mode to
# restore), so a serving watchdog that abandons a round inside its guard
# can take the mode back for the next worker's rounds, and the abandoned
# guard's late exit then restores nothing. For the same reason a thread
# that syncs the host while another thread's guard body runs (a model
# loading or warming on the lifecycle's watcher thread) would raise
# there: ``sync_exclusive`` bodies and other threads' guard bodies never
# overlap.
_SYNC_LOCK = lockdep.make_lock(
    "marian_tpu_torch.translator.iteration._SYNC_LOCK")
_SYNC_CHANGED = threading.Condition(_SYNC_LOCK)
_sync_owner: Optional[List[int]] = None     # guarded by _SYNC_LOCK
# thread id -> nesting depth of the sync_exclusive bodies it is in
_exclusive: Dict[int, int] = {}             # guarded by _SYNC_LOCK


@contextlib.contextmanager
def sync_guard(mode: Optional[str], device: torch.device):
    """Run the body under ``torch.cuda.set_sync_debug_mode(mode)`` and
    restore the previous mode after it (a no-op when ``mode`` is None or
    off the card). It waits while another thread is in a
    ``sync_exclusive`` body."""
    global _sync_owner
    if mode is None or device.type != "cuda":
        yield
        return
    me = threading.get_ident()
    with _SYNC_CHANGED:
        _SYNC_CHANGED.wait_for(lambda: all(t == me for t in _exclusive))
        token = [torch.cuda.get_sync_debug_mode()]
        torch.cuda.set_sync_debug_mode(mode)
        _sync_owner = token
    try:
        yield
    finally:
        with _SYNC_CHANGED:
            if _sync_owner is token:
                torch.cuda.set_sync_debug_mode(token[0])
                _sync_owner = None
            _SYNC_CHANGED.notify_all()


@contextlib.contextmanager
def sync_exclusive():
    """Run the body with no other thread's ``sync_guard`` body running:
    it waits for a live guard body to end (or be released), and other
    threads' guard bodies wait for it. For host work that may sync the
    card off the serving thread (loading and warming a model)."""
    me = threading.get_ident()
    with _SYNC_CHANGED:
        _SYNC_CHANGED.wait_for(
            lambda: me in _exclusive or _sync_owner is None)
        _exclusive[me] = _exclusive.get(me, 0) + 1
    try:
        yield
    finally:
        with _SYNC_CHANGED:
            _exclusive[me] -= 1
            if not _exclusive[me]:
                del _exclusive[me]
            _SYNC_CHANGED.notify_all()


def release_sync_guard() -> bool:
    """Restore the mode a live ``sync_guard`` replaced, as if its body
    had ended (the serving watchdog abandons such a body); True when a
    guard was live."""
    global _sync_owner
    with _SYNC_CHANGED:
        if _sync_owner is None:
            return False
        torch.cuda.set_sync_debug_mode(_sync_owner[0])
        _sync_owner = None
        _SYNC_CHANGED.notify_all()
        return True


@dataclass
class StepResult:
    """One admit+step round."""
    accepted: List[object] = field(default_factory=list)
    # (key, reason); reasons in FATAL_REASONS are permanent
    rejected: List[Tuple[object, str]] = field(default_factory=list)
    # key -> what a FATAL rejection needed against what the engine has
    reject_detail: Dict[object, str] = field(default_factory=dict)
    finished: List[Tuple[object, str]] = field(default_factory=list)
    # key -> score, norm_score, length and tokens of a finished beam row
    finished_info: Dict[object, dict] = field(default_factory=dict)
    # keys evicted because a lazy page claim found the pool dry (beam
    # divergence): retriable, the scheduler replies !!SERVER-RETRY
    pool_evicted: List[object] = field(default_factory=list)
    # (key, text so far, tokens so far) of every streaming row still
    # decoding after the round; a finishing row's text is in ``finished``
    partials: List[Tuple[object, str, int]] = field(default_factory=list)
    rows: int = 0                 # active rows this round (before finishes)
    bucket: int = 0               # the row bucket the round ran at
    tokens: int = 0               # target tokens the round consumed
    steps: int = 0                # decode steps the round ran
    device_s: float = 0.0         # admit+step wall time (ends in a sync)
    mid_decode_joins: int = 0     # joins that landed beside running rows
    # per-row instants of the round: (key, name, attrs), the prefix
    # cache's replays and forks, which the scheduler turns into timeline
    # events tagged with the row's trace id and into the #trace reply's
    # row breakdown
    row_events: List[Tuple[object, str, dict]] = field(default_factory=list)
    # the pool's page traffic this round (deltas of KVPool.stats and the
    # engine's copied pages): the serve.round span's attributes and the
    # marian_serving_kv_pool_pages_*_total series
    pages_claimed: int = 0
    pages_freed: int = 0
    pages_aliased: int = 0
    pages_copied: int = 0


class _Slot:
    __slots__ = ("key", "tokens", "pos", "cap", "prev", "expected_refs",
                 "src_key", "feat")

    def __init__(self, key, cap: int, expected_refs: int, src_key=None,
                 feat: Optional[RowFeatures] = None):
        self.key = key
        self.tokens: List[int] = []
        self.pos = 0                # next write position
        self.cap = cap              # decode cap (max positions)
        self.prev = 0               # previous token id (0 at pos 0)
        # page references the row's exit must give back (cap pages for
        # a cold join; aliased full pages + owned tail for a fork)
        self.expected_refs = expected_refs
        self.src_key = src_key      # source id tuple (the prefix-cache key)
        self.feat = feat            # RowFeatures (decode_features.py)


class PagedDecodeEngine:
    """Slot-based continuous greedy decoder over a paged KV pool."""

    # encode-at-join batch buckets
    JOIN_BUCKETS = (1, 2, 4, 8)
    # slots one sentence holds: a beam engine's sentence holds beam-size
    # slots, an aligned block of them
    slots_per_sentence = 1
    # n-best needs the beam engine's hypotheses
    _SUPPORTS_NBEST = False

    def __init__(self, model, params, src_vocab, trg_vocab,
                 max_rows: int = 32,
                 page_len: int = DEFAULT_PAGE_LEN,
                 pool_bytes: int = 0,
                 src_len_cap: int = 64,
                 max_length_cap: int = 256,
                 max_length_factor: float = 3.0,
                 row_buckets: Sequence[int] = ROW_BUCKETS,
                 steps_per_round: int = 1,
                 prefix_cache: Optional[PrefixCache] = None,
                 features=None):
        cfg = model.cfg
        self.model = model
        self.params = params
        self.device = next(iter(params.values())).device
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.max_rows = int(max_rows)
        self.page_len = int(page_len)
        self.src_cap = int(src_len_cap)
        self.max_length_cap = int(max_length_cap)
        self.max_length_factor = float(max_length_factor)
        self.row_buckets = tuple(sorted({min(b, self.max_rows)
                                         for b in row_buckets}))
        if self.max_rows > max(row_buckets):
            raise ValueError(
                f"max_rows {self.max_rows} exceeds the largest row "
                f"bucket {max(row_buckets)} (extend row_buckets or "
                f"lower --iteration-rows)")
        self.max_pages = pages_for_tokens(self.max_length_cap,
                                          self.page_len)
        # decode steps per round: joins are admitted every round, so the
        # admission granularity is steps_per_round steps; a row that
        # finishes mid-round self-feeds until the host cuts at its EOS
        self.steps_per_round = max(1, int(steps_per_round))
        h, dh, depth = cfg.heads, cfg.dim_head, cfg.dec_depth
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        # bytes one PAGE costs across the whole decoder: K+V, all layers
        self.page_bytes = 2 * depth * h * self.page_len * dh * itemsize
        if pool_bytes and pool_bytes > 0:
            n_pages = 1 + max(1, int(pool_bytes) // self.page_bytes)
        else:
            n_pages = 1 + self._default_pool_pages()
        self.pool = KVPool(n_pages, self.page_len,
                           max_pages_per_row=self.max_pages)
        # device state: the model's paged state (pools + per-slot cross
        # K/V) and the per-slot source mask; idle rows keep one live
        # source position
        with self._on_device():
            enc0 = torch.zeros((self.max_rows, self.src_cap, cfg.dim_emb),
                               dtype=cfg.compute_dtype, device=self.device)
            self._src_mask = torch.zeros((self.max_rows, self.src_cap),
                                         device=self.device)
            self._src_mask[:, 0] = 1.0
            self._state = model.start_paged_state(
                params, enc0, self._src_mask, n_pages, self.page_len,
                self.max_pages)
        self._keys = state_key_groups(self._state)
        # host page-table mirror, uploaded with every round
        self._table = np.zeros((self.max_rows, self.max_pages), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * self.max_rows
        self._by_key: Dict[object, int] = {}
        self._n_active = 0
        # brownout level 1 (serving/brownout.py): NEW joins claim a
        # scaled-down decode cap. Written by the brownout thread, read at
        # join time on the worker thread: one float, coupled to nothing
        self._cap_scale = 1.0
        self._audit_always = os.environ.get(ENV_POOL_AUDIT, "") == "1"
        # the decode-feature plane (None: the plain step)
        self.features = features
        if features is not None and features.n_best \
                and not self._SUPPORTS_NBEST:
            raise ValueError("n-best needs beam bookkeeping — the server "
                             "routes it to PagedBeamEngine (any beam "
                             "size)")
        # noise lanes: each admitted row takes the next ordinal, so a
        # replayed join schedule replays its draws
        self._lane_ctr = 0
        if features is not None and not features.cacheable \
                and prefix_cache is not None:
            log.info("iteration engine: --output-sampling disables the "
                     "prefix cache (sampled decodes must not be replayed "
                     "or forked)")
            prefix_cache = None
        # cross-request prefix sharing (--prefix-cache): one cache per
        # engine, so a rebuilt engine starts with an empty one
        self.prefix = prefix_cache
        # the step loop runs under torch.cuda.set_sync_debug_mode(this)
        # when set ("warn" or "error"): a host sync inside the loop shows
        self.sync_debug: Optional[str] = None
        # totals over the engine's life: rounds, decode steps, active
        # rows summed over rounds, joins, mid-decode joins, encoder
        # calls, prefix-cache hits (forks + replays) and replays, live
        # forks, audits and failed audits, and the rounds' wall seconds
        self.counters: Dict[str, float] = {
            "rounds": 0, "steps": 0, "rows": 0, "joins": 0,
            "mid_decode_joins": 0, "encodes": 0, "prefix_hits": 0,
            "replays": 0, "forks": 0, "copied_pages": 0, "audits": 0,
            "audit_failures": 0, "round_s": 0.0}
        # the verdict of the last audit, for /poolz
        self._last_audit: Optional[dict] = None
        self._metrics_declared = False

    def _default_pool_pages(self) -> int:
        """The unsized pool (no --kv-pool-bytes): every slot can hold a
        full-cap row, so the pool is never the constraint (shrink
        --kv-pool-bytes to make it one). The fused beam engine adds its
        rounds' preclaim headroom."""
        return self.max_rows * self.max_pages

    def _sync_guard(self):
        """The step loop's ``sync_debug`` mode (a no-op when unset or on
        the CPU)."""
        return sync_guard(self.sync_debug, self.device)

    @contextlib.contextmanager
    def _on_device(self):
        """inference mode plus the engine's CUDA device as the current
        one: both are per thread, and rounds run on a worker thread."""
        with torch.inference_mode(), (
                torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext()):
            yield

    # -- capacity -----------------------------------------------------------
    def active_rows(self) -> int:
        return self._n_active

    def free_pages(self) -> int:
        """Free pages plus what evicting the prefix cache would free now:
        page-priced admission sees relievable pressure, and the claims
        relieve it before they fail (``_claim_pages``)."""
        free = self.pool.free_pages()
        if self.prefix is not None:
            free += self.prefix.reclaimable_pages(self.pool)
        return free

    def occupancy(self) -> float:
        """Claimed / allocatable pages (any thread)."""
        return self.pool.used_pages() / float(self.pool.usable_pages)

    def cow_alias_ratio(self) -> float:
        """(references - live pages) / references: the share of page
        references that alias a page another owner holds too."""
        st = self.pool.alias_stats()
        return (st["refs"] - st["live"]) / st["refs"] if st["refs"] \
            else 0.0

    def used_tokens(self) -> int:
        """Positions written by the active rows (any thread: a copy of
        the slot list, then host-side reads)."""
        return sum(s.pos for s in list(self._slots) if s is not None)

    def fragmentation(self) -> float:
        """1 - written tokens / (claimed pages x page_len); the prefix
        cache's held tokens count as written (retention is not waste)."""
        used_pages = self.pool.used_pages()
        if used_pages == 0:
            return 0.0
        used = self.used_tokens()
        if self.prefix is not None:
            used += self.prefix.held_tokens()
        return max(0.0, 1.0 - used / float(used_pages * self.page_len))

    def free_slots(self) -> int:
        """Sentences that can join now."""
        return (self.max_rows - self._n_active) // self.slots_per_sentence

    def _free_block(self) -> Optional[int]:
        """The first slot of the lowest free aligned block of
        ``slots_per_sentence`` slots (None: no block is free). The lowest
        keeps the occupied prefix, and with it the row bucket, tight."""
        g = self.slots_per_sentence
        return next((b for b in range(0, self.max_rows - g + 1, g)
                     if not any(self._slots[b:b + g])), None)

    def idle(self) -> bool:
        return self._n_active == 0

    def decode_cap(self, n_src_tokens: int) -> int:
        """Decode cap for a sentence: the beam search's max-length-factor
        rule, so both modes price work the same. Brownout level >= 1
        scales it down for NEW joins: shorter rows claim fewer pages and
        leave sooner."""
        base = min(self.max_length_cap,
                   max(8, round(self.max_length_factor
                                * max(1, n_src_tokens))))
        return int(max(8, round(base * self._cap_scale)))

    def set_cap_scale(self, scale: float) -> None:
        """Brownout level 1: scale the decode cap of FUTURE joins (rows
        already decoding keep the cap they claimed pages for), clamped
        to [0.05, 1]."""
        self._cap_scale = min(1.0, max(0.05, float(scale)))

    def row_progress(self, key) -> Optional[Tuple[int, int]]:
        """(pos, cap) of an active row, or None: the brownout eviction's
        longest-remaining tie-break. Host state only (any thread)."""
        slot = self._by_key.get(key)
        s = self._slots[slot] if slot is not None else None
        return (s.pos, s.cap) if s is not None else None

    def pages_for_text(self, text: str) -> int:
        """Pages one sentence will claim (admission prices queue debt in
        pages). A whitespace estimate; the join re-measures with the
        vocab's encoding."""
        n_src = len(text.split()) + 1
        return pages_for_tokens(self.decode_cap(n_src), self.page_len)

    # -- the admit + step round (one thread at a time) ----------------------
    def admit_and_step(self, joins: Sequence[tuple],
                       evicts: Sequence[object] = ()) -> StepResult:
        """Apply evictions (dead requests), admit what fits, run one
        round over the occupied slots. Never blocks on pool space: a join
        that does not fit comes back rejected (``no_slot``/``no_pages``:
        retry later; FATAL_REASONS: fail the request). A join is ``(key,
        text)`` or ``(key, text, meta)``, meta a dict with ``sid`` and
        ``stream``."""
        t0 = time.perf_counter()
        res = StepResult()
        stats0 = self.pool.stats()
        forks0 = self.counters["forks"]
        copied0 = self.counters["copied_pages"]
        # the corruption drills (no-ops unless armed): real corrupt
        # state for the audit below to catch
        self.pool.chaos_double_free()
        self.pool.chaos_refcount_corrupt()
        self._chaos_table_corrupt()
        with self._on_device():
            for key in evicts:
                self._evict(key)
            rows_before = self._n_active
            joiners: List[Tuple[object, List[int], int]] = []
            for j in joins:
                key, text = j[0], j[1]
                meta = j[2] if len(j) > 2 else None
                why = self._try_claim(key, text, joiners, res, meta)
                if why is None:
                    res.accepted.append(key)
                else:
                    res.rejected.append((key, why))
            if joiners:
                self._install(joiners)
                if rows_before > 0:
                    res.mid_decode_joins = len(joiners)
            if self._n_active > 0:
                self._step(res)
        if self._audit_always:
            bad = self.audit(context="round")
            if bad:
                # corrupted page state must never serve another token:
                # the scheduler fails the round's rows retriably and
                # rebuilds the engine
                raise PoolCorruption("pool audit failed: "
                                     + "; ".join(bad[:4]))
        res.device_s = time.perf_counter() - t0
        c = self.counters
        c["rounds"] += 1
        c["steps"] += res.steps
        c["rows"] += res.rows
        c["joins"] += len(res.accepted)
        c["mid_decode_joins"] += res.mid_decode_joins
        c["round_s"] += res.device_s
        stats1 = self.pool.stats()
        res.pages_claimed = stats1["claimed"] - stats0["claimed"]
        res.pages_freed = stats1["freed"] - stats0["freed"]
        res.pages_aliased = stats1["aliased"] - stats0["aliased"]
        res.pages_copied = int(c["copied_pages"] - copied0)
        if self._metrics_declared:
            self._round_metrics(res, int(c["forks"] - forks0))
        return res

    def _replay(self, key, src_key, res: StepResult) -> bool:
        """A join whose source has a finished prefix-cache entry resolves
        now with the entry's text, taking no slot: decoding is
        deterministic, so it is what a cold decode would give."""
        if self.prefix is None:
            return False
        ent = self.prefix.get(src_key, self.prefix.version)
        if ent is None:
            return False
        res.finished.append((key, ent.text))
        res.row_events.append((key, "prefix.hit",
                               {"kind": "replay",
                                "tokens": len(ent.tokens)}))
        self.counters["prefix_hits"] += 1
        self.counters["replays"] += 1
        return True

    def _join_features(self, key, text: str, res: StepResult,
                       meta: Optional[dict]):
        """The feature half of a join: (source ids, the prefix-cache key,
        the decode cap, the row's RowFeatures or None), or a rejection
        reason (a str) with its detail in ``res``. The plane splits off
        a forced trunk (``source<TAB>prefix``), which salts the cache
        key and must fit under the cap with 8 positions to go on."""
        detail = res.reject_detail
        plane = self.features
        forced: List[int] = []
        if plane is not None and plane.force_decode:
            text, forced = plane.split_forced(text, self.trg_vocab)
        ids = self.src_vocab.encode(text, add_eos=True)
        if len(ids) > self.src_cap:
            detail[key] = (f"source encodes to {len(ids)} tokens but the "
                           f"engine's source cap is {self.src_cap} (raise "
                           f"--max-length)")
            return "src_too_long"
        src_key = tuple(int(i) for i in ids)
        if plane is not None:
            src_key = plane.cache_key(src_key, forced)
        cap = self.decode_cap(len(ids))
        if forced:
            # the dense twin's rule: the cap covers the trunk plus 8
            if len(forced) + 8 > self.max_length_cap:
                detail[key] = (f"forced target prefix is {len(forced)} "
                               f"tokens but the engine's decode cap is "
                               f"{self.max_length_cap} (raise --max-length)")
                return "too_large"
            cap = min(self.max_length_cap, max(cap, len(forced) + 8))
        stream = bool(meta.get("stream")) if meta else False
        sid = int(meta.get("sid", 0)) if meta else 0
        feat = None
        if plane is not None:
            feat = plane.row_features(ids, forced=forced,
                                      lane=self._lane_ctr, stream=stream,
                                      sid=sid)
        elif stream or sid:
            feat = RowFeatures(stream=stream, sid=sid)
        return ids, src_key, cap, feat

    def _row_admitted(self, lanes: int = 1,
                      feat: Optional[RowFeatures] = None) -> None:
        """A row (a beam sentence: ``lanes`` rows) joined: the lane
        allocator moves on, so a replayed join schedule replays them; a
        shortlisted row is counted with its width."""
        if self.features is not None:
            self._lane_ctr += lanes
        if feat is not None and feat.shortlist is not None \
                and hasattr(self, "m_shortlist_rows"):
            self.m_shortlist_rows.inc()
            self.m_shortlist_width.observe(feat.sl_len)

    def _try_claim(self, key, text: str, joiners: List,
                   res: StepResult, meta: Optional[dict] = None
                   ) -> Optional[str]:
        detail = res.reject_detail
        got = self._join_features(key, text, res, meta)
        if isinstance(got, str):
            return got
        ids, src_key, cap, feat = got
        if self._replay(key, src_key, res):
            return None
        n_pages = pages_for_tokens(cap, self.page_len)
        if n_pages > self.pool.max_pages_per_row:
            detail[key] = (f"decode cap {cap} tokens needs {n_pages} KV "
                           f"pages of {self.page_len} tokens but the page "
                           f"table holds {self.pool.max_pages_per_row}/row "
                           f"(raise --kv-page-len or --kv-pool-bytes)")
            return "too_large"
        slot = self._free_block()
        if slot is None:
            return "no_slot"
        if self.prefix is not None:
            forked = self._try_fork(key, src_key, cap, n_pages, slot, feat,
                                    res)
            if forked is not None:
                if forked:
                    self._row_admitted(feat=feat)
                    return None
                return "no_pages"
            self.prefix.note_miss()
        try:
            pages = self._claim_pages(key, n_pages)
        except PoolExhausted:
            # retriable only if the pool could EVER satisfy it
            if n_pages > self.pool.usable_pages:
                detail[key] = (
                    f"decode cap {cap} tokens needs {n_pages} KV pages but "
                    f"the whole pool holds only {self.pool.usable_pages} "
                    f"allocatable pages of {self.page_len} tokens (raise "
                    f"--kv-pool-bytes or lower --max-length)")
                return "too_large"
            return "no_pages"
        self._slots[slot] = _Slot(key, cap, expected_refs=n_pages,
                                  src_key=src_key, feat=feat)
        self._by_key[key] = slot
        self._n_active += 1
        if self.prefix is not None:
            self.prefix.register_live(src_key, key)
        self._table[slot, :] = 0
        self._table[slot, :len(pages)] = pages
        joiners.append((key, ids, slot))
        self._row_admitted(feat=feat)
        return None

    def _claim_pages(self, owner, n: int) -> List[int]:
        """A fresh claim with prefix-cache pressure relief: when the free
        list is short, LRU cache entries are evicted and the claim tried
        once more."""
        try:
            return self.pool.claim(owner, n)
        except PoolExhausted:
            if self.prefix is None \
                    or not self.prefix.evict_for_pages(self.pool, n):
                raise
            return self.pool.claim(owner, n)

    def _try_fork(self, key, src_key, cap: int, n_pages: int,
                  slot: int, feat: Optional[RowFeatures] = None,
                  res: Optional[StepResult] = None) -> Optional[bool]:
        """Copy-on-write fork into ``slot`` from a LIVE row with the same
        source: alias its full (append-only) pages, copy its partial page
        and its cross-attention rows (no encoder pass), resume at its
        position with its tokens. True: joined; False: a fork would do
        but the pool is dry (retry later); None: no row to fork from (a
        cold join). The leader must have stepped (its encoder rows are
        installed) and have the same cap."""
        leader_key = self.prefix.leader(src_key)
        if leader_key is None or leader_key == key:
            return None
        slot_l = self._by_key.get(leader_key)
        s_l = self._slots[slot_l] if slot_l is not None else None
        if s_l is None or s_l.pos <= 0 or s_l.cap != cap:
            return None
        pos_l = s_l.pos
        n_full = pos_l // self.page_len
        has_partial = pos_l % self.page_len != 0
        leader_pages = self.pool.pages_of(leader_key)
        fulls = leader_pages[:n_full]
        own_needed = n_pages - n_full

        def build():
            self.pool.share(key, fulls)
            try:
                return self.pool.claim_extra(key, own_needed)
            except PoolExhausted:
                self.pool.release(key)
                raise
        try:
            own = build()
        except PoolExhausted:
            if not self.prefix.evict_for_pages(self.pool, own_needed):
                return False
            try:
                own = build()
            except PoolExhausted:
                return False
        s = _Slot(key, cap, expected_refs=n_full + own_needed,
                  src_key=src_key, feat=feat)
        s.tokens = list(s_l.tokens)
        s.pos = pos_l
        s.prev = s_l.prev
        self._slots[slot] = s
        self._by_key[key] = slot
        self._n_active += 1
        self.prefix.register_live(src_key, key)
        row = fulls + own
        self._table[slot, :] = 0
        self._table[slot, :len(row)] = row
        # the device half: cross-attention rows and source mask, then the
        # partial page's content ((0, 0): a leader on a page boundary)
        def dev(xs):
            return torch.tensor(xs, dtype=torch.long, device=self.device)
        fork_paged_rows(self._state, self._src_mask, dev([slot_l]),
                        dev([slot]))
        src_page = dev([leader_pages[n_full] if has_partial else 0])
        dst_page = dev([own[0] if has_partial else 0])
        for kk in self._keys[1]:
            if kk.endswith("_pool_k"):
                pool_fork_partial(self._state[kk],
                                  self._state[kk[:-1] + "v"], src_page,
                                  dst_page)
        self.prefix.note_fork(tokens_saved=pos_l, pages_reused=n_full)
        self.counters["prefix_hits"] += 1
        self.counters["forks"] += 1
        self.counters["copied_pages"] += int(has_partial)
        if res is not None:
            res.row_events.append((key, "prefix.fork",
                                   {"kind": "live", "pos": pos_l,
                                    "aliased": n_full,
                                    "copied": int(has_partial)}))
        return True

    def _evict(self, key, adopt_text: Optional[str] = None) -> bool:
        """A row leaves (finished, or its request died): release its
        pages (or, finished with ``adopt_text`` and a prefix cache, hand
        them to the cache with its decode) and clear its table row."""
        slot = self._by_key.pop(key, None)
        if slot is None:
            return False
        s = self._slots[slot]
        self._slots[slot] = None
        self._n_active -= 1
        released = 0
        if self.prefix is not None and s.src_key is not None:
            self.prefix.unregister_live(s.src_key, key)
            if adopt_text is not None:
                released = self.prefix.adopt(self.pool, s.src_key, key,
                                             s.tokens, adopt_text)
        if released == 0:
            released = self.pool.release(key)
        # row-exit leak check (always on): the row must give back exactly
        # the references it claimed
        if released != s.expected_refs:
            self._report_audit(
                [f"row exit released {released} page reference(s) for "
                 f"key {key!r}, expected {s.expected_refs} (cap {s.cap})"],
                context="row-exit")
        self._table[slot, :] = 0
        return True

    # -- metrics ------------------------------------------------------------
    def _declare_metrics(self, r) -> None:
        """The reference engine's series on registry ``r`` (the serving
        scheduler calls this for every engine it serves, so the gauges
        follow a swap or a rebuild)."""
        r.gauge("marian_serving_kv_pool_pages",
                "Paged KV pool size in allocatable pages (page 0 "
                "reserved)").set(self.pool.usable_pages)
        r.gauge("marian_serving_kv_pool_pages_free",
                "Paged KV pool pages currently free"
                ).set_function(self.pool.free_pages)
        r.gauge("marian_serving_kv_pool_fragmentation_ratio",
                "Internal fragmentation of claimed pages: 1 - written "
                "tokens / (claimed pages x page_len)"
                ).set_function(self.fragmentation)
        r.gauge("marian_serving_active_rows",
                "Decode slots occupied by live sentences (iteration mode)"
                ).set_function(self.active_rows)
        self.m_audits = r.counter(
            "marian_serving_pool_audits_total",
            "Pool invariant audits run (quiesce boundaries; every round "
            "under MARIAN_POOL_AUDIT=1)")
        self.m_audit_failures = r.counter(
            "marian_serving_pool_audit_failures_total",
            "Pool invariant audits that found violations (double-free, "
            "table/claim mismatch, refcount drift, leaked pages, "
            "row-exit leak)")
        r.gauge("marian_serving_kv_pool_occupancy_ratio",
                "Claimed pages / allocatable pages of the paged KV pool"
                ).set_function(self.occupancy)
        r.gauge("marian_serving_kv_pool_pages_shared",
                "Pages currently COW-aliased (refcount >= 2): held by more "
                "than one hypothesis/row/cache entry"
                ).set_function(lambda: self.pool.alias_stats()["shared"])
        r.gauge("marian_serving_kv_pool_refcount_max",
                "Highest live page refcount (refcount-distribution "
                "summary; 1 = no sharing at all right now)"
                ).set_function(lambda: self.pool.alias_stats()["max"])
        r.gauge("marian_serving_kv_pool_cow_alias_ratio",
                "Fraction of live page-table references that are COW "
                "aliases rather than sole ownership: (refs - live pages) / "
                "refs. 0 = no sharing; rises with beam forks and prefix "
                "hits").set_function(self.cow_alias_ratio)
        self.m_rounds = r.counter(
            "marian_serving_engine_rounds_total",
            "Admit+step rounds the paged engine ran — each round is "
            "one device dispatch covering --iteration-steps decode "
            "steps (greedy AND fused-merge beam scan; only the "
            "host-merge beam baseline pins rounds to one step)")
        self.m_pages_claimed = r.counter(
            "marian_serving_kv_pool_pages_claimed_total",
            "Fresh pages claimed off the pool free list (cold joins, "
            "lazy COW growth, fork partials)")
        self.m_pages_freed = r.counter(
            "marian_serving_kv_pool_pages_freed_total",
            "Pages returned to the pool free list (row exits, beam "
            "reorders dropping dead lineages, cache evictions)")
        self.m_pages_aliased = r.counter(
            "marian_serving_kv_pool_pages_aliased_total",
            "Copy-on-write references added to already-live pages "
            "(beam forks, prefix hits, reorder shares) — pages served "
            "by aliasing instead of recompute or copy")
        self.m_pages_copied = r.counter(
            "marian_serving_kv_pool_pages_copied_total",
            "Partial pages content-copied by pool_fork_partial (the "
            "one copy a COW fork pays; cow=False replication copies "
            "full histories here too)")
        self.m_bytes_copied = r.counter(
            "marian_serving_kv_pool_bytes_copied_total",
            "Bytes moved by pool_fork_partial copies "
            "(pages_copied x the whole-decoder page cost)")
        self.m_bytes_aliased = r.counter(
            "marian_serving_kv_pool_bytes_aliased_total",
            "Bytes served by COW page aliasing instead of being copied "
            "(pages_aliased x the whole-decoder page cost) — the "
            "data-movement win the reorder/prefix sharing buys")
        self.m_forks = r.counter(
            "marian_serving_cow_forks_total",
            "Copy-on-write forks performed (prefix-cache live forks + "
            "beam-reorder child hypotheses that left their parent's "
            "row)")
        if self.prefix is not None:
            self.prefix._declare_metrics(r)
            r.gauge("marian_prefix_held_pages",
                    "KV pages currently held by prefix-cache entries "
                    "(retained decodes an exact repeat replays for free)"
                    ).set_function(self.prefix.held_pages)
            r.gauge("marian_prefix_reclaimable_pages",
                    "Pages evicting the whole prefix cache would free "
                    "RIGHT NOW (held references with page refcount 1) — "
                    "the pressure-relief headroom admission already counts"
                    ).set_function(
                        lambda: self.prefix.reclaimable_pages(self.pool))
        if self.features is not None \
                and self.features.shortlist_gen is not None:
            self.m_shortlist_rows = r.counter(
                "marian_shortlist_rows_total",
                "Decode rows admitted with a per-row lexical shortlist "
                "(iteration mode)")
            self.m_shortlist_width = r.histogram(
                "marian_shortlist_width_tokens",
                "Per-row shortlist width (the row's true padded index "
                "count — the output GEMM runs at the engine's static K)",
                buckets=(128, 256, 384, 512, 768, 1024, 2048, 4096))
        self._metrics_declared = True

    def _round_metrics(self, res: StepResult, forks: int) -> None:
        """One round's counters, from its page-traffic deltas and the
        forks it made (host-side numbers, after the round's sync)."""
        self.m_rounds.inc()
        if res.pages_claimed:
            self.m_pages_claimed.inc(res.pages_claimed)
        if res.pages_freed:
            self.m_pages_freed.inc(res.pages_freed)
        if res.pages_aliased:
            self.m_pages_aliased.inc(res.pages_aliased)
            self.m_bytes_aliased.inc(res.pages_aliased * self.page_bytes)
        if res.pages_copied:
            self.m_pages_copied.inc(res.pages_copied)
            self.m_bytes_copied.inc(res.pages_copied * self.page_bytes)
        if forks:
            self.m_forks.inc(forks)

    # -- /poolz -------------------------------------------------------------
    def _slot_owner(self, slot: int, s: _Slot):
        """The pool-claim owner of an occupied slot (the beam engine's
        owners are (key, slot) pairs)."""
        return s.key

    @staticmethod
    def _owner_label(owner) -> str:
        """A JSON-safe label for a claim owner: a serving unit carries
        its request's trace id (a beam row: ``#slot`` after it), a
        prefix-cache owner reads ``prefix-cache``; other keys fall back
        to repr. A tenanted owner's label starts ``<tenant>/``, the
        convention serving/fleet/accounting.py re-derives per-tenant page
        sums from (the shared prefix cache stays untenanted)."""
        probe = owner
        if isinstance(owner, tuple) and len(owner) == 2:
            probe = owner[0]              # beam (key, slot) pair
        req = getattr(probe, "req", None)
        tenant = getattr(req, "tenant", "") if req is not None \
            else getattr(probe, "tenant", "") or ""
        prefix = f"{tenant}/" if tenant else ""
        tid = getattr(req, "trace_id", "") if req is not None else ""
        if tid:
            base = f"{prefix}trace:{tid}"
            return base if probe is owner else f"{base}#{owner[1]}"
        if isinstance(owner, tuple) and len(owner) == 3 \
                and owner[0] == "prefix":
            return "prefix-cache"
        return (prefix + repr(owner))[:96]

    def pool_state(self) -> dict:
        """The ``/poolz`` document and the flight recorder's ``pool``
        member: the page map (refcount and owners of every live page),
        the slot table (trace id, position, cap, pages), the engine's
        counters and the last audit's verdict. Each map is a snapshot of
        its own (the pool's under its lock): a round committing
        mid-snapshot can skew adjacent maps by a row, which the auditor,
        not this inspector, judges."""
        refs = self.pool.refcounts()
        claims = self.pool.claims()
        alias = self.pool.alias_stats()
        stats = self.pool.stats()
        slots_snap = list(self._slots)
        owners_by_page: Dict[int, List[str]] = {}
        for owner, pages in claims.items():
            label = self._owner_label(owner)
            for p in pages:
                owners_by_page.setdefault(int(p), []).append(label)
        page_map = {
            str(p): {"refs": int(rc),
                     "owners": sorted(owners_by_page.get(p, []))}
            for p, rc in sorted(refs.items())}
        slot_rows = []
        for i, s in enumerate(slots_snap):
            if s is None:
                continue
            owner = self._slot_owner(i, s)
            slot_rows.append({
                "slot": i,
                "owner": self._owner_label(owner),
                "trace_id": getattr(getattr(s.key, "req", None),
                                    "trace_id", ""),
                "pos": int(s.pos),
                "cap": int(s.cap),
                "pages": [int(p) for p in self.pool.pages_of(owner)],
            })
        state = {
            "enabled": True,
            "engine": type(self).__name__,
            "pool": {
                "n_pages": self.pool.n_pages,
                "usable_pages": self.pool.usable_pages,
                "free_pages": self.pool.free_pages(),
                "used_pages": self.pool.used_pages(),
                "occupancy": round(self.occupancy(), 4),
                "page_len": self.page_len,
                "page_bytes": self.page_bytes,
                "max_pages_per_row": self.pool.max_pages_per_row,
                "live_pages": alias["live"],
                "shared_pages": alias["shared"],
                "refs": alias["refs"],
                "refcount_max": alias["max"],
                "cow_alias_ratio": round(self.cow_alias_ratio(), 4),
                "traffic": stats,
            },
            "pages": page_map,
            "rows": {
                "active": self._n_active,
                "max_rows": self.max_rows,
                "used_tokens": self.used_tokens(),
                "fragmentation": round(self.fragmentation(), 4),
                "slots": slot_rows,
            },
            "counters": dict(self.counters),
            "last_audit": dict(self._last_audit) if self._last_audit
            else None,
        }
        if self.prefix is not None:
            state["prefix_cache"] = {
                "entries": self.prefix.entries(),
                "held_tokens": self.prefix.held_tokens(),
                "held_pages": self.prefix.held_pages(),
                "reclaimable_pages":
                    self.prefix.reclaimable_pages(self.pool),
            }
        return state

    # -- pool invariant auditor ---------------------------------------------
    def audit(self, context: str = "quiesce") -> List[str]:
        """Cross-check the pool (free list, claims, refcounts) against
        the slots and the page table: every active row holds exactly its
        claim, in its table row, with an exclusive write-target page, and
        no claim outlives its row. Returns the violations (empty =
        clean) and reports them."""
        v = self.pool.audit()
        refs = self.pool.refcounts()
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if self._n_active != len(active):
            v.append(f"active-row counter {self._n_active} != "
                     f"{len(active)} occupied slots")
        for i, s in active:
            if self._by_key.get(s.key) != i:
                v.append(f"slot {i} key {s.key!r} missing from the key "
                         f"index (maps to {self._by_key.get(s.key)})")
            if s.pos > s.cap:
                v.append(f"slot {i} position {s.pos} past its decode cap "
                         f"{s.cap}")
            pages = self.pool.pages_of(s.key)
            if len(pages) != s.expected_refs:
                v.append(f"slot {i} holds {len(pages)} page reference(s), "
                         f"expected {s.expected_refs} (cap {s.cap})")
            if pages:
                # the page holding position pos is the one this row
                # writes: it must be exclusive
                wt = pages[min(s.pos // self.page_len, len(pages) - 1)]
                if refs.get(wt, 0) != 1:
                    v.append(f"slot {i} write-target page {wt} has "
                             f"refcount {refs.get(wt, 0)} (partial pages "
                             f"must be exclusive)")
            row = self._table[i]
            if list(row[:len(pages)]) != pages \
                    or any(int(p) != 0 for p in row[len(pages):]):
                v.append(f"slot {i} page-table row {[int(p) for p in row]} "
                         f"does not match its claim {pages} (table "
                         f"corruption)")
        cache = self._cache_owners()
        for owner in self.pool.owners():
            if owner in self._by_key or owner in cache:
                continue
            v.append(f"pool claim for {owner!r} has no active row "
                     f"(pages leaked at row exit)")
        self._note_audit(v, context)
        return v

    def _chaos_table_corrupt(self) -> None:
        """The ``pool.table_corrupt`` drill: an armed 'fail' points one
        active row's first page-table entry at the trash page while its
        claim still names the real page. The host table is what the next
        step uploads as the card's page table, so the kernel reads the
        wrong page, and the audit's table/claim check must catch it."""
        try:
            fp.fault_point("pool.table_corrupt")
        except fp.InjectedFault:
            slot = next((i for i, s in enumerate(self._slots)
                         if s is not None), None)
            if slot is not None:
                self._table[slot, 0] = 0

    def _note_audit(self, v: List[str], context: str) -> None:
        """Count one audit, keep its verdict for /poolz, report its
        violations."""
        self.counters["audits"] += 1
        self._last_audit = {"context": context, "clean": not v,
                            "violations": list(v[:8]), "ts": time.time()}
        if hasattr(self, "m_audits"):
            self.m_audits.inc()
        if v:
            self._report_audit(v, context)

    def _cache_owners(self) -> set:
        """The pool owners the prefix cache's entries hold."""
        return (set(self.prefix.owner_keys()) if self.prefix is not None
                else set())

    def _report_audit(self, violations: List[str], context: str) -> None:
        """One audit failure: a loud log line, the counter, a timeline
        event and a flight dump naming the fault."""
        log.error("POOL AUDIT FAILED ({}): {} violation(s): {}", context,
                  len(violations), "; ".join(violations[:4]))
        self.counters["audit_failures"] += 1
        if hasattr(self, "m_audit_failures"):
            self.m_audit_failures.inc()
        obs.event("pool.audit_failed", context=context,
                  violations=list(violations[:8]))
        obs.FLIGHT.trip_async(
            "pool-audit", detail=f"{context}: " + "; ".join(violations[:4]))

    # -- device work ----------------------------------------------------------
    def _install(self, joiners: List[Tuple[object, List[int], int]]) -> None:
        """Encode the joiners (JOIN_BUCKETS rows at a time) and write
        their cross-attention K/V and source masks into their slots. The
        encode runs at the chunk's halving width, not at src_cap: a
        5-token sentence must not pay a max-length-wide encoder pass
        (the K/V rows are zero-padded to src_cap, where the mask is 0)."""
        jb = next((b for b in self.JOIN_BUCKETS if b >= len(joiners)),
                  self.JOIN_BUCKETS[-1])
        row_keys = self._keys[0]
        for base in range(0, len(joiners), jb):
            chunk = joiners[base:base + jb]
            need = max(len(ids) for _, ids, _ in chunk)
            w = min(x for x in self.encode_widths() if x >= need)
            ids_np = np.zeros((jb, w), np.int64)
            mask_np = np.zeros((jb, self.src_cap), np.float32)
            slot_np = np.zeros((jb,), np.int64)
            for i in range(jb):
                # padding rows repeat joiner 0: their writes land on the
                # same slot with identical content
                _, ids, slot = chunk[min(i, len(chunk) - 1)]
                ids_np[i, :len(ids)] = ids
                mask_np[i, :len(ids)] = 1.0
                slot_np[i] = slot
            ids_t = torch.from_numpy(ids_np).to(self.device)
            mask = torch.from_numpy(mask_np).to(self.device)
            slots = torch.from_numpy(slot_np).to(self.device)
            enc = self.model.encode_for_decode(self.params, ids_t,
                                               mask[:, :w])
            st = self.model.start_state(self.params, enc, mask[:, :w], 1)
            for k in row_keys:
                v = st[k].to(self._state[k].dtype)
                pad = self._state[k].shape[-2] - v.shape[-2]
                self._state[k][slots] = torch.nn.functional.pad(
                    v, (0, 0, 0, pad))
            self._src_mask[slots] = mask
            self.counters["encodes"] += 1

    def _step_state(self, rb: int):
        """(the model's step state over slots [0, rb) without ``pos``,
        their source mask): the rows' cross K/V, the pools, this round's
        page table."""
        row_keys, pool_keys, whole_keys = self._keys
        sub = {k: self._state[k][:rb] for k in row_keys}
        sub.update({k: self._state[k] for k in pool_keys + whole_keys})
        sub["page_table"] = torch.from_numpy(self._table[:rb]).to(
            self.device)
        return sub, self._src_mask[:rb]

    def _finish(self, res: StepResult, key, tokens: List[int],
                info: Optional[dict] = None,
                text: Optional[str] = None) -> None:
        """The round tail of a finished sentence: its text (``tokens``
        decoded, or ``text``) and ``info`` into ``res``, then its slots
        and pages freed (or handed to the prefix cache with the text)."""
        if text is None:
            text = self.trg_vocab.decode(tokens, ignore_eos=True)
        res.finished.append((key, text))
        if info is not None:
            res.finished_info[key] = info
        self._evict(key, adopt_text=text)

    def _feature_inputs(self, rb: int, steps: int) -> dict:
        """The rows' decode-surface inputs of a round over slots [0, rb),
        uploaded once: ``sl`` [rb, K] shortlists and ``sl_len`` [rb] true
        widths, ``lane`` [rb, 1] noise lanes and ``ctr`` [rb, 1] their
        positions, ``forced`` [steps, rb] trunk tokens (-1: free). Idle
        rows get neutral values (full width, lane 0, free); their
        outputs are dropped. Empty without a plane."""
        plane = self.features
        if plane is None:
            return {}
        arrays = {}
        feats = [(i, s.feat) for i, s in enumerate(self._slots[:rb])
                 if s is not None and s.feat is not None]
        if plane.shortlist_gen is not None:
            sl = np.zeros((rb, plane.k_static), np.int64)
            sl_len = np.full((rb,), plane.k_static, np.int64)
            for i, f in feats:
                if f.shortlist is not None:
                    sl[i], sl_len[i] = f.shortlist, f.sl_len
            arrays.update(sl=sl, sl_len=sl_len)
        if plane.sampling:
            lane = np.zeros((rb, 1), np.int64)
            ctr = np.zeros((rb, 1), np.int64)
            for i, f in feats:
                lane[i, 0], ctr[i, 0] = f.lane, self._slots[i].pos
            arrays.update(lane=lane, ctr=ctr)
        if plane.force_decode:
            forced = np.full((steps, rb), -1, np.int64)
            for i, f in feats:
                pos = self._slots[i].pos
                forced[:, i] = [f.forced_at(pos + j) for j in range(steps)]
            arrays["forced"] = forced
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def _masked_logits(self, logits: torch.Tensor, feats: dict):
        """A shortlisted row's [K] logits with the coordinates past its
        true width at NEG_INF (engine padding, not the dense twin's: it
        leaves the softmax before it happens)."""
        if "sl" not in feats:
            return logits
        coords = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(coords[None, :] < feats["sl_len"][:, None],
                           logits, torch.full_like(logits, NEG_INF))

    def _step(self, res: StepResult) -> None:
        """One round: steps_per_round decode steps over the occupied
        prefix, rounded up to a row bucket, tokens copied to the host
        once; then the host cuts each row at its EOS or cap."""
        top = max(i for i, s in enumerate(self._slots) if s is not None)
        rb = bucket_rows(top + 1, self.row_buckets)
        pos_np = np.full((rb,), -1, np.int32)
        prev_np = np.zeros((rb, 1), np.int64)
        for i in range(rb):
            s = self._slots[i]
            if s is not None:
                pos_np[i] = s.pos
                prev_np[i, 0] = s.prev
        sub, src_mask = self._step_state(rb)
        pos = torch.from_numpy(pos_np).to(self.device)
        prev = torch.from_numpy(prev_np).to(self.device)
        feats = self._feature_inputs(rb, self.steps_per_round)
        sl = feats.get("sl")
        plane = self.features
        if plane is not None and plane.sampling:
            temp, topn = sampling_params(plane.sampling)
        toks = []
        with self._sync_guard():
            for j in range(self.steps_per_round):
                sub["pos"] = pos
                kw = {} if sl is None else {"shortlist": sl}
                logits, _ = self.model.step(self.params, sub, prev,
                                            src_mask, **kw)
                logits = self._masked_logits(logits, feats)
                if "lane" in feats:
                    # gumbel-max on the row's lane at its position
                    coords = torch.arange(logits.shape[-1],
                                          device=logits.device)
                    noise = gumbel_noise(plane.seed, feats["lane"],
                                         feats["ctr"] + j, coords[None, :])
                    nxt = sample_pick(
                        torch.log_softmax(logits.float(), dim=-1), noise,
                        temp, topn)
                else:
                    nxt = torch.argmax(logits, dim=-1)
                if sl is not None:
                    # coordinates to vocabulary ids on the device: the
                    # next step embeds this token
                    nxt = sl.gather(1, nxt[:, None])[:, 0]
                if "forced" in feats:
                    f = feats["forced"][j]
                    nxt = torch.where(f >= 0, f, nxt)
                toks.append(nxt)
                prev = nxt[:, None]
                pos = pos + 1
        # the one host sync of the round: the join/evict schedule runs on
        # the host between rounds
        toks = torch.stack(toks).cpu().numpy()
        emitted = 0
        consumed = 0
        finishes: List[_Slot] = []
        for i in range(rb):
            s = self._slots[i]
            if s is None:
                continue
            emitted += 1
            for j in range(toks.shape[0]):
                tok = int(toks[j, i])
                s.pos += 1
                s.prev = tok
                consumed += 1
                if tok != EOS_ID:
                    s.tokens.append(tok)
                if tok == EOS_ID or s.pos >= s.cap:
                    # the rest of the round's tokens for this row were
                    # self-fed past its end: dropped here, and the cache
                    # positions past the cut are never read again
                    finishes.append(s)
                    break
        for s in finishes:
            self._finish(res, s.key, s.tokens)
        # streaming rows still decoding report their text so far
        for s in self._slots[:rb]:
            if s is not None and s.feat is not None and s.feat.stream:
                res.partials.append(
                    (s.key, self.trg_vocab.decode(s.tokens, ignore_eos=True),
                     s.pos))
        res.rows = emitted
        res.bucket = rb
        res.tokens = consumed
        res.steps += toks.shape[0]

    # -- direct (non-serving) decoding --------------------------------------
    def decode_texts(self, texts: Sequence[str]) -> List[str]:
        """Decode sentences to completion through the slot machinery
        (joins as capacity frees up): the library-call equivalent of the
        serving loop."""
        pending = list(enumerate(texts))
        out: Dict[int, str] = {}
        guard = 0
        while pending or not self.idle():
            joins = pending[:self.max_rows]
            del pending[:self.max_rows]
            res = self.admit_and_step(joins)
            for key, why in res.rejected:
                if why in FATAL_REASONS:
                    raise ValueError(f"sentence {key} rejected: {why}")
                pending.insert(0, (key, texts[key]))
            # evicted on a dry pool: decoded again once pages free up
            for key in res.pool_evicted:
                pending.insert(0, (key, texts[key]))
            out.update(res.finished)
            guard += 1
            if guard > 100000:
                raise RuntimeError("iteration decode failed to converge")
        return [out[i] for i in range(len(texts))]

    def encode_widths(self) -> Tuple[int, ...]:
        """The halving encode widths _install draws from: src_cap, /2,
        /4, ... down to 8 (descending)."""
        widths = []
        w = self.src_cap
        while True:
            widths.append(w)
            if w // 2 < 8:
                break
            w //= 2
        return tuple(widths)


class EngineExecutor:
    """An engine as a ``List[str] -> List[str]`` callable
    (``decode_texts``, the serving lifecycle's warmup), with ``.engine``
    for whoever re-points a scheduler at it. A call runs outside every
    other thread's sync-debug guard (``sync_exclusive``): it syncs the
    host, on the lifecycle's watcher thread, while the live engine may
    be in a guarded round."""

    def __init__(self, engine: PagedDecodeEngine):
        self.engine = engine

    def __call__(self, lines: List[str]) -> List[str]:
        with sync_exclusive():
            return self.engine.decode_texts(lines)
