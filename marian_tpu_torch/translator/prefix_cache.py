"""Cross-request prefix sharing over the paged KV pool, the port of
``marian_tpu/translator/prefix_cache.py`` (``--prefix-cache``), behind
``PrefixCache._lock`` (``lockdep.make_lock``, as in the reference). Its
``counters`` dict moves with the reference's ``marian_prefix_*`` series
once an engine declares them (``_declare_metrics``).

An exact repeat of a source's token sequence becomes a page-table hit
instead of repeated compute, through the refcounts copy-on-write beam
forking uses (ops/kernels/kv_pool.py):

- LIVE fork (the greedy engine): a request whose source matches a
  sentence decoding right now joins as a follower. Its cross-attention
  rows are copied slot to slot (no encoder pass), its page table aliases
  the leader's full (append-only) pages, only the leader's partial page
  is copied (``pool_fork_partial``), and it resumes at the leader's
  position.
- DONE entry: a finished greedy row's pages move to the cache (owner
  ``("prefix", version, key)``, refcounts unchanged) with its tokens and
  text; a finished beam sentence leaves a pageless entry (its
  hypotheses' pages are released at the finish). A later exact repeat
  replays the text at join: decoding is deterministic per model
  version, so the replay is what a cold decode would give.
- LRU under pool pressure: a claim the free list cannot meet evicts the
  least recently used page-backed entries, those whose pages would free
  now (refcount 1) first, until it fits.

Keys are the exact source token sequence: the encoder is bidirectional,
so a strict prefix of another source shares no encoder states. Entries
carry the model version, and each engine owns its cache.

Threading: mutations happen on the serving scheduler's device worker
thread; admission reads ``reclaimable_pages`` from the event loop, hence
the lock. The lock guards only the cache's own maps and is never held
across a pool call.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

from ..common import lockdep


class PrefixEntry:
    __slots__ = ("key", "tokens", "text", "pages", "version")

    def __init__(self, key, tokens: List[int], text: str,
                 pages: List[int], version: str):
        self.key = key
        self.tokens = tokens        # decoded target ids (no EOS)
        self.text = text
        self.pages = pages          # the cache's pool references
        self.version = version


class PrefixCache:
    """(model version, source token sequence) -> a finished decode and
    its refcounted KV pages. One instance per engine."""

    def __init__(self, max_entries: int = 64, version: str = "unversioned"):
        self.max_entries = max(1, int(max_entries))
        self.version = str(version)
        self._lock = lockdep.make_lock("PrefixCache._lock")
        # insertion-ordered: move_to_end on a hit makes it the LRU list
        self._done: "collections.OrderedDict[tuple, PrefixEntry]" = \
            collections.OrderedDict()
        # source key -> the leader row's key while that sentence decodes
        self._live: Dict[tuple, object] = {}
        self._held_tokens = 0
        # hits (forks + replays), misses, decode steps not recomputed,
        # pages served by aliasing or retention, entries evicted
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "tokens_saved": 0, "pages_reused": 0,
            "evictions": 0}
        # counter name -> its marian_prefix_* series (_declare_metrics)
        self._series: Dict[str, object] = {}

    # -- metrics ------------------------------------------------------------
    def _declare_metrics(self, r) -> None:
        self._series = {
            "hits": r.counter(
                "marian_prefix_hits_total",
                "Prefix-cache hits (live forks + completed-entry replays)"),
            "misses": r.counter(
                "marian_prefix_misses_total",
                "Prefix-cache lookups that found no shareable source"),
            "tokens_saved": r.counter(
                "marian_prefix_tokens_saved_total",
                "Decode steps NOT recomputed thanks to prefix sharing "
                "(leader position at fork time; full decode length on a "
                "completed-entry replay)"),
            "pages_reused": r.counter(
                "marian_prefix_pages_reused_total",
                "KV pages served by table aliasing / cache retention "
                "instead of being recomputed and rewritten"),
            "evictions": r.counter(
                "marian_prefix_evictions_total",
                "Prefix-cache entries evicted (LRU capacity or pool "
                "pressure); their page references were dropped"),
        }
        r.gauge("marian_prefix_entries",
                "Completed decodes currently held by the prefix cache"
                ).set_function(self.entries)

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n
        m = self._series.get(name)
        if m is not None and n:
            m.inc(n)

    def _note_hit(self, tokens_saved: int, pages_reused: int) -> None:
        self._count("hits")
        self._count("tokens_saved", tokens_saved)
        self._count("pages_reused", pages_reused)

    def note_miss(self) -> None:
        self._count("misses")

    # -- capacity / introspection (any thread) ------------------------------
    def entries(self) -> int:
        with self._lock:
            return len(self._done)

    def held_tokens(self) -> int:
        """Tokens held in the cache's pages."""
        with self._lock:
            return self._held_tokens

    def held_pages(self) -> int:
        """Page references the entries hold."""
        with self._lock:
            return sum(len(e.pages) for e in self._done.values())

    def owner(self, key: tuple):
        return ("prefix", self.version, key)

    def owner_keys(self) -> List[object]:
        with self._lock:
            return [self.owner(k) for k in self._done]

    def owns(self, owner) -> bool:
        return (isinstance(owner, tuple) and len(owner) == 3
                and owner[0] == "prefix" and owner[1] == self.version)

    def reclaimable_pages(self, pool) -> int:
        """Pages that evicting the whole cache would free now (held
        references of refcount 1): the engine adds them to its free
        pages, so page-priced admission sees relievable pressure."""
        with self._lock:
            pages = [p for e in self._done.values() for p in e.pages]
        if not pages:
            return 0
        refs = pool.refcounts()
        return sum(1 for p in pages if refs.get(p, 0) == 1)

    # -- lookups (device worker thread) -------------------------------------
    def get(self, key: tuple, version: str) -> Optional[PrefixEntry]:
        """The finished entry of ``key`` (an LRU touch), or None; an entry
        of another model version is never served."""
        with self._lock:
            e = self._done.get(key)
            if e is None or e.version != version:
                return None
            self._done.move_to_end(key)
        self._note_hit(len(e.tokens) + 1, len(e.pages))
        return e

    def leader(self, key: tuple) -> Optional[object]:
        """The row key of a live sentence with this source, if one is
        decoding (the fork source). The caller checks the row and counts
        the hit (a fork can still fall back to a cold join)."""
        with self._lock:
            return self._live.get(key)

    def note_fork(self, tokens_saved: int, pages_reused: int) -> None:
        self._note_hit(tokens_saved, pages_reused)

    def register_live(self, key: tuple, row_key) -> None:
        with self._lock:
            self._live.setdefault(key, row_key)

    def unregister_live(self, key: tuple, row_key) -> None:
        with self._lock:
            if self._live.get(key) == row_key:
                del self._live[key]

    # -- adoption and eviction (device worker thread) -----------------------
    def adopt(self, pool, key: tuple, row_key, tokens: List[int],
              text: str) -> int:
        """A row with source ``key`` finished: move its page references to
        the cache (refcounts unchanged) with its decode. Returns the
        references adopted: 0 (the caller releases them) when an entry
        exists already or the row held nothing."""
        with self._lock:
            if key in self._done:
                return 0
        pages = pool.transfer(row_key, self.owner(key))
        if not pages:
            return 0
        with self._lock:
            self._done[key] = PrefixEntry(key, list(tokens), text, pages,
                                          self.version)
            self._held_tokens += len(tokens) + 1
        self._trim_lru(pool)
        return len(pages)

    def remember(self, pool, key: tuple, tokens: List[int],
                 text: str) -> bool:
        """A pageless finished entry (the beam engine's replay memo: its
        hypotheses' pages are released at the finish), under the same LRU
        and version rules as page-backed ones."""
        with self._lock:
            if key in self._done:
                return False
            self._done[key] = PrefixEntry(key, list(tokens), text, [],
                                          self.version)
        self._trim_lru(pool)
        return True

    def _pop_entry(self, key: tuple) -> Optional[PrefixEntry]:
        with self._lock:
            e = self._done.pop(key, None)
            if e is not None and e.pages:
                self._held_tokens -= len(e.tokens) + 1
        return e

    def _release_entry(self, pool, key: tuple,
                       e: Optional[PrefixEntry]) -> bool:
        if e is None:
            return False
        if e.pages:
            pool.release(self.owner(key))
        self._count("evictions")
        return True

    def _trim_lru(self, pool) -> None:
        while True:
            with self._lock:
                if len(self._done) <= self.max_entries:
                    return
                key = next(iter(self._done))
                e = self._done.pop(key)
                if e.pages:
                    self._held_tokens -= len(e.tokens) + 1
            self._release_entry(pool, key, e)

    def evict_for_pages(self, pool, n_needed: int) -> int:
        """Pool pressure: drop LRU page-backed entries until ``n_needed``
        pages are free or none is left, those whose every page has
        refcount 1 (they free pages now) first. Returns the entries
        evicted."""
        evicted = 0
        while pool.free_pages() < n_needed:
            with self._lock:
                # a pageless memo frees nothing: keep it
                items = [(k, list(e.pages))
                         for k, e in self._done.items() if e.pages]
            if not items:
                break
            refs = pool.refcounts()
            key = next((k for k, pages in items
                        if all(refs.get(p, 0) <= 1 for p in pages)),
                       items[0][0])
            if self._release_entry(pool, key, self._pop_entry(key)):
                evicted += 1
        return evicted

    def drop_all(self, pool) -> int:
        """Release every entry (engine teardown, tests)."""
        n = 0
        while True:
            with self._lock:
                key = next(iter(self._done), None)
            if key is None:
                break
            if self._release_entry(pool, key, self._pop_entry(key)):
                n += 1
        with self._lock:
            self._live.clear()
        return n
