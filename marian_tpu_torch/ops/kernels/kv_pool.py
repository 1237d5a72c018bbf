"""Paged KV-cache pool for iteration-level (continuous) decoding, the port
of ``marian_tpu/ops/pallas/kv_pool.py``.

The dense decode cache is a per-batch tensor ``[rows, H, L, Dh]``; here
one POOL of fixed-size pages serves every row:

- pools ``[n_pages, H, page_len, Dh]``, one K and one V per decoder
  layer, sized to a byte budget, not to any batch;
- a page table ``[rows, max_pages]`` int32 mapping row r's logical
  positions ``[j*page_len, (j+1)*page_len)`` to physical page
  ``table[r, j]``;
- per-row positions ``row_pos`` int32: rows of different ages share a
  step, and ``row_pos < 0`` marks an idle slot.

Page 0 is the reserved trash page: the allocator never hands it out,
table entries of unclaimed slots point at it, and idle rows write zeros
into it, so their writes collide deterministically.

``KVPool`` is the host-side refcounted allocator (a copy of the
reference's, behind ``KVPool._lock``), with the reference's ownership
witness hooks (``common/ownwit.py``, under ``MARIAN_OWNWIT=1``) and its
corruption drills: ``chaos_double_free``, ``chaos_refcount_corrupt``,
``chaos_tenant_leak`` and the ``pool.release_drop`` point in
``release``, each a no-op unless its fault point is armed, each
corrupting the host state (claims, refcounts, free list) that
``audit()`` or ``audit_tenants`` must catch. ``pool_fork_partial``
copies the partial pages a beam fork diverges on, and
``beam_table_reorder`` is the fused beam round's page-table reorder
(int32 table math on the device). ``pool_insert`` writes
each row's new-token K/V into its page IN PLACE: the reference returns
new pools because XLA donates the old ones, and a copy of a pool per
layer per step would cost more than the attention read. On a CUDA tensor
``paged_decode_attention`` inserts, then launches the hand-written
kernel ``csrc/paged_decode_attention.cu`` through
``paged_decode_attention_read`` (on the current stream, after the
insert) or raises; on a CPU tensor it runs
``paged_decode_attention_reference``, the reference's gather followed
by the dense plain version's masked softmax, in its op order.
``paged_decode_attention.launches`` counts kernel launches.

The kernel streams a row's live positions through the page table as
16-byte vectors in chunks of whole pages (or whole parts of one page),
with ``decode_attention``'s layout (``vector_layout``); ``paged_route``
chooses the layout and the number of chunk buffers by the shapes, or
the scalar kernel for rows that are not whole 16-byte vectors, unaligned
pools and page lengths that do not tile a chunk, never on a failed
launch.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...common import faultpoints as fp
from ...common import lockdep, ownwit
from ..ops import NEG_INF
from . import _build
from .decode_attention import vector_layout, vector_path

# active-row buckets: the iteration engine rounds its occupied slot
# prefix UP to the next entry, so steps run at a closed set of shapes
ROW_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

# tokens per page: 16 x Dh 64 x 4 B = 4 KiB per (page, head) K tile
DEFAULT_PAGE_LEN = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448      # bytes of shared memory a Hopper block may take
H100_SMS = 132


def pages_for_tokens(n_tokens: int, page_len: int) -> int:
    """Pages a row needs to hold ``n_tokens`` positions."""
    return max(1, -(-int(n_tokens) // max(1, int(page_len))))


def bucket_rows(n: int, buckets: Sequence[int] = ROW_BUCKETS) -> int:
    """Smallest row bucket >= n (the largest bucket caps it)."""
    buckets = sorted(buckets)
    i = bisect.bisect_left(buckets, max(1, int(n)))
    return buckets[min(i, len(buckets) - 1)]


def state_key_groups(state_keys) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                                          Tuple[str, ...]]:
    """Classify a paged decode state's keys (one definition, shared by
    the engine and ``greedy_decode_paged``): row keys (cross-attention
    K/V, sliced to the step's row prefix), pool keys (the K/V pools,
    written by every step) and whole keys (anything else that passes
    through). ``pos`` and ``page_table`` are host-owned and in none."""
    keys = tuple(state_keys)
    row_keys = tuple(k for k in keys if "_cross_" in k)
    pool_keys = tuple(k for k in keys if "_pool_" in k)
    whole_keys = tuple(k for k in keys
                       if k not in row_keys and k not in pool_keys
                       and k not in ("pos", "page_table"))
    return row_keys, pool_keys, whole_keys


# ---------------------------------------------------------------------------
# host-side page allocator
# ---------------------------------------------------------------------------

class PoolExhausted(RuntimeError):
    """A claim could not be satisfied: an admission decision (defer or
    shed the sentence), never a reason to stall a step other rows wait
    on."""


class PoolCorruption(RuntimeError):
    """The pool auditor found an invariant violation. ``retriable``: the
    scheduler rebuilds the engine and the evicted rows' requests may be
    resent (``!!SERVER-RETRY``)."""

    retriable = True


class KVPool:
    """Refcounted free-list page allocator over the pool's index space.

    Host bookkeeping only (the device tensors live in the decode state).
    An owner's claim is the list of table references its page-table row
    holds; a page's refcount is the number of references across all
    owners. Fresh claims are all-or-nothing, so a greedy row holds every
    page its decode cap needs or none: a step can never run dry mid-row.
    ``share``/``retable``/``transfer`` carry the reference's
    copy-on-write verbs (used by beam and prefix sharing there).

    The lock guards the free list, the claims and the refcounts against
    readers on other threads (the server's admission reads free pages
    while the device worker claims).

    Under ``MARIAN_OWNWIT=1`` (read once, here) every verb records its
    call site with the ownership witness; the pool's one token names it
    there.
    """

    def __init__(self, n_pages: int, page_len: int = DEFAULT_PAGE_LEN,
                 max_pages_per_row: int = 0):
        if n_pages < 2:
            raise ValueError(f"KVPool needs >= 2 pages (page 0 is the "
                             f"reserved trash page); got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        self.max_pages_per_row = int(max_pages_per_row) or (n_pages - 1)
        self._ownwit = ownwit.enabled()
        self._ownwit_tok = ownwit.new_token() if self._ownwit else 0
        self._lock = lockdep.make_lock("KVPool._lock")
        # LIFO free list, low pages first out: replays are deterministic
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._claims: Dict[object, List[int]] = {}
        # page -> live refcount; a page is EITHER here or free
        self._refs: Dict[int, int] = {}
        # cumulative traffic: fresh pages claimed, pages freed (last
        # reference dropped), references added to live pages
        self._stats = {"claimed": 0, "freed": 0, "aliased": 0}

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus the reserved trash page)."""
        return self.n_pages - 1

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def used_pages(self) -> int:
        with self._lock:
            return self.n_pages - 1 - len(self._free)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(int(page), 0)

    def refcounts(self) -> Dict[int, int]:
        """Snapshot of the live refcount map."""
        with self._lock:
            return dict(self._refs)

    def claim(self, owner, n: int, row_cap: bool = True) -> List[int]:
        """Claim ``n`` fresh pages (refcount 1) for ``owner``,
        all-or-nothing; :class:`PoolExhausted` when the free list is
        short or (``row_cap``) the table row cannot hold them."""
        n = int(n)
        if row_cap and n > self.max_pages_per_row:
            raise PoolExhausted(
                f"row needs {n} pages but the page table holds "
                f"{self.max_pages_per_row} (raise --kv-page-len or the "
                f"pool budget)")
        with self._lock:
            if owner in self._claims:
                raise ValueError(f"owner {owner!r} already holds pages")
            if n > len(self._free):
                raise PoolExhausted(
                    f"pool exhausted: {n} pages requested, "
                    f"{len(self._free)} free of {self.n_pages - 1}")
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self._claims[owner] = pages
            self._stats["claimed"] += n
        if self._ownwit:
            ownwit.note_acquire("kv-pages", self._ownwit_tok, owner)
        return list(pages)

    def claim_extra(self, owner, n: int = 1,
                    row_cap: bool = True) -> List[int]:
        """Append ``n`` fresh pages to an existing owner's references,
        all-or-nothing."""
        n = int(n)
        with self._lock:
            held = self._claims.get(owner)
            if held is None:
                raise ValueError(f"owner {owner!r} holds no pages to "
                                 f"extend (use claim)")
            if row_cap and len(held) + n > self.max_pages_per_row:
                raise PoolExhausted(
                    f"row would hold {len(held) + n} pages but the page "
                    f"table holds {self.max_pages_per_row}")
            if n > len(self._free):
                raise PoolExhausted(
                    f"pool exhausted: {n} extra pages requested, "
                    f"{len(self._free)} free of {self.n_pages - 1}")
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            held.extend(pages)
            self._stats["claimed"] += n
        if self._ownwit:
            ownwit.note_acquire("kv-pages", self._ownwit_tok, owner)
        return list(pages)

    def share(self, owner, pages: Sequence[int],
              row_cap: bool = True) -> None:
        """Add references to LIVE pages for ``owner`` (created if
        absent); a dead page is refused."""
        with self._lock:
            for p in pages:
                p = int(p)
                if self._refs.get(p, 0) < 1:
                    raise ValueError(
                        f"cannot share page {p}: not live (freed or "
                        f"never claimed)")
            held = self._claims.setdefault(owner, [])
            if row_cap and len(held) + len(pages) \
                    > self.max_pages_per_row:
                raise PoolExhausted(
                    f"row would hold {len(held) + len(pages)} pages but "
                    f"the page table holds {self.max_pages_per_row}")
            for p in pages:
                self._refs[int(p)] += 1
                held.append(int(p))
            self._stats["aliased"] += len(pages)
        if self._ownwit:
            ownwit.note_acquire("kv-pages", self._ownwit_tok, owner)

    def retable(self, owner, new_pages: Sequence[int]) -> int:
        """Rewrite ``owner``'s reference list to ``new_pages`` (all of
        them live) as an incref/decref diff; returns the pages freed.
        An empty list drops the owner."""
        new_list = [int(p) for p in new_pages]
        with self._lock:
            owner_existed = owner in self._claims
            old_list = self._claims.get(owner, [])
            if len(new_list) > self.max_pages_per_row:
                raise PoolExhausted(
                    f"row would hold {len(new_list)} pages but the page "
                    f"table holds {self.max_pages_per_row}")
            for p in new_list:
                if self._refs.get(p, 0) < 1:
                    raise ValueError(
                        f"cannot retable to page {p}: not live")
            old_set = set(old_list)
            for p in new_list:
                self._refs[p] += 1
                if p not in old_set:
                    self._stats["aliased"] += 1
            freed = 0
            # reverse order: a retable-to-empty frees as release() does
            for p in reversed(old_list):
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
                    freed += 1
            self._stats["freed"] += freed
            if new_list:
                self._claims[owner] = new_list
            else:
                self._claims.pop(owner, None)
        if self._ownwit:
            if new_list:
                # kept or made: the retable site holds references now
                ownwit.note_acquire("kv-pages", self._ownwit_tok, owner)
            elif owner_existed:
                # a retable to empty is the beam engine's release
                ownwit.note_release("kv-pages", self._ownwit_tok, owner)
        return freed

    def transfer(self, src_owner, dst_owner) -> List[int]:
        """Move ``src_owner``'s whole reference list to ``dst_owner``
        (refcounts unchanged); a missing source moves nothing."""
        with self._lock:
            if dst_owner in self._claims:
                raise ValueError(f"transfer target {dst_owner!r} "
                                 f"already holds pages")
            pages = self._claims.pop(src_owner, None)
            if not pages:
                return []
            self._claims[dst_owner] = pages
        if self._ownwit:
            ownwit.note_transfer("kv-pages", self._ownwit_tok, src_owner,
                                 dst_owner)
        return list(pages)

    def release(self, owner) -> int:
        """Drop every reference ``owner`` holds (freeing pages whose last
        reference drops); returns the references dropped. An owner that
        holds nothing (released twice, or after a transfer) raises
        ``ValueError``: the caller's bookkeeping has diverged.

        The ``pool.release_drop`` drill: an armed 'fail' makes this
        release do nothing, the suppressed-release leak, so the ownership
        witness and the auditors are held against a real one."""
        try:
            fp.fault_point("pool.release_drop")
        except fp.InjectedFault:
            return 0
        with self._lock:
            pages = self._claims.pop(owner, None)
            if pages is None:
                raise ValueError(
                    f"release of owner {owner!r} which holds no pages — "
                    f"released twice, or released after its references "
                    f"were transferred away")
            # reverse order: a release + reclaim of the same count gets
            # the same page ids back (replay determinism)
            for p in reversed(pages):
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
                    self._stats["freed"] += 1
        if self._ownwit:
            ownwit.note_release("kv-pages", self._ownwit_tok, owner)
        return len(pages)

    def pages_of(self, owner) -> List[int]:
        with self._lock:
            return list(self._claims.get(owner, []))

    def owners(self) -> List[object]:
        with self._lock:
            return list(self._claims.keys())

    def claims(self) -> Dict[object, List[int]]:
        """Snapshot of the claims table (owner -> page references)."""
        with self._lock:
            return {k: list(v) for k, v in self._claims.items()}

    def stats(self) -> Dict[str, int]:
        """Cumulative claimed/freed/aliased counters."""
        with self._lock:
            return dict(self._stats)

    def alias_stats(self) -> Dict[str, int]:
        """Live pages, pages with refcount >= 2, total references and
        the largest refcount."""
        with self._lock:
            refs = self._refs
            return {
                "live": len(refs),
                "shared": sum(1 for c in refs.values() if c > 1),
                "refs": sum(refs.values()),
                "max": max(refs.values(), default=0),
            }

    def audit(self) -> List[str]:
        """Cross-check the free list, the claims and the refcounts;
        returns the violations found (empty = clean): a page free twice
        or free and referenced, an out-of-range or trash page handed
        out, refcounts that disagree with the table references, and
        pages accounted to neither side."""
        with self._lock:
            free = list(self._free)
            claims = {k: list(v) for k, v in self._claims.items()}
            refs = dict(self._refs)
        v: List[str] = []
        seen_free: Dict[int, bool] = {}
        for p in free:
            if p == 0:
                v.append("free list holds the reserved trash page 0")
                continue
            if not 1 <= p < self.n_pages:
                v.append(f"free list holds out-of-range page {p}")
                continue
            if p in seen_free:
                v.append(f"page {p} appears twice in the free list "
                         f"(double-free)")
            seen_free[p] = True
            if refs.get(p, 0) > 0:
                v.append(f"page {p} is free but still has refcount "
                         f"{refs[p]} (freed page with live references)")
        expected: Dict[int, int] = {}
        for owner, pages in claims.items():
            for p in pages:
                if p == 0 or not 1 <= p < self.n_pages:
                    v.append(f"claim {owner!r} holds invalid page {p}")
                    continue
                expected[p] = expected.get(p, 0) + 1
        for p, want in sorted(expected.items()):
            have = refs.get(p, 0)
            if have != want:
                v.append(f"page {p} has refcount {have} but "
                         f"{want} table reference(s) (refcount drift)")
            if p in seen_free:
                v.append(f"page {p} is both free and referenced "
                         f"(double-free)")
        for p, rc in sorted(refs.items()):
            if rc <= 0:
                v.append(f"page {p} has non-positive refcount {rc} "
                         f"outside the free list")
            elif p not in expected:
                v.append(f"page {p} has refcount {rc} but no table "
                         f"reference names it (phantom refcount)")
        if not v:
            total = len(free) + len(refs)
            if total != self.usable_pages:
                v.append(f"{self.usable_pages - total} page(s) leaked: "
                         f"{len(free)} free + {len(refs)} live of "
                         f"{self.usable_pages} allocatable")
        return v

    # -- corruption drills: no-ops unless their fault point is armed ---------
    def chaos_double_free(self) -> None:
        """The ``pool.double_free`` drill: an armed 'fail' re-frees one
        still-claimed owner's pages, the real double-free state, so the
        auditor is held against corruption, not a mocked report. Kill
        and hang act as at any other crossing."""
        try:
            fp.fault_point("pool.double_free")
        except fp.InjectedFault:
            with self._lock:
                for pages in self._claims.values():
                    if pages:
                        self._free.extend(reversed(pages))
                        break

    def chaos_refcount_corrupt(self) -> None:
        """The ``pool.refcount_corrupt`` drill: an armed 'fail' bumps one
        live page's refcount without a table reference (the
        lost-decref/phantom-incref class of the copy-on-write verbs)."""
        try:
            fp.fault_point("pool.refcount_corrupt")
        except fp.InjectedFault:
            with self._lock:
                for p in sorted(self._refs):
                    self._refs[p] += 1
                    break

    def chaos_tenant_leak(self) -> None:
        """The ``tenant.page_leak`` drill: an armed 'fail' moves one page
        reference from a claim list of one tenant into one of another.
        No refcount changes, so :meth:`audit` stays clean by
        construction and only ``serving/fleet/accounting.py::
        audit_tenants`` can catch it. A no-op on a pool holding claims
        of fewer than two tenants."""
        try:
            fp.fault_point("tenant.page_leak")
        except fp.InjectedFault:
            from ...serving.fleet import accounting as acc   # lazy: leaf
            with self._lock:
                by_tenant: Dict[str, List[object]] = {}
                for owner in self._claims:
                    t = acc.tenant_of_owner(owner)
                    if t:
                        by_tenant.setdefault(t, []).append(owner)
                tenants = sorted(by_tenant)
                for src_t in tenants:
                    src = next((o for o in by_tenant[src_t]
                                if self._claims[o]), None)
                    dst_t = next((t for t in tenants if t != src_t), None)
                    if src is None or dst_t is None:
                        continue
                    dst = by_tenant[dst_t][0]
                    self._claims[dst].append(self._claims[src].pop())
                    return


# ---------------------------------------------------------------------------
# device-side pool ops
# ---------------------------------------------------------------------------

def _insert_slots(page_table: torch.Tensor, row_pos: torch.Tensor,
                  page_len: int):
    """(active [R] bool, page [R] long, offset [R] long) of each row's
    write: an active row's position is clamped into its table span (a
    multi-step round can step a row past its cap before the host cuts
    it), an idle row (pos < 0) writes page 0 offset 0."""
    mp = page_table.shape[1]
    pos = row_pos.to(torch.long)
    active = pos >= 0
    posc = torch.where(active, pos.clamp(max=mp * page_len - 1),
                       torch.zeros_like(pos))
    slot = posc // page_len
    page = page_table.to(torch.long).gather(1, slot[:, None])[:, 0]
    page = torch.where(active, page, torch.zeros_like(page))
    off = torch.where(active, posc % page_len, torch.zeros_like(posc))
    return active, page, off


def pool_insert(pool_k: torch.Tensor, pool_v: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor,
                page_table: torch.Tensor, row_pos: torch.Tensor) -> None:
    """Write each row's new-token K/V [R,H,1,Dh] into its page at
    ``row_pos``, IN PLACE on the pools. An idle row (``row_pos < 0``)
    writes a ZERO payload to trash page 0 offset 0, so colliding idle
    writes store identical values."""
    active, page, off = _insert_slots(page_table, row_pos, pool_k.shape[2])
    keep = active[:, None, None]
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        payload = new[:, :, 0, :].to(pool.dtype)
        payload = torch.where(keep, payload, torch.zeros_like(payload))
        pool[page, :, off, :] = payload


def pool_fork_partial(pool_k: torch.Tensor, pool_v: torch.Tensor,
                      src_pages: torch.Tensor,
                      dst_pages: torch.Tensor) -> None:
    """Copy-on-write fork of PARTIAL pages, IN PLACE: ``pool[dst] =
    pool[src]`` for each (src, dst) pair, the one content copy a beam
    reorder pays per diverging hypothesis (H x page_len x Dh elements,
    against the dense reorder's H x L x Dh). Pairs ``(0, 0)`` rewrite the
    trash page with its own content (no-ops), so callers may pad the
    pairs to a bucket. The sources are gathered before any write."""
    src = src_pages.to(device=pool_k.device, dtype=torch.long)
    dst = dst_pages.to(device=pool_k.device, dtype=torch.long)
    for pool in (pool_k, pool_v):
        pool[dst] = pool[src]


def beam_table_reorder(page_table: torch.Tensor, parent: torch.Tensor,
                       write_slot: torch.Tensor, fresh_page: torch.Tensor,
                       needs_fresh: torch.Tensor,
                       frozen: torch.Tensor) -> torch.Tensor:
    """The beam reorder's page-table half as int32 table math on the
    device (no host sync): each row takes its ``parent`` row's table, a
    row that diverges (``needs_fresh``: a page boundary, or a child that
    is not its parent's keeper and forks the partial page) has its
    ``write_slot`` entry repointed at its preclaimed ``fresh_page``, and a
    ``frozen`` row (a hypothesis that emitted EOS) is zeroed. Refcounts
    stay on the host, which applies the round's final table as
    ``retable`` diffs. A ``write_slot`` past the table repoints nothing."""
    t = page_table.to(torch.int32)
    new = t[parent.to(torch.long)]
    cols = torch.arange(t.shape[1], dtype=torch.int32, device=t.device)
    hot = (cols[None, :] == write_slot.to(torch.int32)[:, None]) \
        & needs_fresh[:, None]
    new = torch.where(hot, fresh_page.to(torch.int32)[:, None], new)
    return torch.where(frozen[:, None], torch.zeros_like(new), new)


def paged_decode_attention_reference(q, pool_k, pool_v, page_table,
                                     row_pos, scale: Optional[float] = None):
    """Plain version (the reference's ``_reference``): gather each row's
    pages into ``[R, H, MP*page_len, Dh]``, then the dense plain
    version's masked softmax read (positions past ``row_pos`` replaced by
    -1e9), so at equal content it is bitwise the dense
    ``decode_attention_reference``. Reads the pools after the insert."""
    r, mp = page_table.shape
    _, h, page_len, dh = pool_k.shape
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    table = page_table.to(torch.long)

    def gather(pool):
        g = pool[table]                               # [R, MP, H, PL, Dh]
        return g.transpose(1, 2).reshape(r, h, mp * page_len, dh)

    k_full, v_full = gather(pool_k), gather(pool_v)
    s = torch.einsum("rhqd,rhkd->rhqk", q.float(), k_full.float()) * scale
    steps = torch.arange(mp * page_len, device=q.device)[None, None, None, :]
    pos = row_pos.to(device=q.device, dtype=torch.long)
    s = torch.where(steps <= pos[:, None, None, None], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("rhqk,rhkd->rhqd", w, v_full.float()).to(q.dtype)


def paged_route(r: int, h: int, dh: int, itemsize: int, page_len: int,
                mp: int, aligned: bool = True,
                sms: int = H100_SMS) -> Tuple[int, int, int]:
    """(lanes a key, vectors a lane, chunk buffers) of the vector kernel
    for a read of ``r`` rows and ``h`` heads over pools of ``dh``-element
    rows of ``itemsize`` bytes, pages of ``page_len`` and tables of
    ``mp`` pages; (0, 0, 0) takes the scalar kernel. The vector kernel
    takes rows of whole 16-byte vectors in 16-byte aligned pools
    (``vector_path``), Dh <= 256, a page length that divides its chunk
    (``vector_layout``) or is divided by it, and a table that fits in
    shared memory beside the chunk buffers. It keeps 4 chunk buffers (3
    chunks in flight) where the read has fewer than two blocks for each
    of the card's ``sms`` SMs, else 2."""
    if dh > 256 or not vector_path(dh, itemsize, aligned):
        return 0, 0, 0
    lanes, per_lane, chunk = vector_layout(dh, itemsize)
    if chunk % page_len and page_len % chunk:
        return 0, 0, 0
    stages = 4 if r * h < 2 * sms else 2
    if 2 * stages * chunk * dh * itemsize + 4 * mp > _MAX_SMEM:
        return 0, 0, 0
    return lanes, per_lane, stages


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("paged_decode_attention").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_read(q: torch.Tensor, pool_k: torch.Tensor,
                                pool_v: torch.Tensor,
                                page_table: torch.Tensor,
                                row_pos: torch.Tensor,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The kernel alone: the attention read over pools that already hold
    this step's token, for CUDA tensors (the plain version with the same
    signature is ``paged_decode_attention_reference``). q [R,H,1,Dh];
    pools [n_pages,H,page_len,Dh] float32 or bfloat16; page_table [R,MP]
    and row_pos [R] int32. Returns the context [R,H,1,Dh] in q's dtype.
    """
    r, h, _, dh = q.shape
    n_pages, _, page_len, _ = pool_k.shape
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if q.requires_grad:
        raise RuntimeError("paged_decode_attention has no backward")
    for name, t, shape in (("pool_k", pool_k, (n_pages, h, page_len, dh)),
                           ("pool_v", pool_v, (n_pages, h, page_len, dh)),
                           ("page_table", page_table, (r, mp)),
                           ("row_pos", row_pos, (r,))):
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {q.device}")
    if q.dtype not in _DTYPES or pool_k.dtype not in _DTYPES \
            or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_decode_attention takes float32/bfloat16 q "
                        f"and pools of one dtype, got {q.dtype} and "
                        f"{pool_k.dtype}/{pool_v.dtype}")
    if page_table.dtype != torch.int32 or row_pos.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and row_pos "
                        "must be int32")
    q, pool_k, pool_v = q.contiguous(), pool_k.contiguous(), \
        pool_v.contiguous()
    page_table, row_pos = page_table.contiguous(), row_pos.contiguous()
    out = torch.empty_like(q)
    kernel = _kernel()
    route = paged_route(
        r, h, dh, pool_k.element_size(), page_len, mp,
        pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
        _sms(q.device.index))
    err = kernel(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), row_pos.data_ptr(), out.data_ptr(), r, h,
        page_len, dh, mp, float(scale), _DTYPES[q.dtype],
        _DTYPES[pool_k.dtype], *route,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    return out


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, page_table: torch.Tensor,
                           row_pos: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One paged decode-attention step.

    q/k_new/v_new [R,H,1,Dh]; pools [n_pages,H,page_len,Dh] (contiguous,
    written in place); page_table [R,MP] int; row_pos [R] int (< 0 = idle
    row, whose output is deterministic garbage the caller drops). Inserts
    this step's K/V into the pools in place, then reads. Returns the
    context [R,H,1,Dh] in q's dtype.
    """
    r, h, _, dh = q.shape
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    if not q.is_cuda:
        pool_insert(pool_k, pool_v, k_new, v_new, page_table, row_pos)
        return paged_decode_attention_reference(q, pool_k, pool_v,
                                                page_table, row_pos, scale)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (r, h, 1, dh) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected q's {(r, h, 1, dh)} {q.dtype} on "
                             f"{q.device}")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("paged_decode_attention: the pools are updated in "
                         "place and must be contiguous")
    table = page_table.to(torch.int32)
    pos = row_pos.to(torch.int32)
    pool_insert(pool_k, pool_v, k_new, v_new, table, pos)
    # the insert and the launch share the current stream: the kernel
    # reads the pools after this step's write
    out = paged_decode_attention_read(q, pool_k, pool_v, table, pos, scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
