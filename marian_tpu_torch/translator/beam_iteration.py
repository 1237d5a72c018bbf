"""Beam search at iteration level over copy-on-write pages, the port of
``marian_tpu/translator/beam_iteration.py`` (``PagedBeamEngine`` with the
HOST merge; the fused on-device merge, sampling, ``cow=False``, n-best,
the prefix cache and the decode-feature plane are not ported).

The dense beam search (translator/beam_search.py) reorders every cache
row every step. Here each HYPOTHESIS owns a page-table row instead, and
the reorder becomes host bookkeeping over the pool's refcounts
(ops/kernels/kv_pool.py):

- FULL pages are append-only, hence shareable: a child hypothesis
  aliases its parent's full pages (refcount + 1), no bytes move;
- only the PARTIAL page needs an owner per hypothesis: a fork copies it
  once (``pool_fork_partial``, H x page_len x Dh elements against the
  dense reorder's H x L x Dh), and a child that is its parent's only
  successor keeps the parent's partial page in place;
- ``paged_decode_attention`` reads every row through its own table row,
  so a hypothesis is just a table row: the kernel is the greedy one.

Decode semantics are the dense beam search's: per-row ``log_softmax`` in
f32, UNK suppression, the cumulative score, ``score / len^alpha - wp *
len`` ranking, one live beam at t=0 (the NEG_INF score init), finished
hypotheses frozen as {EOS: 0.0} candidates. The device takes each row's
top k of ``score + logp`` (``topk_rows``: ties to the lower index); the
host merges a sentence's k x k candidates as the dense flat top-k ranks
them (value descending, flat index ascending), since the flat top k can
take at most k entries from one row. A frozen hypothesis holds no device
row: its one viable candidate is (EOS, score), and it releases its page
references the step it freezes.

A sentence claims an aligned block of ``beam_size`` slots at join and
holds them to its end (hypothesis ``dense_pos`` j at row ``base + j``);
pages are claimed lazily at page boundaries and forks. If the pool runs
dry mid-decode the whole sentence is evicted (``StepResult.pool_evicted``,
which the scheduler answers with ``!!SERVER-RETRY``): admission prices a
sentence at one trunk plus k-1 partial pages (``pages_for_text``), not at
k full copies. Rounds are one step each: the merge needs the host
between steps.

Threading and determinism as translator/iteration.py; the audit adds the
copy-on-write invariant: every live row's write page has refcount 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.vocab import EOS_ID, UNK_ID
from ..models.transformer import fork_paged_rows
from ..ops.kernels.kv_pool import (PoolExhausted, bucket_rows,
                                   pages_for_tokens, pool_fork_partial)
from .beam_search import NEG_INF, topk_rows
from .iteration import PagedDecodeEngine, StepResult, _Slot


class _Hyp:
    """One beam hypothesis: ``tokens`` (EOS included when it finished on
    EOS), the cumulative log-prob ``score`` (np.float32), ``length``,
    ``dense_pos`` (its beam position in the dense search: the flat-index
    tie-break needs it) and ``slot`` (None once frozen: the hypothesis
    left the device and freed its pages)."""

    __slots__ = ("tokens", "score", "length", "finished", "dense_pos",
                 "slot")

    def __init__(self, tokens, score, length, finished, dense_pos, slot):
        self.tokens = tokens
        self.score = score
        self.length = length
        self.finished = finished
        self.dense_pos = dense_pos
        self.slot = slot


class _Sent:
    """One decoding sentence: k hypotheses over its k claimed slots."""

    __slots__ = ("key", "slots", "hyps", "t", "cap")

    def __init__(self, key, slots, hyps, cap):
        self.key = key
        self.slots = slots
        self.hyps = hyps
        self.t = 0                  # decode steps taken (= live-row pos)
        self.cap = cap


class PagedBeamEngine(PagedDecodeEngine):
    """Slot-based continuous copy-on-write beam decoder over a paged KV
    pool, with the host merge (the reference's ``merge="host"``): the
    greedy engine's admit_and_step/evict/audit surface, with
    ``free_slots`` in sentences of ``beam_size`` slots."""

    def __init__(self, model, params, src_vocab, trg_vocab,
                 beam_size: int = 6, normalize: float = 0.6,
                 word_penalty: float = 0.0, allow_unk: bool = False, **kw):
        if int(kw.get("steps_per_round", 1) or 1) > 1:
            raise ValueError("the host merge runs one step a round "
                             "(steps_per_round 1)")
        self.slots_per_sentence = int(beam_size)
        super().__init__(model, params, src_vocab, trg_vocab, **kw)
        k = self.beam_size = int(beam_size)
        if k < 1 or k > self.max_rows or k > len(trg_vocab):
            raise ValueError(f"beam_size {k} must be in [1, max_rows "
                             f"{self.max_rows}] and at most the target "
                             f"vocabulary")
        # row buckets in whole sentences: block buckets times k
        n_blocks = self.max_rows // k
        self.row_buckets = tuple(sorted(
            {min(b, n_blocks) * k for b in self.row_buckets}))
        self.normalize = float(normalize)
        self.word_penalty = float(word_penalty)
        self.allow_unk = bool(allow_unk)
        self._sents: Dict[object, _Sent] = {}
        # per-row device inputs; pos -1 = a row idled by a frozen
        # hypothesis (its slot stays with the sentence)
        self._slot_pos: List[int] = [-1] * self.max_rows
        self._slot_prev: List[int] = [0] * self.max_rows
        self._slot_score: List[float] = [0.0] * self.max_rows
        # (slot 0 of a joined sentence, its other slots): the encoder
        # rows to replicate after the install (one encode a sentence)
        self._pending_replicate: List[Tuple[int, List[int]]] = []
        self.counters.update({"forks": 0, "copied_pages": 0,
                              "pool_evictions": 0})

    # -- capacity -----------------------------------------------------------
    def pages_for_text(self, text: str) -> int:
        """Admission's price of a sentence: the pages of one trunk (the
        hypotheses' common history) plus one partial page per extra beam.
        An estimate, not a worst case: divergent lineages claim their
        own pages lazily, and a dry pool evicts the sentence retriably."""
        return super().pages_for_text(text) + (self.beam_size - 1)

    @staticmethod
    def _owner(key, slot: int):
        return (key, slot)

    # -- join ---------------------------------------------------------------
    def _try_claim(self, key, text: str, joiners: List,
                   detail: Dict[object, str]) -> Optional[str]:
        k = self.beam_size
        ids = self.src_vocab.encode(text, add_eos=True)
        if len(ids) > self.src_cap:
            detail[key] = (f"source encodes to {len(ids)} tokens but the "
                           f"engine's source cap is {self.src_cap} (raise "
                           f"--max-length)")
            return "src_too_long"
        cap = self.decode_cap(len(ids))
        n_pages = pages_for_tokens(cap, self.page_len)
        if n_pages > self.pool.max_pages_per_row:
            detail[key] = (f"decode cap {cap} tokens needs {n_pages} KV "
                           f"pages of {self.page_len} tokens per hypothesis "
                           f"but the page table holds "
                           f"{self.pool.max_pages_per_row}/row (raise "
                           f"--kv-page-len or --kv-pool-bytes)")
            return "too_large"
        base = self._free_block()
        if base is None:
            return "no_slot"
        slots = list(range(base, base + k))
        # one partial page per hypothesis row, all or nothing
        claimed = []
        try:
            for slot in slots:
                owner = self._owner(key, slot)
                claimed.append((owner, self.pool.claim(owner, 1)))
        except PoolExhausted:
            for owner, _ in claimed:
                self.pool.release(owner)
            if n_pages + k - 1 > self.pool.usable_pages:
                detail[key] = (f"beam-{k} decode at cap {cap} needs at "
                               f"least {n_pages + k - 1} KV pages but the "
                               f"whole pool holds only "
                               f"{self.pool.usable_pages} (raise "
                               f"--kv-pool-bytes or lower --max-length)")
                return "too_large"
            return "no_pages"
        hyps = []
        for j, ((_, pages), slot) in enumerate(zip(claimed, slots)):
            self._slots[slot] = _Slot(key, cap, expected_refs=1)
            self._slot_pos[slot] = 0
            self._slot_prev[slot] = 0
            # one live beam at t=0: the dense search's score init
            s0 = 0.0 if j == 0 else NEG_INF
            self._slot_score[slot] = s0
            hyps.append(_Hyp([], np.float32(s0), 0, False, j, slot))
            self._table[slot, :] = 0
            self._table[slot, 0] = pages[0]
        self._n_active += k
        self._by_key[key] = slots[0]
        self._sents[key] = _Sent(key, slots, hyps, cap)
        # one encoder pass a sentence (slot 0); the other rows copy its
        # cross K/V and mask after the install, so a fork never copies
        # them
        joiners.append((key, ids, slots[0]))
        if k > 1:
            self._pending_replicate.append((slots[0], slots[1:]))
        return None

    def _install(self, joiners) -> None:
        super()._install(joiners)
        reps, self._pending_replicate = self._pending_replicate, []
        if reps:
            src = [s0 for s0, rest in reps for _ in rest]
            dst = [d for _, rest in reps for d in rest]
            fork_paged_rows(
                self._state, self._src_mask,
                torch.tensor(src, dtype=torch.long, device=self.device),
                torch.tensor(dst, dtype=torch.long, device=self.device))

    # -- leave --------------------------------------------------------------
    def _evict(self, key) -> bool:
        sent = self._sents.pop(key, None)
        if sent is None:
            return False
        self._by_key.pop(key, None)
        for slot in sent.slots:
            self._release_row(sent.key, slot)
            self._slots[slot] = None
        self._n_active -= len(sent.slots)
        return True

    def _release_row(self, key, slot: int) -> None:
        """Idle a row: drop its page references and its device inputs
        (the slot stays with its sentence until the sentence leaves)."""
        self.pool.retable(self._owner(key, slot), [])
        self._table[slot, :] = 0
        st = self._slots[slot]
        st.pos = 0
        st.expected_refs = 0
        self._slot_pos[slot] = -1
        self._slot_prev[slot] = 0
        self._slot_score[slot] = 0.0

    # -- the round ----------------------------------------------------------
    def _step(self, res: StepResult) -> None:
        """One step over the occupied slot prefix: the device takes each
        row's top k of ``score + logp``; the host merges each sentence's
        candidates, reorders its rows over shared pages and forks the
        diverging partial pages in one call per layer."""
        top = max(i for i, s in enumerate(self._slots) if s is not None)
        rb = bucket_rows(top + 1, self.row_buckets)
        pos_np = np.full((rb,), -1, np.int32)
        prev_np = np.zeros((rb, 1), np.int64)
        score_np = np.zeros((rb,), np.float32)
        live_rows = 0
        for i in range(rb):
            if self._slot_pos[i] >= 0:
                pos_np[i] = self._slot_pos[i]
                prev_np[i, 0] = self._slot_prev[i]
                score_np[i] = self._slot_score[i]
                live_rows += 1
        sub, src_mask = self._step_state(rb)
        sub["pos"] = torch.from_numpy(pos_np).to(self.device)
        prev = torch.from_numpy(prev_np).to(self.device)
        logits, _ = self.model.step(self.params, sub, prev, src_mask)
        # the dense search's per-row values: f32 log-softmax, UNK
        # suppressed, then the f32 cumulative add
        lp = torch.log_softmax(logits.float(), dim=-1)
        if not self.allow_unk:
            lp[:, UNK_ID] = NEG_INF
        score = torch.from_numpy(score_np).to(self.device)
        vals, idx = topk_rows(score[:, None] + lp, self.beam_size)
        # the host sync of the round: the merge runs on the host
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        fork_src: List[int] = []
        fork_dst: List[int] = []
        finished: List[Tuple[_Sent, _Hyp]] = []
        for key in list(self._sents):
            sent = self._sents[key]
            try:
                done = self._merge_sentence(sent, vals, idx, fork_src,
                                            fork_dst)
            except PoolExhausted:
                # a lazy claim found the pool dry: the whole sentence
                # leaves, retriably
                res.pool_evicted.append(key)
                self.counters["pool_evictions"] += 1
                self._evict(key)
                continue
            if done is not None:
                finished.append((sent, done))
        if fork_src:
            # after this step's pool_insert, on the same stream
            src = torch.tensor(fork_src, dtype=torch.long,
                               device=self.device)
            dst = torch.tensor(fork_dst, dtype=torch.long,
                               device=self.device)
            for kk in self._keys[1]:
                if kk.endswith("_pool_k"):
                    pool_fork_partial(self._state[kk],
                                      self._state[kk[:-1] + "v"], src, dst)
            self.counters["copied_pages"] += len(fork_src)
        for sent, best in finished:
            self._finish(res, sent.key, self._crop(best), {
                "score": float(best.score),
                "norm_score": float(self._norm_score(best)),
                "length": int(best.length), "tokens": list(best.tokens)})
        res.rows = live_rows
        res.steps += 1

    def _merge_sentence(self, sent: _Sent, vals, idx, fork_src: List[int],
                        fork_dst: List[int]) -> Optional[_Hyp]:
        """The host half of one beam step for one sentence: merge the k x
        k candidates as the dense flat top-k ranks them, freeze EOS
        children, then express the reorder as page aliases plus partial
        page forks. Returns the best hypothesis when the sentence
        finished (all frozen, or the cap reached)."""
        k = self.beam_size
        vocab = len(self.trg_vocab)
        cands = []
        for h in sent.hyps:
            if h.finished:
                # the frozen {EOS: 0.0} candidate: the f32 add of 0.0
                cands.append((np.float32(h.score),
                              h.dense_pos * vocab + EOS_ID, EOS_ID, h))
            else:
                for j in range(k):
                    tok = int(idx[h.slot, j])
                    cands.append((vals[h.slot, j],
                                  h.dense_pos * vocab + tok, tok, h))
        cands.sort(key=lambda c: (-c[0], c[1]))
        children: List[_Hyp] = []
        for dense_pos, (val, _flat, tok, parent) in enumerate(cands[:k]):
            if parent.finished:
                children.append(_Hyp(parent.tokens, parent.score,
                                     parent.length, True, dense_pos, None))
            else:
                fin = tok == EOS_ID
                # an EOS child leaves the device now: no slot; its
                # parent's pages free unless a live sibling keeps them
                children.append(_Hyp(parent.tokens + [tok],
                                     np.float32(val), sent.t + 1, fin,
                                     dense_pos,
                                     None if fin else parent.slot))
        next_pos = sent.t + 1
        sent.hyps = children
        sent.t = next_pos
        live = [c for c in children if not c.finished]
        if not live or next_pos >= sent.cap:
            # unfinished hypotheses at the cap score at length = cap
            for c in live:
                c.length = sent.cap
                c.slot = None
            return self._best_hyp(sent)
        # --- the copy-on-write reorder ----------------------------------
        n_full = next_pos // self.page_len
        has_partial = next_pos % self.page_len != 0
        old = {slot: self.pool.pages_of(self._owner(sent.key, slot))
               for slot in sent.slots}
        # the lowest-dense_pos child of each parent KEEPS the parent's
        # partial page; the others fork it (at a page boundary every
        # live child starts a fresh page, and nothing is copied)
        keeper: Dict[int, _Hyp] = {}
        forkers: List[Tuple[_Hyp, int]] = []
        for c in live:
            if c.slot not in keeper:
                keeper[c.slot] = c
            else:
                forkers.append((c, c.slot))
        n_fresh = len(forkers) if has_partial else len(live)
        # hold every page an old row references, then claim the fresh
        # ones, so no retable below frees an alias (or a fork's copy
        # source) before its new reference lands
        tmp = ("cow", sent.key)
        self.pool.share(tmp, [p for s in sent.slots for p in old[s]],
                        row_cap=False)
        try:
            fresh = (self.pool.claim_extra(tmp, n_fresh, row_cap=False)
                     if n_fresh else [])
        except PoolExhausted:
            self.pool.release(tmp)
            raise
        fi = 0
        new_tables: Dict[int, List[int]] = {}
        for pslot, c in keeper.items():
            row = list(old[pslot])
            if not has_partial:
                row.append(fresh[fi])
                fi += 1
            # children land on dense-aligned rows: child j at slots[j]
            c.slot = sent.slots[c.dense_pos]
            new_tables[c.slot] = row
        for c, pslot in forkers:
            row = list(old[pslot][:n_full]) + [fresh[fi]]
            if has_partial:
                fork_src.append(old[pslot][n_full])
                fork_dst.append(fresh[fi])
            fi += 1
            c.slot = sent.slots[c.dense_pos]
            new_tables[c.slot] = row
        # retable every slot in ascending order: increfs the new rows,
        # decrefs the old, frees dead lineages' pages
        for slot in sent.slots:
            row = new_tables.get(slot)
            if row is None:
                self._release_row(sent.key, slot)
                continue
            self.pool.retable(self._owner(sent.key, slot), row)
            self._table[slot, :] = 0
            self._table[slot, :len(row)] = row
            st = self._slots[slot]
            st.pos = next_pos
            st.expected_refs = len(row)
            self._slot_pos[slot] = next_pos
        self.pool.release(tmp)
        self.counters["forks"] += len(forkers)
        for c in live:
            self._slot_prev[c.slot] = c.tokens[-1]
            self._slot_score[c.slot] = float(c.score)
        return None

    # -- scoring (the dense search's collect math, in np.float32) -----------
    def _norm_score(self, h: _Hyp) -> np.float32:
        ln = np.float32(h.length)
        norm = (np.power(ln, np.float32(self.normalize))
                if self.normalize > 0 else np.float32(1.0))
        return np.float32(h.score / norm
                          - np.float32(self.word_penalty) * ln)

    def _best_hyp(self, sent: _Sent) -> _Hyp:
        scores = np.array([self._norm_score(h) for h in sent.hyps],
                          np.float32)
        return sent.hyps[int(np.argsort(-scores, kind="stable")[0])]

    @staticmethod
    def _crop(h: _Hyp) -> List[int]:
        toks = list(h.tokens[:h.length])
        if toks and toks[-1] == EOS_ID:
            toks = toks[:-1]
        return toks

    # -- audit --------------------------------------------------------------
    def audit(self, context: str = "quiesce") -> List[str]:
        """The pool's refcount audit plus the beam invariants: sentences,
        slots and claims agree, every table row mirrors its claim, and
        every live row's WRITE page has refcount 1 (a shared page taking
        a write would corrupt every hypothesis aliasing it)."""
        v = self.pool.audit()
        refs = self.pool.refcounts()
        occupied = sum(len(s.slots) for s in self._sents.values())
        if self._n_active != occupied:
            v.append(f"active-row counter {self._n_active} != {occupied} "
                     f"slots held by sentences")
        owners = set()
        for key, s in self._sents.items():
            for slot in s.slots:
                owners.add(self._owner(key, slot))
                pages = self.pool.pages_of(self._owner(key, slot))
                row = self._table[slot]
                if list(row[:len(pages)]) != pages \
                        or any(int(p) != 0 for p in row[len(pages):]):
                    v.append(f"slot {slot} page-table row does not match "
                             f"its claim (table corruption)")
                if self._slot_pos[slot] >= 0:
                    if not pages:
                        v.append(f"live row {slot} holds no pages")
                    elif refs.get(pages[-1], 0) != 1:
                        v.append(f"live row {slot} write-target page "
                                 f"{pages[-1]} has refcount "
                                 f"{refs.get(pages[-1], 0)} (copy on "
                                 f"write: partial pages must be "
                                 f"exclusive)")
            live = sum(1 for h in s.hyps if h.slot is not None)
            dev_live = sum(1 for slot in s.slots
                           if self._slot_pos[slot] >= 0)
            if live != dev_live:
                v.append(f"sentence {key!r}: {live} live hypotheses vs "
                         f"{dev_live} live device rows")
        for owner in self.pool.owners():
            if owner not in owners:
                v.append(f"pool claim for {owner!r} matches no sentence "
                         f"slot (pages leaked at exit)")
        self.counters["audits"] += 1
        if v:
            self._report_audit(v, context)
        return v
