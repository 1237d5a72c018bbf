"""Beam search at iteration level over copy-on-write pages, the port of
``marian_tpu/translator/beam_iteration.py`` (``PagedBeamEngine`` with the
fused on-device merge, the default, the host merge, the prefix cache's
replays, ``cow=False`` and the decode-feature plane).

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
k full copies. A host-merge round is one step: the merge needs the host
between steps.

The FUSED merge (``merge="fused"``, the default) moves the merge to the
device, so a round runs ``steps_per_round`` steps with one host sync.
Because a sentence sits in a k-aligned block, ``fused_merge`` takes the
dense flat top-k over every sentence's k x W candidates at once, exactly
(ties by flat index, through int64 keys). The page work rides along as
table math (``beam_table_reorder``): keepers keep their parent's partial
page, diverging children fork it (``pool_fork_partial``) into pages the
host PRECLAIMED for the round's worst case, and EOS freezes by mask.
After the round's one copy to the host, the host replays each step's
(lane, token, value) into the hypotheses and applies the final table as
``retable`` diffs: refcounts stay on the host, the loop allocates and
frees nothing. When the worst-case preclaim does not fit the pool, the
round falls back to one host-merge step with lazy claims (same output).

With a ``PrefixCache`` a finished sentence's best text is remembered
(pageless) and an exact repeat replays it at join; the beam engine has
no live fork, as in the reference.

The decode-feature plane (``features``, translator/decode_features.py)
rides both merges. A sentence's rows share its shortlist (the merge
ranks in its coordinates, EOS at coordinate 0, the tokens map back
through it; UNK is suppressed only without one) and its forced trunk
(every token but the forced one NEG_INF, the forced one at its true
log-prob); the fused merge uploads them once a round, [rows, K] and
[steps, rows], and stays free of host syncs. Sampling
(``--output-sampling``) makes every hypothesis an independent
trajectory on its own lane from score 0, with no reorder: it runs on the
host merge, as ``cow=False`` (the replication baseline: every child
copies its whole history into fresh pages, bit-identical output) does.
``--n-best`` formats the finished sentence's ranked hypotheses through
the plane's printer, and a streaming sentence reports its best
hypothesis so far every round.

Threading and determinism as translator/iteration.py; the audit adds the
copy-on-write invariant: every live row's write page has refcount 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import faultpoints as fp
from ..data.vocab import EOS_ID, UNK_ID
from ..models.transformer import fork_paged_rows
from ..ops.kernels.kv_pool import (PoolExhausted, beam_table_reorder,
                                   bucket_rows, pages_for_tokens,
                                   pool_fork_partial)
from .beam_search import (NEG_INF, gumbel_noise, sample_pick,
                          sampling_params, topk_rows)
from .iteration import PagedDecodeEngine, StepResult, _Slot

_LOW32 = (1 << 32) - 1


def exact_topk(x: torch.Tensor, k: int, index: torch.Tensor = None):
    """Top k of each row of f32 ``x`` [N, M] in the order
    ``jax.lax.top_k`` gives (value descending in the f32 total order,
    which puts +0.0 above -0.0; equal values to the lower index), with
    no host sync (``torch.topk`` promises no order for ties): each value
    becomes a unique int64 key, its order-preserving int32 image above
    the complement of its index (``index`` [N, M], unique in a row and
    below 2^32, or the column). Returns (values [N, k], the chosen
    columns [N, k])."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    if index is None:
        index = torch.arange(x.shape[-1], dtype=torch.int64,
                             device=x.device)
    keys = ordered.to(torch.int64) * (1 << 32) + (_LOW32 - index)
    top = torch.topk(keys, k, dim=-1).indices
    return x.gather(-1, top), top


def fused_merge(lp: torch.Tensor, score: torch.Tensor, fin: torch.Tensor,
                k: int, eos_flat: int):
    """The dense beam search's flat top-k over every sentence at once.

    ``lp`` [R, W] per-row log-probs (R = nb * k rows, k-aligned blocks),
    ``score`` [R] cumulative path scores, ``fin`` [R] frozen markers. A
    live row offers the f32 candidates ``score + lp``; a frozen row one
    {EOS: score} candidate at coordinate ``eos_flat`` and NEG_INF
    elsewhere. Each block's [k * W] grid is ranked value descending,
    flat index ascending (``exact_topk``), the dense tie-break, so the
    merge holds through ties (NEG_INF saturates f32), bit for bit the
    reference's ``fused_merge``. A block's top k takes at most k entries
    from one row, the row's own first k in the same order, so each row's
    top k is taken first and the block ranks its k x k of them.

    Returns ([nb, k] values, [nb, k] parent lanes, [nb, k] coordinates).
    """
    rows, width = lp.shape
    nb = rows // k
    coords = torch.arange(width, device=lp.device)
    eos_cand = torch.where(coords[None, :] == eos_flat, score[:, None],
                           NEG_INF)
    comb = torch.where(fin[:, None], eos_cand, score[:, None] + lp)
    kr = min(k, width)
    row_vals, row_coords = exact_topk(comb, kr)
    lanes = torch.arange(rows, device=lp.device) % k
    flat = (lanes[:, None] * width + row_coords).reshape(nb, k * kr)
    vals, pick = exact_topk(row_vals.reshape(nb, k * kr), k, flat)
    flat = flat.gather(1, pick)
    return vals, flat // width, flat % width


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

    __slots__ = ("key", "slots", "hyps", "t", "cap", "src_key", "feat")

    def __init__(self, key, slots, hyps, cap, src_key, feat=None):
        self.key = key
        self.slots = slots
        self.hyps = hyps
        self.t = 0                  # decode steps taken (= live-row pos)
        self.cap = cap
        self.src_key = src_key      # source id tuple (the prefix-cache key)
        self.feat = feat            # RowFeatures (decode_features.py)


class PagedBeamEngine(PagedDecodeEngine):
    """Slot-based continuous copy-on-write beam decoder over a paged KV
    pool: the greedy engine's admit_and_step/evict/audit surface, with
    ``free_slots`` in sentences of ``beam_size`` slots. ``merge`` is
    ``"fused"`` (on the device, ``steps_per_round`` steps a round) or
    ``"host"`` (one step a round: ``steps_per_round`` is clamped to 1)."""

    _SUPPORTS_NBEST = True

    def __init__(self, model, params, src_vocab, trg_vocab,
                 beam_size: int = 6, normalize: float = 0.6,
                 word_penalty: float = 0.0, allow_unk: bool = False,
                 cow: bool = True, merge: str = "fused", **kw):
        merge = str(merge)
        if merge not in ("fused", "host"):
            raise ValueError(f"iteration-beam-merge must be 'fused' or "
                             f"'host', got {merge!r}")
        # the replication baseline and sampling (k trajectories that
        # never merge: no k x k grid to fuse) run on the host merge
        feats = kw.get("features")
        if not cow or (feats is not None and feats.sampling):
            merge = "host"
        if merge == "host":
            kw["steps_per_round"] = 1    # the merge needs the host a step
        # set before the base sizes the pool (_default_pool_pages)
        self.merge = merge
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
        self.cow = bool(cow)
        self._sents: Dict[object, _Sent] = {}
        # per-row device inputs; pos -1 = a row idled by a frozen
        # hypothesis (its slot stays with the sentence)
        self._slot_pos: List[int] = [-1] * self.max_rows
        self._slot_prev: List[int] = [0] * self.max_rows
        self._slot_score: List[float] = [0.0] * self.max_rows
        # (slot 0 of a joined sentence, its other slots): the encoder
        # rows to replicate after the install (one encode a sentence)
        self._pending_replicate: List[Tuple[int, List[int]]] = []
        self.counters.update({"copied_pages": 0, "pool_evictions": 0,
                              "fused_fallback_rounds": 0})

    def _default_pool_pages(self) -> int:
        """A fused engine's unsized pool adds the rounds' preclaim
        headroom, ``max_rows`` x ``steps_per_round`` pages: each fused
        round claims its worst-case fresh pages before it runs (k a
        sentence at a page boundary, else k-1, a step) and gives back
        what it did not use after. Without it a pool of full-cap rows
        would send every round to the host-merge fallback. An explicit
        --kv-pool-bytes overrides it."""
        base = super()._default_pool_pages()
        if self.merge != "fused":
            return base
        return base + self.max_rows * self.steps_per_round

    # -- capacity -----------------------------------------------------------
    def pages_for_text(self, text: str) -> int:
        """Admission's price of a sentence: the pages of one trunk (the
        hypotheses' common history) plus one partial page per extra beam.
        An estimate, not a worst case: divergent lineages claim their
        own pages lazily, and a dry pool evicts the sentence retriably."""
        return super().pages_for_text(text) + (self.beam_size - 1)

    def row_progress(self, key) -> Optional[Tuple[int, int]]:
        """(steps taken, cap) of an active sentence, or None."""
        s = self._sents.get(key)
        return (s.t, s.cap) if s is not None else None

    @staticmethod
    def _owner(key, slot: int):
        return (key, slot)

    # -- join ---------------------------------------------------------------
    def _try_claim(self, key, text: str, joiners: List,
                   res: StepResult, meta: Optional[dict] = None
                   ) -> Optional[str]:
        k = self.beam_size
        detail = res.reject_detail
        got = self._join_features(key, text, res, meta)
        if isinstance(got, str):
            return got
        ids, src_key, cap, feat = got
        # a repeat of a finished sentence replays its remembered best
        if self._replay(key, src_key, res):
            return None
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
        # one partial page per hypothesis row, all or nothing (the first
        # with the prefix cache's pressure relief)
        claimed = []
        try:
            for j, slot in enumerate(slots):
                owner = self._owner(key, slot)
                claimed.append((owner, self._claim_pages(owner, 1) if j == 0
                                else self.pool.claim(owner, 1)))
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
        # sampling: every beam an independent trajectory from score 0
        sampled = bool(self.features is not None and self.features.sampling)
        hyps = []
        for j, ((_, pages), slot) in enumerate(zip(claimed, slots)):
            self._slots[slot] = _Slot(key, cap, expected_refs=1, feat=feat)
            self._slot_pos[slot] = 0
            self._slot_prev[slot] = 0
            # one live beam at t=0: the dense search's score init
            s0 = 0.0 if (j == 0 or sampled) else NEG_INF
            self._slot_score[slot] = s0
            hyps.append(_Hyp([], np.float32(s0), 0, False, j, slot))
            self._table[slot, :] = 0
            self._table[slot, 0] = pages[0]
        self._n_active += k
        self._by_key[key] = slots[0]
        self._sents[key] = _Sent(key, slots, hyps, cap, src_key, feat)
        # one encoder pass a sentence (slot 0); the other rows copy its
        # cross K/V and mask after the install, so a fork never copies
        # them
        joiners.append((key, ids, slots[0]))
        if k > 1:
            self._pending_replicate.append((slots[0], slots[1:]))
        # noise lanes a hypothesis row: the sentence's and k-1 more
        self._row_admitted(k, feat)
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
    def _evict(self, key, adopt_text: Optional[str] = None) -> bool:
        """A sentence leaves: its rows' pages are released. Finished
        (``adopt_text``) with a prefix cache, its best hypothesis is
        remembered for replays."""
        sent = self._sents.pop(key, None)
        if sent is None:
            return False
        self._by_key.pop(key, None)
        for slot in sent.slots:
            self._release_row(sent.key, slot)
            self._slots[slot] = None
        self._n_active -= len(sent.slots)
        if self.prefix is not None and adopt_text is not None:
            self.prefix.remember(self.pool, sent.src_key,
                                 self._crop(self._best_hyp(sent)),
                                 adopt_text)
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
        if self.merge == "fused":
            self._step_fused(res)
        else:
            self._step_host(res)

    def _beam_features(self, rows: int, steps: int) -> dict:
        """The decode-surface inputs of a round over rows [0, rows),
        uploaded once: a sentence's rows share its ``sl`` [rows, K]
        shortlist and ``sl_len`` [rows] true width and its ``forced``
        [steps, rows] trunk tokens (-1: free; from the sentence's t),
        and hypothesis j rides lane ``feat.lane + j`` (``lane`` [rows,
        1]) at its position (``ctr`` [rows, 1]). Idle rows get neutral
        values. Empty without a plane."""
        plane = self.features
        if plane is None:
            return {}
        arrays = {}
        if plane.shortlist_gen is not None:
            arrays["sl"] = np.zeros((rows, plane.k_static), np.int64)
            arrays["sl_len"] = np.full((rows,), plane.k_static, np.int64)
        if plane.sampling:
            arrays["lane"] = np.zeros((rows, 1), np.int64)
            arrays["ctr"] = np.zeros((rows, 1), np.int64)
        if plane.force_decode:
            arrays["forced"] = np.full((steps, rows), -1, np.int64)
        for sent in self._sents.values():
            f = sent.feat
            if f is None:
                continue
            for j, slot in enumerate(sent.slots):
                if slot >= rows:
                    continue
                if "sl" in arrays and f.shortlist is not None:
                    arrays["sl"][slot] = f.shortlist
                    arrays["sl_len"][slot] = f.sl_len
                if "lane" in arrays:
                    arrays["lane"][slot, 0] = f.lane + j
                    arrays["ctr"][slot, 0] = max(self._slot_pos[slot], 0)
                if "forced" in arrays and f.forced:
                    arrays["forced"][:, slot] = [f.forced_at(sent.t + i)
                                                 for i in range(steps)]
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def _row_logp(self, sub, prev, src_mask, feats: dict, j: int = 0):
        """One model step and the dense search's per-row log-probs: the
        f32 log-softmax (past a shortlisted row's true width NEG_INF
        first), UNK suppressed only without a shortlist, and at a forced
        position every token but the forced one NEG_INF (the forced one
        keeps its log-prob). Returns ([rows, W] log-probs, the
        shortlists or None)."""
        sl = feats.get("sl")
        kw = {} if sl is None else {"shortlist": sl}
        logits, _ = self.model.step(self.params, sub, prev, src_mask, **kw)
        lp = torch.log_softmax(self._masked_logits(logits.float(), feats),
                               dim=-1)
        if not self.allow_unk and sl is None:
            lp[:, UNK_ID] = NEG_INF
        if "forced" in feats:
            f = feats["forced"][j]
            coords = torch.arange(lp.shape[-1], device=lp.device)
            keep = (f < 0)[:, None] | (coords[None, :] == f[:, None])
            lp = torch.where(keep, lp, torch.full_like(lp, NEG_INF))
        return lp, sl

    def _step_host(self, res: StepResult) -> None:
        """One HOST-merge step over the occupied slot prefix: the device
        takes each row's top k of ``score + logp`` (a sampled row: its
        drawn token); the host merges each sentence's candidates,
        reorders its rows over shared pages and forks the diverging
        partial pages in one call per layer."""
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
        feats = self._beam_features(rb, 1)
        lp, sl = self._row_logp(sub, prev, src_mask, feats)
        score = torch.from_numpy(score_np).to(self.device)
        sampled = "lane" in feats
        if sampled:
            # k independent gumbel-max trajectories: the drawn token's
            # true log-prob joins the path score
            plane = self.features
            temp, topn = sampling_params(plane.sampling)
            coords = torch.arange(lp.shape[-1], device=self.device)
            tok = sample_pick(lp, gumbel_noise(plane.seed, feats["lane"],
                                               feats["ctr"], coords[None, :]),
                              temp, topn)
            vals = score + lp.gather(1, tok[:, None])[:, 0]
            idx = tok if sl is None else sl.gather(1, tok[:, None])[:, 0]
        else:
            # the f32 cumulative add, each row's top k (coordinates)
            vals, idx = topk_rows(score[:, None] + lp, self.beam_size)
        # the host sync of the round: the merge runs on the host
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        fork_src: List[int] = []
        fork_dst: List[int] = []
        finished: List[Tuple[_Sent, _Hyp]] = []
        for key in list(self._sents):
            sent = self._sents[key]
            try:
                if sampled:
                    done = self._merge_sentence_sampled(sent, vals, idx)
                else:
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
            self._fork_pages(
                torch.tensor(fork_src, dtype=torch.long, device=self.device),
                torch.tensor(fork_dst, dtype=torch.long, device=self.device))
            self.counters["copied_pages"] += len(fork_src)
        self._finish_sentences(res, finished)
        res.rows = live_rows
        res.bucket = rb
        res.tokens = live_rows
        res.steps += 1

    def _fork_pages(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """``pool[dst] = pool[src]`` in every layer's K and V pools."""
        src, dst = src.long(), dst.long()
        for kk in self._keys[1]:
            if kk.endswith("_pool_k"):
                pool_fork_partial(self._state[kk], self._state[kk[:-1] + "v"],
                                  src, dst)

    def _finish_sentences(self, res: StepResult,
                          finished: List[Tuple[_Sent, _Hyp]]) -> None:
        """The round tail of both merges: finished sentences into
        ``res`` (under --n-best their ranked hypotheses through the
        plane's printer, the request-mode block), then a streaming
        sentence's best hypothesis so far (a later round may rerank it:
        beam partials are best-so-far, greedy ones append-only)."""
        plane = self.features
        for sent, best in finished:
            info = {"score": float(best.score),
                    "norm_score": float(self._norm_score(best)),
                    "length": int(best.length), "tokens": list(best.tokens)}
            text = None
            if plane is not None and plane.n_best:
                norms = np.array([self._norm_score(h) for h in sent.hyps],
                                 np.float32)
                info["nbest"] = [
                    {"tokens": list(h.tokens[:h.length]),
                     "score": float(h.score),
                     "norm_score": float(self._norm_score(h))}
                    for h in (sent.hyps[i]
                              for i in np.argsort(-norms, kind="stable"))]
                text = plane.format_nbest(
                    sent.feat.sid if sent.feat is not None else 0,
                    info["nbest"])
            self._finish(res, sent.key, self._crop(best), info, text)
        for sent in self._sents.values():
            if sent.feat is not None and sent.feat.stream:
                res.partials.append((sent.key, self.trg_vocab.decode(
                    self._crop(self._best_hyp(sent)), ignore_eos=True),
                    sent.t))

    def _merge_sentence(self, sent: _Sent, vals, idx, fork_src: List[int],
                        fork_dst: List[int]) -> Optional[_Hyp]:
        """The host half of one beam step for one sentence: merge the k x
        k candidates as the dense flat top-k ranks them, freeze EOS
        children, then express the reorder as page aliases plus partial
        page forks. Returns the best hypothesis when the sentence
        finished (all frozen, or the cap reached)."""
        k = self.beam_size
        # a shortlisted sentence's rows give coordinates: the flat
        # tie-break ranks in them (the dense shortlisted top-k's index
        # space, EOS at coordinate 0) and the tokens map back here
        sl = sent.feat.shortlist if sent.feat is not None else None
        width = self.features.k_static if sl is not None \
            else len(self.trg_vocab)
        eos_flat = 0 if sl is not None else EOS_ID
        cands = []
        for h in sent.hyps:
            if h.finished:
                # the frozen {EOS: 0.0} candidate: the f32 add of 0.0
                cands.append((np.float32(h.score),
                              h.dense_pos * width + eos_flat, EOS_ID, h))
            else:
                for j in range(k):
                    coord = int(idx[h.slot, j])
                    tok = int(sl[coord]) if sl is not None else coord
                    cands.append((vals[h.slot, j],
                                  h.dense_pos * width + coord, tok, h))
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
        # live child starts a fresh page, and nothing is copied). With
        # cow=False every child copies its parent's whole history
        keeper: Dict[int, _Hyp] = {}
        forkers: List[Tuple[_Hyp, int]] = []
        for c in live:
            if self.cow and c.slot not in keeper:
                keeper[c.slot] = c
            else:
                forkers.append((c, c.slot))
        if self.cow:
            n_fresh = len(forkers) if has_partial else len(live)
        else:
            n_fresh = len(live) * (n_full + 1)
        # hold every page an old row references, then claim the fresh
        # ones, so no retable below frees an alias (or a fork's copy
        # source) before its new reference lands
        tmp = ("cow", sent.key)

        def hold_and_claim():
            self.pool.share(tmp, [p for s in sent.slots for p in old[s]],
                            row_cap=False)
            try:
                return (self.pool.claim_extra(tmp, n_fresh, row_cap=False)
                        if n_fresh else [])
            except PoolExhausted:
                self.pool.release(tmp)
                raise
        try:
            fresh = hold_and_claim()
        except PoolExhausted:
            # pressure relief from the prefix cache, then once more
            if self.prefix is None or not self.prefix.evict_for_pages(
                    self.pool, n_fresh):
                raise
            fresh = hold_and_claim()
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
            if self.cow:
                row = list(old[pslot][:n_full]) + [fresh[fi]]
                if has_partial:
                    fork_src.append(old[pslot][n_full])
                    fork_dst.append(fresh[fi])
                fi += 1
            else:
                # the replication baseline: a copy of every history page
                row = []
                for j in range(n_full + 1):
                    row.append(fresh[fi])
                    if j < len(old[pslot]):
                        fork_src.append(old[pslot][j])
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
            self._retable_row(sent.key, slot, row)
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

    def _merge_sentence_sampled(self, sent: _Sent, vals, toks
                                ) -> Optional[_Hyp]:
        """A sampled step for one sentence: k independent trajectories
        (the dense sampled search keeps ``beam_idx`` the identity), so
        nothing reorders and nothing forks: each live row appends its
        drawn token (``toks`` [rb], vocabulary ids) and its new path
        score (``vals`` [rb]) to its own lineage, claiming a page at a
        boundary. Returns the best hypothesis when the sentence
        finished."""
        next_pos = sent.t + 1
        for h in sent.hyps:
            if h.slot is None:
                continue
            slot = h.slot
            tok = int(toks[slot])
            h.tokens = h.tokens + [tok]
            h.score = np.float32(vals[slot])
            h.length = next_pos
            if tok == EOS_ID:
                h.finished = True
                self._release_row(sent.key, slot)
                h.slot = None
                continue
            owner = self._owner(sent.key, slot)
            if next_pos % self.page_len == 0 and next_pos < sent.cap:
                # a fresh page at the boundary (not at the cap, where the
                # row leaves unwritten); a dry pool evicts the sentence
                self.pool.claim_extra(owner, 1)
                pages = self.pool.pages_of(owner)
                self._table[slot, :] = 0
                self._table[slot, :len(pages)] = pages
                self._slots[slot].expected_refs = len(pages)
            self._slots[slot].pos = next_pos
            self._slot_pos[slot] = next_pos
            self._slot_prev[slot] = tok
            self._slot_score[slot] = float(h.score)
        sent.t = next_pos
        live = [h for h in sent.hyps if h.slot is not None]
        if not live or next_pos >= sent.cap:
            for h in live:
                h.length = sent.cap
                h.slot = None
            return self._best_hyp(sent)
        return None

    def _retable_row(self, key, slot: int, row: List[int]) -> None:
        """A row's new page list: the pool's refcounts, then the host
        table mirror the next round uploads."""
        self.pool.retable(self._owner(key, slot), row)
        self._table[slot, :] = 0
        self._table[slot, :len(row)] = row

    # -- the fused round ----------------------------------------------------
    def _round_fresh_counts(self, sent: _Sent) -> List[int]:
        """The worst-case fresh pages of each step of a fused round for
        one sentence: k at a page boundary (every live child starts an
        unwritten page), else k-1 (every child but one forks), none from
        the step that reaches the cap on."""
        k, out = self.beam_size, []
        for j in range(self.steps_per_round):
            npos = sent.t + j + 1
            if npos >= sent.cap:
                break
            out.append(k if npos % self.page_len == 0 else k - 1)
        return out

    def _claim_round_fresh(self, owner, n: int) -> List[int]:
        """A sentence's preclaim for one fused round under the transient
        owner ``("roundfresh", key)``, with the prefix cache's pressure
        relief. No row cap: it spans k rows and several steps."""
        try:
            return self.pool.claim(owner, n, row_cap=False)
        except PoolExhausted:
            if self.prefix is None or not self.prefix.evict_for_pages(
                    self.pool, n):
                raise
            return self.pool.claim(owner, n, row_cap=False)

    def _step_fused(self, res: StepResult) -> None:
        """One fused round: preclaim the worst-case fresh pages, upload
        the rows' inputs once, run ``steps_per_round`` steps on the device
        (model step, ``fused_merge``, keeper/fork masks, the partial-page
        forks, ``beam_table_reorder``, commit masks) with no host sync,
        copy (lanes, tokens, values, table) to the host once, replay the
        steps into the hypotheses and apply the table as retable diffs.
        A preclaim the pool cannot meet sends the round to one host-merge
        step instead (``fused_fallback_rounds``)."""
        k, steps = self.beam_size, self.steps_per_round
        fresh: Dict[object, List[int]] = {}
        for key, sent in self._sents.items():
            try:
                fresh[key] = self._claim_round_fresh(
                    ("roundfresh", key), sum(self._round_fresh_counts(sent)))
            except PoolExhausted:
                # the worst case does not fit, the real demand may: one
                # host-merge step with lazy claims, the same output
                for k2 in fresh:
                    self.pool.release(("roundfresh", k2))
                self.counters["fused_fallback_rounds"] += 1
                self._step_host(res)
                return
        top = max(i for i, s in enumerate(self._slots) if s is not None)
        rows = bucket_rows(top + 1, self.row_buckets)
        nb = rows // k
        pos_np = np.full((rows,), -1, np.int32)
        prev_np = np.zeros((rows, 1), np.int64)
        score_np = np.zeros((rows,), np.float32)
        fin_np = np.zeros((rows,), bool)
        blk_live_np = np.zeros((nb,), bool)
        cap_np = np.zeros((nb,), np.int32)
        fresh_np = np.zeros((steps, rows), np.int32)
        live_rows = 0
        for key, sent in self._sents.items():
            base = sent.slots[0]
            blk_live_np[base // k] = True
            cap_np[base // k] = sent.cap
            for j, h in enumerate(sent.hyps):
                score_np[base + j] = h.score
                if h.finished:
                    fin_np[base + j] = True
                else:
                    pos_np[base + j] = sent.t
                    prev_np[base + j, 0] = h.tokens[-1] if h.tokens else 0
                    live_rows += 1
            fi = 0
            for j, cnt in enumerate(self._round_fresh_counts(sent)):
                # this step's pages densely at the block base, lane order
                fresh_np[j, base:base + cnt] = fresh[key][fi:fi + cnt]
                fi += cnt
        sub, src_mask = self._step_state(rows)
        lanes, toks, vals, table = self._fused_steps(
            sub, src_mask, *(torch.from_numpy(a).to(self.device) for a in (
                prev_np, pos_np, score_np, fin_np, blk_live_np, cap_np,
                fresh_np)), feats=self._beam_features(rows, steps))
        finished: List[Tuple[_Sent, _Hyp]] = []
        for key in list(self._sents):
            sent = self._sents[key]
            best = self._replay_round(sent, lanes[:, sent.slots[0] // k],
                                      toks[:, sent.slots[0] // k],
                                      vals[:, sent.slots[0] // k], res)
            if best is not None:
                self.pool.release(("roundfresh", key))
                finished.append((sent, best))
                continue
            self._apply_round_table(sent, table)
            self.pool.release(("roundfresh", key))
        self._finish_sentences(res, finished)
        res.rows = live_rows
        res.bucket = rows
        res.steps += steps

    def _fused_steps(self, sub, src_mask, prev, pos, score, fin, blk_live,
                     cap, fresh, feats=None):
        """The fused round's device loop over ``rows`` = nb x k rows, with
        no host sync inside (``sync_debug`` checks it). Every committed
        step of a live sentence moves its rows to their children: parent
        lane, token and value from ``fused_merge``, the table from
        ``beam_table_reorder``, forks of the partial page into the step's
        preclaimed pages. A sentence that finishes (every child frozen,
        or its cap) stops committing, and its rows idle at ``pos`` -1, as
        frozen rows do. Returns the host copies of the per-step [steps,
        nb, k] lanes, tokens, values and the final [rows, max_pages]
        table, from ONE device-to-host copy. ``feats``: the round's
        decode-surface inputs (``_beam_features``); under a shortlist
        the merge ranks a block's coordinates and its tokens map back
        through the block's set on the device."""
        k, page_len = self.beam_size, self.page_len
        rows = pos.shape[0]
        nb = rows // k
        mp = self._table.shape[1]
        dev = self.device
        blk_base = torch.arange(nb, device=dev) * k
        lanes_k = torch.arange(k, device=dev)
        earlier = lanes_k[None, None, :] < lanes_k[None, :, None]
        table = sub["page_table"]
        done = ~blk_live

        def per_row(x):
            return x[:, None].expand(nb, k).reshape(rows)
        outs = []
        with self._sync_guard():
            for j in range(fresh.shape[0]):
                sub["pos"] = pos
                sub["page_table"] = table
                # the host path's per-row values; then the f32
                # cumulative add in the merge
                lp, sl = self._row_logp(sub, prev, src_mask, feats or {}, j)
                val, lane, tok = fused_merge(lp, score, fin, k,
                                             EOS_ID if sl is None else 0)
                if sl is not None:
                    tok = sl.view(nb, k, -1)[:, 0, :].gather(1, tok)
                parent = blk_base[:, None] + lane
                fin_c = fin[parent] | (tok == EOS_ID)
                live_c = ~fin_c
                # live rows sit at the sentence's t, frozen rows at -1
                next_pos = pos.view(nb, k).amax(1) + 1
                gate = ~done
                done_now = ((~live_c.any(1)) | (next_pos >= cap)) & gate
                commit = gate & ~done_now
                # the keeper (lowest lane among a parent's live children)
                # keeps the parent's partial page in place
                dup = (lane[:, :, None] == lane[:, None, :]) & earlier \
                    & live_c[:, None, :]
                keeper = live_c & ~dup.any(2)
                boundary = next_pos % page_len == 0
                needs = live_c & (boundary[:, None] | ~keeper)
                fidx = (torch.cumsum(needs.to(torch.int32), 1) - 1).clamp(
                    min=0)
                pg = torch.where(
                    needs, fresh[j].view(nb, k).gather(1, fidx.long()), 0)
                commit_row = per_row(commit)
                next_pos_row = per_row(next_pos)
                write_slot = next_pos_row // page_len
                parent_row = parent.reshape(rows)
                fin_row = fin_c.reshape(rows)
                needs_row = needs.reshape(rows) & commit_row
                pg_row = torch.where(needs_row, pg.reshape(rows), 0)
                # the fork: the parent's partial page (this step's write
                # included) into the child's fresh page, after the step's
                # insert on the same stream; (0, 0) pairs are no-ops
                mid = needs_row & ~per_row(boundary)
                src_pg = table[parent_row].gather(
                    1, write_slot.clamp(max=mp - 1)[:, None].long())[:, 0]
                self._fork_pages(torch.where(mid, src_pg, 0),
                                 torch.where(mid, pg_row, 0))
                new_table = beam_table_reorder(table, parent_row, write_slot,
                                               pg_row, needs_row, fin_row)
                table = torch.where(commit_row[:, None], new_table, table)
                score = torch.where(commit_row, val.reshape(rows), score)
                fin = torch.where(commit_row, fin_row, fin)
                prev = torch.where(commit_row[:, None],
                                   tok.reshape(rows)[:, None], prev)
                # committed live children advance; frozen children and
                # the rows of a sentence that just finished idle at -1
                pos = torch.where(commit_row & ~fin_row, next_pos_row,
                                  torch.where(per_row(gate), -1, pos))
                done = done | done_now
                outs.append((lane, tok, val))
        n = len(outs) * nb * k
        # the round's one host sync: every output in one copy
        flat = torch.cat([
            torch.stack([o[0] for o in outs]).to(torch.int32).reshape(-1),
            torch.stack([o[1] for o in outs]).to(torch.int32).reshape(-1),
            torch.stack([o[2] for o in outs]).view(torch.int32).reshape(-1),
            table.reshape(-1)]).cpu().numpy()
        shape = (len(outs), nb, k)
        return (flat[:n].reshape(shape), flat[n:2 * n].reshape(shape),
                flat[2 * n:3 * n].view(np.float32).reshape(shape),
                flat[3 * n:].reshape(rows, mp))

    def _replay_round(self, sent: _Sent, lanes, toks, vals,
                      res: StepResult) -> Optional[_Hyp]:
        """The host half of a fused round for one sentence: each step's
        [k] (lane, token, value) becomes its children, as the host merge
        makes them (frozen parents stay {EOS: score}; EOS children freeze
        off the device); the live rows a step consumed add to
        ``res.tokens``. Returns the best hypothesis when the sentence
        finished in the round."""
        k = self.beam_size
        base = sent.slots[0]
        for j in range(lanes.shape[0]):
            cur = sent.hyps
            res.tokens += sum(1 for h in cur if not h.finished)
            next_pos = sent.t + 1
            children: List[_Hyp] = []
            live_lanes: List[int] = []
            for i in range(k):
                parent = cur[int(lanes[j, i])]
                if parent.finished:
                    children.append(_Hyp(parent.tokens, parent.score,
                                         parent.length, True, i, None))
                    continue
                tok = int(toks[j, i])
                fin = tok == EOS_ID
                children.append(_Hyp(parent.tokens + [tok],
                                     np.float32(vals[j, i]), next_pos, fin,
                                     i, None if fin else base + i))
                if not fin:
                    live_lanes.append(int(lanes[j, i]))
            sent.hyps = children
            sent.t = next_pos
            if not live_lanes or next_pos >= sent.cap:
                # unfinished hypotheses at the cap score at length = cap
                for c in children:
                    if not c.finished:
                        c.length = sent.cap
                        c.slot = None
                return self._best_hyp(sent)
            # the host merge's ledger: forks, and copies off a boundary
            forkers = len(live_lanes) - len(set(live_lanes))
            self.counters["forks"] += forkers
            if next_pos % self.page_len != 0:
                self.counters["copied_pages"] += forkers
        return None

    def _apply_round_table(self, sent: _Sent, table) -> None:
        """Apply the device's final table to a continuing sentence as
        retable diffs: every page an old row references is held first
        (``("cow", key)``), so no retable frees a page before the row
        that moves onto it takes its reference.

        The ``beam.diff_corrupt`` drill: an armed 'fail' applies one live
        slot's diff truncated by its last page to the pool while the
        table mirror keeps the full row, the bad-device-diff class the
        audit's table/claim check must catch this round."""
        key = sent.key
        tmp = ("cow", key)
        self.pool.share(tmp, list(dict.fromkeys(
            p for slot in sent.slots
            for p in self.pool.pages_of(self._owner(key, slot)))),
            row_cap=False)
        corrupt = False
        try:
            fp.fault_point("beam.diff_corrupt")
        except fp.InjectedFault:
            corrupt = True
        for slot, h in zip(sent.slots, sent.hyps):
            if h.slot is None:
                self._release_row(key, slot)
                continue
            row = [int(p) for p in table[slot]]
            row = row[:row.index(0)] if 0 in row else row
            if corrupt and row:
                # the pool takes the row short of its last page, the
                # table mirror keeps the whole row
                self.pool.retable(self._owner(key, slot), row[:-1])
                self._table[slot, :] = 0
                self._table[slot, :len(row)] = row
                corrupt = False
            else:
                self._retable_row(key, slot, row)
            st = self._slots[slot]
            st.pos = sent.t
            st.expected_refs = len(row)
            self._slot_pos[slot] = sent.t
            self._slot_prev[slot] = h.tokens[-1]
            self._slot_score[slot] = float(h.score)
        self.pool.release(tmp)

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
        owners |= self._cache_owners()
        for owner in self.pool.owners():
            if owner not in owners:
                v.append(f"pool claim for {owner!r} matches no sentence "
                         f"slot (pages leaked at exit)")
        self._note_audit(v, context)
        return v

    # -- /poolz -------------------------------------------------------------
    def _slot_owner(self, slot: int, s):
        return self._owner(s.key, slot)

    def pool_state(self) -> dict:
        """The base page and slot maps plus the beam view: each
        sentence's hypothesis rows and the beam geometry (a slot's
        ``pos`` is its device row's position; an idled row reads 0)."""
        state = super().pool_state()
        sents = [{
            "key": self._owner_label(s.key),
            "trace_id": getattr(getattr(s.key, "req", None),
                                "trace_id", ""),
            "slots": list(s.slots),
            "t": int(s.t),
            "cap": int(s.cap),
            "live_hyps": sum(1 for h in s.hyps if h.slot is not None),
            "frozen_hyps": sum(1 for h in s.hyps if h.finished),
        } for s in list(self._sents.values())]
        state["beam"] = {"beam_size": self.beam_size, "cow": self.cow,
                         "sentences": sents}
        return state
