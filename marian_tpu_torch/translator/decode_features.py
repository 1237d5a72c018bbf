"""The per-row decode-feature plane of the paged engines, copied from
``marian_tpu/translator/decode_features.py``.

Request-mode decoding (beam_search.py) carries the decode surface —
lexical shortlist, output sampling, n-best, force-decode — as PER-BATCH
state: one shortlist a batch, one noise lane a search, one prefix matrix
a batch. Iteration mode has no batches: rows join and leave a running
decode, so each feature becomes PER-ROW state that rides in the engine's
slots and goes to the device beside pos/prev/page_table:

  FeaturePlane  — engine-wide configuration, parsed once from the same
                  options the dense path reads (--shortlist,
                  --output-sampling, --n-best, --force-decode), so a
                  flag means the same on both paths.
  RowFeatures   — one row's slice of it, built at JOIN: the row's
                  shortlist index set, its noise lane, its forced target
                  trunk, and the serving flags (stream, sentence id).

Parity with the dense twin, feature by feature:

  shortlist    A row's index set is EXACTLY the dense generator's for a
               one-sentence batch: the sorted union, EOS-padded to a
               multiple of k_multiple (data/shortlist.py). The engine
               pads every row to one static K and masks the coordinates
               past the row's true length to NEG_INF before the
               (log_)softmax: exp(NEG_INF - max) is exactly 0.0 in f32,
               so every live coordinate's log-prob is the dense one. The
               dense EOS-pad duplicates stay live, as they are there.
  sampling     Gumbel-max over logp / temperature. The noise is a
               function of (seed, lane, step, coordinate)
               (beam_search.gumbel_noise): a row's lane is its join
               ordinal (a beam row's, the sentence's plus its slot), its
               step its position. The same seed and join schedule
               replay the same output; two identical requests get
               different lanes, as two dense searches do.
  n-best       Collected from the beam engine's hypotheses and formatted
               through the same OutputPrinter as the dense Translate.
  force-decode The forced trunk masks logp to NEG_INF everywhere but the
               forced token, which keeps its TRUE logp (the dense prefix
               gate), so the scores of a forced decode are the dense
               run's. The trunk salts the prefix-cache key.

Composition rules (the dense path's refusals):
  - shortlist + force-decode is refused: forced ids are full-vocab,
    shortlisted logits are not.
  - sampling turns the prefix cache off: a sampled decode is not a
    function of the source, so replaying or forking it would serve
    another request's draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.shortlist import parse_shortlist_options
from .beam_search import _parse_sampling
from .output_collector import OutputPrinter


class RowFeatures:
    """One decode row's feature state, built at JOIN, carried in the
    engine slot beside pos/cap/tokens."""

    __slots__ = ("shortlist", "sl_len", "forced", "lane", "stream", "sid")

    def __init__(self, shortlist: Optional[np.ndarray] = None,
                 sl_len: int = 0, forced: Optional[List[int]] = None,
                 lane: int = 0, stream: bool = False, sid: int = 0):
        self.shortlist = shortlist   # [k_static] int32 full-vocab ids
        self.sl_len = sl_len         # the row's TRUE padded length (dense K)
        self.forced = forced or []   # forced target trunk (full-vocab ids)
        self.lane = lane             # noise lane (join ordinal)
        self.stream = stream         # the scheduler wants partials
        self.sid = sid               # request-local sentence id (n-best)

    def forced_at(self, pos: int) -> int:
        """Forced token at target position pos, -1 past the trunk."""
        return self.forced[pos] if pos < len(self.forced) else -1


class FeaturePlane:
    """Engine-wide decode-feature configuration and per-row state
    factory: built once with the engine (server, or a test) from the
    options the dense Translate reads; ``row_features`` runs at every
    JOIN."""

    def __init__(self, shortlist_gen=None, sampling: tuple = (),
                 seed: int = 1234, n_best: bool = False,
                 force_decode: bool = False, k_static: int = 1024,
                 printer: Optional[OutputPrinter] = None):
        if shortlist_gen is not None and force_decode:
            raise ValueError("--shortlist does not compose with "
                             "--force-decode: forced prefix ids are "
                             "full-vocab, shortlisted logits are not")
        self.shortlist_gen = shortlist_gen
        self.sampling = tuple(sampling or ())
        self.seed = int(seed)
        self.n_best = bool(n_best)
        self.force_decode = bool(force_decode)
        self.printer = printer
        if self.n_best and self.printer is None:
            raise ValueError("n_best FeaturePlane needs an OutputPrinter "
                             "(use FeaturePlane.from_options)")
        # ONE static K for every row: rows pad up to it with EOS (masked
        # past their true length); a union past it is cut, as the
        # generator's max_k cuts
        if shortlist_gen is not None:
            mult = max(1, int(getattr(shortlist_gen, "k_multiple", 128)))
            self.k_static = max(mult, -(-int(k_static) // mult) * mult)
        else:
            self.k_static = 0

    # ---------------------------------------------------------- options
    @classmethod
    def from_options(cls, options, src_vocab, trg_vocab,
                     k_static: int = 1024) -> Optional["FeaturePlane"]:
        """The plane of a server/translator options namespace; None when
        no decode-surface feature is on (the engines then run their
        plain step)."""
        gen = parse_shortlist_options(
            options.get("shortlist", []) or [], src_vocab, trg_vocab)
        sampling = _parse_sampling(options.get("output-sampling", None))
        n_best = bool(options.get("n-best", False))
        force = bool(options.get("force-decode", False))
        if gen is None and not sampling and not n_best and not force:
            return None
        # BeamSearch's default-seed rule
        seed = int(options.get("seed", 0) or 0) or 1234
        printer = OutputPrinter(options, trg_vocab) if n_best else None
        return cls(shortlist_gen=gen, sampling=sampling, seed=seed,
                   n_best=n_best, force_decode=force, k_static=k_static,
                   printer=printer)

    # ------------------------------------------------------------- rows
    def split_forced(self, text: str, trg_vocab) -> Tuple[str, List[int]]:
        """(source, forced target trunk) of one request line in the
        ``source<TAB>target-prefix`` convention, the wire twin of the
        dense Translate's two --input files. No TAB (or an empty prefix):
        unconstrained. The prefix is encoded WITHOUT EOS."""
        if not self.force_decode or "\t" not in text:
            return text, []
        src, _, pfx = text.partition("\t")
        if not pfx.strip():
            return src, []
        return src, [int(t) for t in trg_vocab.encode(pfx, add_eos=False)]

    def row_shortlist(self, src_ids: Sequence[int]
                      ) -> Tuple[Optional[np.ndarray], int]:
        """The row's shortlist: the dense one-sentence union, EOS-padded
        to its dense K (the row's live length), then to k_static."""
        if self.shortlist_gen is None:
            return None, 0
        sl = self.shortlist_gen.generate(
            np.unique(np.asarray(src_ids, np.int32)))
        idx = np.asarray(sl.indices, np.int32)
        true_k = int(idx.shape[0])
        if true_k > self.k_static:
            idx, true_k = idx[:self.k_static], self.k_static
        row = np.full((self.k_static,), int(idx[0]), np.int32)  # EOS pad
        row[:true_k] = idx
        return row, true_k

    def row_features(self, src_ids: Sequence[int],
                     forced: Optional[List[int]] = None, lane: int = 0,
                     stream: bool = False, sid: int = 0) -> RowFeatures:
        row, true_k = self.row_shortlist(src_ids)
        return RowFeatures(shortlist=row, sl_len=true_k,
                           forced=list(forced or []), lane=lane,
                           stream=stream, sid=sid)

    # ----------------------------------------------------- cache compose
    def cache_key(self, src_key: tuple, forced: Sequence[int]) -> tuple:
        """A row's prefix-cache key: the source token tuple, salted with
        the forced trunk when there is one (a constrained prefix is a
        shareable trunk, but only among requests constrained alike)."""
        if forced:
            return (src_key, ("forced",) + tuple(int(t) for t in forced))
        return src_key

    @property
    def cacheable(self) -> bool:
        """Sampled decodes are not functions of the source: the prefix
        cache must not replay or fork them."""
        return not self.sampling

    # ------------------------------------------------------------ n-best
    def format_nbest(self, sid: int, nbest: List[dict]) -> str:
        """A finished row's ranked hypotheses through the dense Translate's
        OutputPrinter (the request-mode n-best block, byte for byte)."""
        return self.printer.line(sid, nbest)

    def describe(self) -> str:
        on = []
        if self.shortlist_gen is not None:
            on.append(f"shortlist(k_static={self.k_static})")
        if self.sampling:
            on.append("sampling=" + "/".join(str(p) for p in self.sampling))
        if self.n_best:
            on.append("n-best")
        if self.force_decode:
            on.append("force-decode")
        return "+".join(on) or "none"
