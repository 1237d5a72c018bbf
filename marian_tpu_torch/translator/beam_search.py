"""Batched beam search, ported from ``marian_tpu/translator/beam_search.py``
(``beam_search_jit`` and ``BeamSearch``) for one model.

- state: tokens [B,K,L], scores [B,K], finished [B,K], decode caches
  [B*K, ...]; a Python loop over positions stops when every beam is
  finished or t == L (the reference's lax.while_loop);
- top-k over the flattened beam×vocab axis, ties to the LOWER flat
  index, as lax.top_k orders them (torch.topk promises no tie order);
- finished beams are frozen by forcing their distribution to {EOS: 0};
- beam expansion at t=0 is masked to beam 0 (all beams start equal);
- Marian's score bookkeeping: cumulative log-prob, length normalization
  score/len^alpha and word penalty when ranking finished hypotheses,
  --allow-unk suppression, n-best.

The decode surface: a lexical shortlist (a [K] index set a batch: the
top-k runs in shortlist coordinates, EOS at coordinate 0, and tokens
map back through the set; UNK is suppressed only without one), output
sampling (``--output-sampling full|topk``: every beam an independent
gumbel-max trajectory from score 0, ``sample_pick`` over
``gumbel_noise``), force-decode (a target prefix a sentence: while t is
inside it every token but the forced one is NEG_INF, and the forced one
keeps its true log-prob) and the per-word score trail
(``--word-scores``).

Random draws: the gumbel noise is a function of (seed, lane, step,
coordinate) alone (``gumbel_noise``, a counter-based hash in torch
integer ops), the same on the CPU and on the card. The dense search's
lane is its sampled-search counter and its coordinate the flat index in
[B, K, V]; the paged engines' lane is the row's join ordinal and the
step its position.

The fused decode contract: when the model's fused decode kernel owns the
cache reorder, the self-attention caches are NOT gathered after top-k.
The chosen backpointers ride to the next step as flat source rows
``b*K + beam_idx`` and the kernel applies them on its cache read, so the
caches lag the beam by exactly one step.

Not ported (ROADMAP): alignments, ensembles, ``--output-approx-knn``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.vocab import EOS_ID, UNK_ID

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int = 6
    normalize: float = 0.6          # length-normalization alpha (0 = off)
    word_penalty: float = 0.0
    allow_unk: bool = False
    max_length: int = 256           # decode cap L
    n_best: int = 1
    # --output-sampling: () = off; ("full", temp) samples the full
    # softmax; ("topk", n, temp) the n most probable tokens
    sampling: tuple = ()
    word_scores: bool = False       # --word-scores: per-token logP trail

    @classmethod
    def from_options(cls, options, max_length: int) -> "BeamConfig":
        norm = options.get("normalize", 0.0)
        if norm is True:
            norm = 1.0
        return cls(
            beam_size=int(options.get("beam-size", 6)),
            normalize=float(norm or 0.0),
            word_penalty=float(options.get("word-penalty", 0.0) or 0.0),
            allow_unk=bool(options.get("allow-unk", False)),
            max_length=max_length,
            n_best=int(options.get("beam-size", 6))
            if options.get("n-best", False) else 1,
            sampling=_parse_sampling(options.get("output-sampling", [])),
            word_scores=bool(options.get("word-scores", False)),
        )


def _parse_sampling(raw) -> tuple:
    """'full [temp]' / 'topk [n] [temp]' → a normalized tuple (reference:
    --output-sampling)."""
    if raw in (None, False, [], ""):
        return ()
    if raw is True:
        return ("full", 1.0)
    parts = [str(p) for p in (raw if isinstance(raw, list) else [raw])]
    mode = parts[0].lower()
    if mode == "full":
        temp = float(parts[1]) if len(parts) > 1 else 1.0
        return ("full", temp)
    if mode == "topk":
        n = int(parts[1]) if len(parts) > 1 else 10
        temp = float(parts[2]) if len(parts) > 2 else 1.0
        return ("topk", n, temp)
    raise ValueError(f"--output-sampling: unknown mode '{mode}' "
                     f"(expected full or topk)")


def sampling_params(sampling: tuple):
    """(temperature, top n or 0) of a parsed --output-sampling."""
    temp = max(float(sampling[-1]), 1e-6)
    return temp, (int(sampling[1]) if sampling[0] == "topk" else 0)


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2^32 for ``x`` in [0, 2^32) (an int or an int64
    tensor): two 16-bit halves of c, so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply, a bijection)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def noise_bits(seed: int, lane, step, coord: torch.Tensor) -> torch.Tensor:
    """32 random bits at each of ``coord``'s entries, a function of
    (seed, lane, step, coordinate) alone: one hash stage an input, in
    int64 torch ops (Python ints for scalar inputs, so nothing is
    copied to the device: it runs inside a step loop free of host
    syncs), and the CPU and the card give the same bits. ``lane`` and
    ``step`` are ints or int64 tensors broadcasting against ``coord``."""
    def stage(h, x):
        x = x.to(torch.int64) & _M32 if torch.is_tensor(x) \
            else int(x) & _M32
        return _mix32(((h ^ x) + _GOLDEN) & _M32)
    h = int(seed) & _M32
    for x in (lane, step, coord):
        h = stage(h, x)
    return h


def gumbel_noise(seed: int, lane, step, coord: torch.Tensor) -> torch.Tensor:
    """Standard gumbel noise (f32) at ``coord``: 24 of ``noise_bits``'
    bits as a uniform in (0, 1), then -log(-log(u)) in f64, rounded to
    f32 once."""
    u = ((noise_bits(seed, lane, step, coord) >> 8).double() + 0.5) \
        / float(1 << 24)
    return (-torch.log(-torch.log(u))).float()


def sample_pick(logp: torch.Tensor, noise: torch.Tensor, temperature: float,
                topn: int = 0) -> torch.Tensor:
    """Gumbel-max sampling of one token a row (the last axis): tempered
    log-probs, everything below the ``topn``-th value set to NEG_INF
    (``topn`` 0: the full softmax), argmax of that plus ``noise`` (ties
    to the lower index)."""
    slp = logp / max(float(temperature), 1e-6)
    if topn:
        kth = torch.topk(slp, min(int(topn), slp.shape[-1]),
                         dim=-1).values[..., -1:]
        slp = torch.where(slp < kth, torch.full_like(slp, NEG_INF), slp)
    return torch.argmax(slp + noise, dim=-1)


def topk_rows(flat: torch.Tensor, k: int):
    """Per-row top k of [N, M], in descending value order with ties to
    the lower index: exactly the set and order lax.top_k returns."""
    vals, idx = torch.topk(flat, k, dim=-1)
    kth = vals[:, -1:]
    if bool(((flat == kth).sum(-1) > (vals == kth).sum(-1)).any()):
        # the k-th value ties with candidates torch.topk left out: take
        # the lowest tied indices instead (a full-row scan, so only here)
        above = flat > kth
        tied = flat == kth
        need = k - above.sum(dim=-1, keepdim=True)
        take = above | (tied & (torch.cumsum(tied, dim=-1) <= need))
        idx = take.nonzero()[:, 1].reshape(flat.shape[0], k)
        vals = flat.gather(1, idx)
    idx, perm = torch.sort(idx, dim=-1)
    vals = vals.gather(1, perm)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def beam_search(model, params, cfg: BeamConfig, src_ids: torch.Tensor,
                src_mask: torch.Tensor,
                shortlist: Optional[torch.Tensor] = None,
                prefix: Optional[torch.Tensor] = None,
                seed: int = 0, lane: int = 0):
    """Returns (tokens [B,K,L], raw_scores [B,K], lengths [B,K],
    norm_scores [B,K], steps taken, word scores [B,K,L] or None).

    ``shortlist`` [K] full-vocab ids (EOS at 0): the step's logits and
    the top-k are in its coordinates. ``prefix`` [B, L] forced target
    tokens, -1 where unconstrained (--force-decode). ``seed`` and
    ``lane``: the gumbel noise of a sampled search (``cfg.sampling``)."""
    b = src_ids.shape[0]
    k = cfg.beam_size
    L = cfg.max_length
    bk = b * k
    dev = src_ids.device
    fused = bool(model.fused_decode_reorder)

    src_mask_bk = torch.repeat_interleave(src_mask, k, dim=0)
    enc = model.encode_for_decode(params, src_ids, src_mask)
    state = model.start_state(params, torch.repeat_interleave(enc, k, dim=0),
                              src_mask_bk, L)
    vocab = (shortlist.shape[0] if shortlist is not None
             else model.cfg.trg_vocab)
    sl = shortlist.long() if shortlist is not None else None
    eos_index = 0 if sl is not None else EOS_ID

    tokens = torch.zeros((b, k, L), dtype=torch.long, device=dev)
    if cfg.sampling:
        # every beam is an independent sample: all start live at 0
        scores = torch.zeros((b, k), device=dev)
    else:
        scores = torch.where(torch.arange(k, device=dev)[None, :] == 0,
                             torch.tensor(0.0, device=dev),
                             torch.tensor(NEG_INF, device=dev)).repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.long, device=dev)
    wscores = torch.zeros((b, k, L), device=dev) if cfg.word_scores \
        else None
    prev = torch.zeros((bk, 1), dtype=torch.long, device=dev)
    # pending-backpointer carry: identity before the first top-k
    src_rows = torch.arange(bk, dtype=torch.int32, device=dev) if fused \
        else None
    coords = torch.arange(vocab, device=dev)
    eos_onehot = torch.where(coords == eos_index,
                             torch.tensor(0.0, device=dev),
                             torch.tensor(NEG_INF, device=dev))
    neg = torch.tensor(NEG_INF, device=dev)
    carried = model.beam_carried_suffixes
    batch_rows = torch.arange(b, device=dev)[:, None] * k
    identity = torch.arange(k, device=dev)[None, :].expand(b, k)
    if cfg.sampling:
        temp, topn = sampling_params(cfg.sampling)
        flat_coords = torch.arange(bk * vocab, device=dev).view(b, k, vocab)

    t = 0
    while t < L and not bool(finished.all()):
        logits, state = model.step(params, state, prev, src_mask_bk,
                                   beam_src=src_rows, shortlist=sl)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
        if not cfg.allow_unk and sl is None:
            logp[:, :, UNK_ID] = NEG_INF
        logp = torch.where(finished[:, :, None], eos_onehot, logp)
        if prefix is not None:
            # inside a sentence's prefix only the forced token survives,
            # at its true log-prob
            ptok = prefix[:, t]
            gate = (ptok >= 0)[:, None, None] & ~finished[:, :, None]
            hot = coords[None, None, :] == ptok.clamp(min=0)[:, None, None]
            logp = torch.where(gate & ~hot, neg, logp)
        if cfg.sampling:
            tok = sample_pick(logp, gumbel_noise(seed, lane, t, flat_coords),
                              temp, topn)
            top_scores = scores + logp.gather(-1, tok[..., None])[..., 0]
            beam_idx = identity
        else:
            combined = scores[:, :, None] + logp
            top_scores, top_idx = topk_rows(combined.reshape(b, k * vocab),
                                            k)
            beam_idx = top_idx // vocab             # [B,K] source beam
            tok = top_idx % vocab                   # (shortlist) coords
        if sl is not None:
            tok = sl[tok]

        def reorder(x):                            # [B,K,...] along K
            idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.ndim - 2))
            return x.gather(1, idx.expand(x.shape))

        tokens = reorder(tokens)
        tokens[:, :, t] = tok
        if wscores is not None:
            # this step's cumulative minus the source beam's previous one
            # (frozen beams pick EOS at 0: their trail stops moving)
            wscores = reorder(wscores)
            wscores[:, :, t] = top_scores - scores.gather(1, beam_idx)
        was_finished = reorder(finished)
        lengths = torch.where(was_finished, reorder(lengths),
                              torch.full_like(lengths, t + 1))
        finished = was_finished | (tok == EOS_ID)
        scores = top_scores

        flat_rows = (batch_rows + beam_idx).reshape(bk)
        if fused:
            # the next step's kernel reads the caches through this map
            src_rows = flat_rows.to(torch.int32)
        else:
            state = {key: (v.index_select(0, flat_rows)
                           if key.endswith(carried) else v)
                     for key, v in state.items()}
        prev = tok.reshape(bk, 1)
        t += 1

    # unfinished beams at L: length = L
    lengths = torch.where(finished, lengths, torch.full_like(lengths, L))
    norm = torch.ones_like(scores)
    if cfg.normalize > 0:
        norm = torch.pow(lengths.float(), cfg.normalize)
    norm_scores = scores / norm - cfg.word_penalty * lengths.float()
    return tokens, scores, lengths, norm_scores, t, wscores


class BeamSearch:
    """Host-side wrapper: decode cap per source width, n-bests out
    (reference: BeamSearch::search + translator.h per-batch loop).
    ``steps`` records the decode steps each search took."""

    def __init__(self, model, params: Dict[str, torch.Tensor], options,
                 device: torch.device):
        self.model = model
        self.params = params
        self.options = options
        self.device = device
        self.max_length_factor = float(options.get("max-length-factor", 3.0))
        self.max_length_cap = int(options.get("max-length", 1000))
        self.steps: List[int] = []
        # sampled searches: the noise lane is this counter (reference:
        # one folded key per sampled search call)
        self._sample_calls = 0
        self._sample_seed = int(options.get("seed", 0) or 0) or 1234

    def search(self, src_ids: np.ndarray, src_mask: np.ndarray,
               shortlist=None, prefix: Optional[np.ndarray] = None
               ) -> List[List[dict]]:
        """Per-sentence n-best lists of dicts {tokens, score, norm_score}
        (and word_scores under --word-scores). ``shortlist``: the batch's
        ``Shortlist``; ``prefix`` [B, P] int (pad -1): each sentence's
        forced target prefix (--force-decode)."""
        if prefix is not None and shortlist is not None:
            raise ValueError("--force-decode cannot be combined with a "
                             "lexical shortlist (prefix ids are full-vocab)")
        ts = src_ids.shape[1]
        # static decode cap per source width (Marian: factor * src length)
        L = int(min(self.max_length_cap,
                    max(8, round(self.max_length_factor * ts))))
        if prefix is not None:
            plen = int(np.asarray(prefix).shape[1])
            # the forced prefix must fit under the cap with room to go on
            L = max(L, min(self.max_length_cap, plen + 8))
            if plen >= self.max_length_cap:
                raise ValueError(
                    f"--force-decode: prefix length {plen} exceeds "
                    f"--max-length {self.max_length_cap}")
        cfg = BeamConfig.from_options(self.options, L)
        ids = torch.as_tensor(src_ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(src_mask, dtype=torch.float32,
                               device=self.device)
        sl = None
        if shortlist is not None:
            sl = torch.as_tensor(np.asarray(shortlist.indices),
                                 dtype=torch.long, device=self.device)
        pfx = None
        if prefix is not None:
            # padded or cropped to the decode cap with -1
            p = np.full((ids.shape[0], L), -1, np.int64)
            given = np.asarray(prefix)[:, :L]
            p[:given.shape[0], :given.shape[1]] = given
            pfx = torch.as_tensor(p, device=self.device)
        lane = 0
        if cfg.sampling:
            self._sample_calls += 1
            lane = self._sample_calls
        with torch.inference_mode():
            tokens, scores, lengths, norm_scores, steps, ws = beam_search(
                self.model, self.params, cfg, ids, mask, sl, pfx,
                seed=self._sample_seed, lane=lane)
        self.steps.append(steps)
        return self._collect(tokens.cpu().numpy(), scores.cpu().numpy(),
                             lengths.cpu().numpy(), norm_scores.cpu().numpy(),
                             cfg, None if ws is None else ws.cpu().numpy())

    @staticmethod
    def _collect(tokens, scores, lengths, norm_scores, cfg: BeamConfig,
                 wscores=None) -> List[List[dict]]:
        b, k, _ = tokens.shape
        out = []
        for i in range(b):
            order = np.argsort(-norm_scores[i])
            nbest = []
            for rank in range(min(cfg.n_best, k) if cfg.n_best > 1 else 1):
                j = order[rank]
                ln = int(lengths[i, j])
                toks = tokens[i, j, :ln].tolist()
                if toks and toks[-1] == EOS_ID:
                    toks = toks[:-1]
                entry = {"tokens": toks,
                         "score": float(scores[i, j]),
                         "norm_score": float(norm_scores[i, j])}
                if wscores is not None:
                    # per emitted token, the terminating EOS included
                    entry["word_scores"] = [float(x)
                                            for x in wscores[i, j, :ln]]
                nbest.append(entry)
            out.append(nbest)
        return out
