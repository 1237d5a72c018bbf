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

The fused decode contract: when the model's fused decode kernel owns the
cache reorder, the self-attention caches are NOT gathered after top-k.
The chosen backpointers ride to the next step as flat source rows
``b*K + beam_idx`` and the kernel applies them on its cache read, so the
caches lag the beam by exactly one step.

Not ported yet (ROADMAP): sampling, force-decode, alignments, word
scores, ensembles and the lexical shortlist.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

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
        )


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
                src_mask: torch.Tensor):
    """Returns (tokens [B,K,L], raw_scores [B,K], lengths [B,K],
    norm_scores [B,K], steps taken)."""
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
    vocab = model.cfg.trg_vocab

    tokens = torch.zeros((b, k, L), dtype=torch.long, device=dev)
    scores = torch.where(torch.arange(k, device=dev)[None, :] == 0,
                         torch.tensor(0.0, device=dev),
                         torch.tensor(NEG_INF, device=dev)).repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.long, device=dev)
    prev = torch.zeros((bk, 1), dtype=torch.long, device=dev)
    # pending-backpointer carry: identity before the first top-k
    src_rows = torch.arange(bk, dtype=torch.int32, device=dev) if fused \
        else None
    eos_onehot = torch.where(torch.arange(vocab, device=dev) == EOS_ID,
                             torch.tensor(0.0, device=dev),
                             torch.tensor(NEG_INF, device=dev))
    carried = model.beam_carried_suffixes
    batch_rows = torch.arange(b, device=dev)[:, None] * k

    t = 0
    while t < L and not bool(finished.all()):
        logits, state = model.step(params, state, prev, src_mask_bk,
                                   beam_src=src_rows)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
        if not cfg.allow_unk:
            logp[:, :, UNK_ID] = NEG_INF
        logp = torch.where(finished[:, :, None], eos_onehot, logp)
        combined = scores[:, :, None] + logp
        top_scores, top_idx = topk_rows(combined.reshape(b, k * vocab), k)
        beam_idx = top_idx // vocab                 # [B,K] source beam
        tok = top_idx % vocab

        def reorder(x):                            # [B,K,...] along K
            idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.ndim - 2))
            return x.gather(1, idx.expand(x.shape))

        tokens = reorder(tokens)
        tokens[:, :, t] = tok
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
    return tokens, scores, lengths, norm_scores, t


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

    def search(self, src_ids: np.ndarray,
               src_mask: np.ndarray) -> List[List[dict]]:
        """Per-sentence n-best lists of dicts {tokens, score, norm_score}."""
        ts = src_ids.shape[1]
        # static decode cap per source width (Marian: factor * src length)
        L = int(min(self.max_length_cap,
                    max(8, round(self.max_length_factor * ts))))
        cfg = BeamConfig.from_options(self.options, L)
        ids = torch.as_tensor(src_ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(src_mask, dtype=torch.float32,
                               device=self.device)
        with torch.inference_mode():
            tokens, scores, lengths, norm_scores, steps = beam_search(
                self.model, self.params, cfg, ids, mask)
        self.steps.append(steps)
        return self._collect(tokens.cpu().numpy(), scores.cpu().numpy(),
                             lengths.cpu().numpy(), norm_scores.cpu().numpy(),
                             cfg)

    @staticmethod
    def _collect(tokens, scores, lengths, norm_scores,
                 cfg: BeamConfig) -> List[List[dict]]:
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
                nbest.append({"tokens": toks,
                              "score": float(scores[i, j]),
                              "norm_score": float(norm_scores[i, j])})
            out.append(nbest)
        return out
