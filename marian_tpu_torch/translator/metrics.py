"""In-process corpus BLEU and chrF, a copy of
``marian_tpu/translator/metrics.py`` (reference: the vendored sacreBLEU
subset behind SacreBleuValidator, src/training/validator.h). Standard
definitions:

- BLEU: corpus-level, 4-gram precisions with brevity penalty (smooth='exp'
  not applied — matches sacrebleu's default floor behavior via add-0 counts;
  we use the common "exp" smoothing only when a precision is zero, matching
  sacrebleu's `smooth_method='exp'` default).
- chrF: character n-gram F-score (n=6, beta=2), whitespace-stripped, the
  sacreBLEU chrF2 default.
"""

from __future__ import annotations

import collections
import math
from typing import Sequence


def _ngrams(tokens: Sequence, n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(hypotheses: Sequence[str], references: Sequence[str],
                max_n: int = 4, tokenize=None) -> float:
    """BLEU in [0, 100]."""
    assert len(hypotheses) == len(references)
    tok = tokenize or (lambda s: s.split())
    matches = [0] * max_n
    totals = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        h, r = tok(hyp), tok(ref)
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            hg, rg = _ngrams(h, n), _ngrams(r, n)
            totals[n - 1] += max(len(h) - n + 1, 0)
            matches[n - 1] += sum((hg & rg).values())
    smooth = 1.0
    precisions = []
    for n in range(max_n):
        if totals[n] == 0:
            continue  # effective order: corpus shorter than n-grams of this n
        if matches[n] == 0:
            smooth *= 2.0
            precisions.append(100.0 / (smooth * totals[n]))
        else:
            precisions.append(100.0 * matches[n] / totals[n])
    if not precisions or min(precisions) <= 0:
        return 0.0
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    score = bp * math.exp(sum(math.log(p) for p in precisions) / len(precisions))
    return min(max(score, 0.0), 100.0)


def sentence_chrf(hyp: str, ref: str, n: int = 6, beta: float = 2.0) -> float:
    return corpus_chrf([hyp], [ref], n=n, beta=beta)


def corpus_chrf(hypotheses: Sequence[str], references: Sequence[str],
                n: int = 6, beta: float = 2.0) -> float:
    """chrF in [0, 100] (macro-averaged n-gram F-scores, sacreBLEU style:
    micro-average precision/recall per order, then average over orders)."""
    assert len(hypotheses) == len(references)
    tp = [0] * n
    hyp_tot = [0] * n
    ref_tot = [0] * n
    for hyp, ref in zip(hypotheses, references):
        h = hyp.replace(" ", "")
        r = ref.replace(" ", "")
        for k in range(1, n + 1):
            hg, rg = _ngrams(h, k), _ngrams(r, k)
            tp[k - 1] += sum((hg & rg).values())
            hyp_tot[k - 1] += max(len(h) - k + 1, 0)
            ref_tot[k - 1] += max(len(r) - k + 1, 0)
    f_scores = []
    for k in range(n):
        if hyp_tot[k] == 0 or ref_tot[k] == 0:
            f_scores.append(0.0)
            continue
        p = tp[k] / hyp_tot[k]
        r = tp[k] / ref_tot[k]
        if p + r == 0:
            f_scores.append(0.0)
        else:
            f_scores.append((1 + beta**2) * p * r / (beta**2 * p + r))
    return 100.0 * sum(f_scores) / n
