"""In-order output collection and printing, ported from
``marian_tpu/translator/output_collector.py`` (reference
src/translator/output_collector.cpp, output_printer.cpp).

Batches are length-sorted, so results arrive out of input order; the
collector buffers them and writes them in input order. The printer
formats single-best lines and ``--n-best`` lines
(``idx ||| text ||| Score= raw normalized``), with a ``WordScores=``
segment under ``--word-scores``. Alignments are not ported.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, TextIO


class OutputCollector:
    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout
        self._next = 0
        self._pending: Dict[int, str] = {}

    def write(self, sentence_id: int, text: str) -> None:
        self._pending[sentence_id] = text
        while self._next in self._pending:
            self.stream.write(self._pending.pop(self._next))
            self.stream.write("\n")
            self._next += 1
        self.stream.flush()

    def flush_remaining(self) -> None:
        for sid in sorted(self._pending):
            self.stream.write(self._pending[sid])
            self.stream.write("\n")
        self._pending.clear()
        self.stream.flush()


class OutputPrinter:
    def __init__(self, options, vocab):
        self.vocab = vocab
        self.n_best = bool(options.get("n-best", False))
        # --allow-special: keep </s> / <unk> visible in the output text
        self.allow_special = bool(options.get("allow-special", False))
        # right-left models emit reversed targets; un-reverse for display
        self.right_left = bool(options.get("right-left", False))
        self.feature = options.get("n-best-feature", "Score")

    def _detok(self, tokens: List[int]) -> str:
        if self.right_left:
            tokens = list(tokens)[::-1]
        return self.vocab.decode(tokens, ignore_eos=not self.allow_special)

    def _word_scores(self, h: dict) -> str:
        """The ``WordScores=`` segment: one score an emitted token, the
        terminating EOS included (right-left: the words re-reversed, the
        EOS still last)."""
        ws = h["word_scores"]
        if self.right_left and len(ws) > 1:
            ws = ws[-2::-1] + ws[-1:]
        return "WordScores= " + " ".join(f"{x:.6f}" for x in ws)

    def line(self, sentence_id: int, nbest: List[dict]) -> str:
        """Format one sentence's result (reference: OutputPrinter::print)."""
        if not self.n_best:
            h = nbest[0]
            out = self._detok(h["tokens"])
            if "word_scores" in h:
                # --word-scores applies to single-best output too
                out += " ||| " + self._word_scores(h)
            return out
        lines = []
        for h in nbest:
            parts = [str(sentence_id), self._detok(h["tokens"])]
            if "word_scores" in h:
                parts.append(self._word_scores(h))
            parts += [f"{self.feature}= {h['score']:.6f}",
                      f"{h['norm_score']:.6f}"]
            lines.append(" ||| ".join(parts))
        return "\n".join(lines)
