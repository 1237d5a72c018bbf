"""Translation-based validators, ported from
``marian_tpu/translator/validators.py`` (reference
src/training/validator.cpp :: BleuValidator, SacreBleuValidator,
TranslationValidator, ScriptValidator). The dev sources are decoded by
the port's ``BeamSearch`` with the current (or smoothed) parameters, at
--beam-size and without n-best, batched as the reference batches them:
--valid-mini-batch sentences, maxi-batches of 10 sorted by source
length, cropped at --valid-max-length.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import List, Tuple

import torch

from ..common import logging as log
from ..data.batch_generator import BatchGenerator
from ..models import transformer as T
from ..models.encoder_decoder import create_model
from ..training.validators import Validator, dev_corpus
from .beam_search import BeamSearch
from .metrics import corpus_bleu, corpus_chrf


class _BeamOverDevSet:
    """Shared machinery: decode the validation sources with given
    parameters through an inference model built from the training
    options."""

    def __init__(self, options, vocabs, device: torch.device):
        self.options = options
        self.vocabs = vocabs
        self.device = device
        self.model = create_model(options, len(vocabs[0]), len(vocabs[-1]))

    def decode_dev(self, params) -> Tuple[List[str], List[str]]:
        opts = self.options
        valid_sets = list(opts.get("valid-sets", []))
        if len(valid_sets) < 2:
            raise ValueError("translation validators need source+reference "
                             "in --valid-sets")
        bg = BatchGenerator(dev_corpus(opts, self.vocabs), None,
                            mini_batch=int(opts.get("valid-mini-batch", 32)),
                            maxi_batch=10, maxi_batch_sort="src",
                            shuffle_batches=False)
        bs = BeamSearch(self.model,
                        T.cast_params(params, self.model.cfg.compute_dtype),
                        opts.with_(**{"beam-size": int(opts.get("beam-size",
                                                                12)),
                                      "n-best": False}),
                        self.device)
        hyps: dict = {}
        for batch in bg:
            res = bs.search(batch.src.ids, batch.src.mask)
            for row in range(batch.size):
                sid = int(batch.sentence_ids[row])
                hyps[sid] = self.vocabs[-1].decode(res[row][0]["tokens"])
        ordered = [hyps[i] for i in sorted(hyps)]
        with open(valid_sets[-1], "r", encoding="utf-8") as fh:
            refs = [l.rstrip("\n") for l in fh][: len(ordered)]
        return ordered, refs


class TranslationMetricValidator(Validator, _BeamOverDevSet):
    """bleu / bleu-detok / bleu-segmented / chrf (reference:
    SacreBleuValidator)."""
    lower_is_better = False

    def __init__(self, options, vocabs, device: torch.device,
                 metric: str = "bleu"):
        _BeamOverDevSet.__init__(self, options, vocabs, device)
        self.name = metric

    def validate(self, params) -> float:
        hyps, refs = self.decode_dev(params)
        if self.name == "chrf":
            return corpus_chrf(hyps, refs)
        return corpus_bleu(hyps, refs)


def _script_score(args: List[str]) -> float:
    """The last token of the script's stdout as the metric (0 when it
    does not parse)."""
    out = subprocess.run(args, capture_output=True, text=True, timeout=3600)
    try:
        return float(out.stdout.strip().split()[-1])
    except (ValueError, IndexError):
        log.warn("valid-script output unparsable: {}", out.stdout[:200])
        return 0.0


class TranslationValidator(Validator, _BeamOverDevSet):
    """Decode the dev set, write --valid-translation-output when given,
    score with --valid-script-path when given, else BLEU (reference:
    TranslationValidator)."""
    lower_is_better = False
    name = "translation"

    def __init__(self, options, vocabs, device: torch.device):
        _BeamOverDevSet.__init__(self, options, vocabs, device)
        # the trainer's TrainingState, for the output path's templates
        self.training_state = None

    def validate(self, params) -> float:
        hyps, refs = self.decode_dev(params)
        out_path = self.options.get("valid-translation-output", None)
        if out_path:
            # {U}/{E}/{B}/{T}: update count, 1-based epoch, updates within
            # the epoch, total target labels, so that successive
            # validations keep their own files
            st = self.training_state
            if st is not None:
                out_path = (str(out_path)
                            .replace("{U}", str(st.batches))
                            .replace("{E}", str(st.epochs + 1))
                            .replace("{B}", str(st.batches_epoch))
                            .replace("{T}", str(int(st.labels_total))))
            with open(out_path, "w", encoding="utf-8") as fh:
                fh.write("\n".join(hyps) + "\n")
        script = self.options.get("valid-script-path", None)
        if script:
            with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                             delete=False) as tf:
                tf.write("\n".join(hyps) + "\n")
            try:
                return _script_score(
                    [script] + list(self.options.get("valid-script-args",
                                                     [])) + [tf.name])
            finally:
                os.unlink(tf.name)
        return corpus_bleu(hyps, refs)


class ScriptValidator(Validator):
    """Run an external script (reference: ScriptValidator); the last
    token of its stdout is the metric."""
    lower_is_better = False
    name = "valid-script"

    def __init__(self, options):
        self.options = options

    def validate(self, params) -> float:
        script = self.options.get("valid-script-path", None)
        if not script:
            raise ValueError("valid-script requires --valid-script-path")
        return _script_score(
            [script] + list(self.options.get("valid-script-args", [])))
