"""Validators, ported from ``marian_tpu/training/validators.py``
(reference src/training/validator.cpp/.h): run on the dev set at
--valid-freq; the Scheduler tracks each metric's best and stall count
for early stopping, --keep-best and the --lr-decay strategies.

Here: cross-entropy / ce-mean-words / perplexity (the teacher-forced dev
loss, ``model.loss`` without dropout). The bleu, chrf, translation and
valid-script validators (translator/validators.py) decode through the
port's beam search.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..common import logging as log
from ..data.batch_generator import BatchGenerator
from ..data.corpus import Corpus
from ..models.encoder_decoder import batch_to_arrays


class Validator:
    name = "validator"
    lower_is_better = True

    def validate(self, params) -> float:
        raise NotImplementedError


def dev_corpus(options, vocabs) -> Corpus:
    """The --valid-sets corpus as the reference reads it: cropped at
    --valid-max-length, never shuffled. The training corpus's side
    streams (--guided-alignment, --data-weighting) are not read for it:
    their files are line-parallel to the training set, and the
    reference, which reads them here too, fails on the length mismatch
    (ROADMAP §C)."""
    return Corpus(list(options.get("valid-sets", [])), vocabs,
                  options.with_(**{"max-length": options.get(
                      "valid-max-length", 1000),
                      "max-length-crop": True, "shuffle": "none",
                      "guided-alignment": "none", "data-weighting": None}))


class CrossEntropyValidator(Validator):
    """The dev set's cost (reference: CrossEntValidator), batched as the
    reference batches it: --valid-mini-batch sentences, maxi-batches of
    10 sorted by target length, in corpus order."""

    def __init__(self, options, vocabs, model, device: torch.device,
                 name: str = "cross-entropy"):
        self.name = name
        self.options = options
        self.vocabs = vocabs
        self.model = model
        self.device = device

    @torch.no_grad()
    def validate(self, params) -> float:
        opts = self.options
        if not list(opts.get("valid-sets", [])):
            return float("nan")
        bg = BatchGenerator(dev_corpus(opts, self.vocabs), None,
                            mini_batch=int(opts.get("valid-mini-batch", 32)),
                            maxi_batch=10, shuffle_batches=False)
        total = labels = 0.0
        for batch in bg:
            _, aux = self.model.loss(params,
                                     batch_to_arrays(batch, self.device),
                                     None, train=False)
            total += float(aux["ce_sum"])
            labels += float(aux["labels"])
        if labels == 0:
            return float("nan")
        if self.name == "perplexity":
            return math.exp(min(total / labels, 700.0))
        if self.name == "ce-mean-words":
            return total / labels
        return total / labels if str(opts.get("cost-type", "ce-sum")) \
            .startswith("ce-mean") else total


def create_validators(options, vocabs, model,
                      device: torch.device) -> List[Validator]:
    """One validator per --valid-metrics entry, in its order (none
    without --valid-sets)."""
    out: List[Validator] = []
    if not options.get("valid-sets", []):
        return out
    for metric in options.get("valid-metrics", ["cross-entropy"]):
        if metric in ("cross-entropy", "ce-mean-words", "perplexity"):
            out.append(CrossEntropyValidator(options, vocabs, model, device,
                                             metric))
        elif metric in ("bleu", "bleu-detok", "bleu-segmented", "chrf"):
            from ..translator.validators import TranslationMetricValidator
            out.append(TranslationMetricValidator(options, vocabs, device,
                                                  metric))
        elif metric == "translation":
            from ..translator.validators import TranslationValidator
            out.append(TranslationValidator(options, vocabs, device))
        elif metric == "valid-script":
            from ..translator.validators import ScriptValidator
            out.append(ScriptValidator(options))
        else:
            log.warn("Unknown valid-metric '{}' ignored", metric)
    return out
