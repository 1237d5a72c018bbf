"""The translation entry point, ported from
``marian_tpu/translator/translator.py`` (reference src/translator/
translator.h :: Translate<BeamSearch>::run) for one model.

Loads the model and vocabs, batches the input (maxi-batch length sort,
``--mini-batch`` sentences or the ``--mini-batch-words`` token budget),
runs the beam search batch by batch on the resolved device, and writes
translations in input order.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Union

import torch

from ..common import io as mio
from ..common import logging as log
from ..convert import params_from_numpy
from ..data.batching import batches, encode_lines
from ..data.vocab import create_vocab
from ..device import resolve_device
from ..models.encoder_decoder import apply_embedded_config, create_model
from .beam_search import BeamSearch
from .output_collector import OutputCollector, OutputPrinter

# option → value at which the feature is off; set to anything else the
# decoder refuses to start instead of ignoring it
_UNPORTED = {
    "alignment": None,
    "word-scores": False,
    "output-sampling": [],
    "force-decode": False,
    "shortlist": [],
    "output-approx-knn": [],
    "weights": [],
}


def _refuse_unported(options) -> None:
    for name, off in _UNPORTED.items():
        val = options.get(name, off)
        if val not in (off, None, False, [], 0, ""):
            raise NotImplementedError(
                f"--{name} is not ported to marian_tpu_torch yet (ROADMAP: "
                f"beam-search extras)")
    if len(options.get("models", []) or []) > 1:
        raise NotImplementedError("ensembles (several --models) are not "
                                  "ported to marian_tpu_torch yet (ROADMAP)")


class Translate:
    def __init__(self, options,
                 device: Optional[Union[str, torch.device]] = None):
        log.create_loggers(options)
        _refuse_unported(options)
        cpu_threads = int(options.get("cpu-threads", 0) or 0)
        self.device = resolve_device(device, cpu_threads)
        model_path = (list(options.get("models", [])) or
                      [options.get("model")])[0]
        flat, cfg_yaml = mio.load_model(model_path)
        # the architecture comes from the checkpoint's embedded config
        # unless --ignore-model-config (reference: translator.h)
        self.options = apply_embedded_config(options, cfg_yaml)
        vocab_paths = list(self.options.get("vocabs", []))
        if len(vocab_paths) != 2:
            raise ValueError("--vocabs needs a source and a target vocab")
        self.src_vocab = create_vocab(vocab_paths[0])
        self.trg_vocab = create_vocab(vocab_paths[1])
        self.model = create_model(self.options, len(self.src_vocab),
                                  len(self.trg_vocab))
        self.params = params_from_numpy(flat, self.device,
                                        self.model.cfg.compute_dtype)
        self.search = BeamSearch(self.model, self.params, self.options,
                                 self.device)
        self.printer = OutputPrinter(self.options, self.trg_vocab)
        log.info("Translating on {} with {}", self.device, model_path)

    def _input_lines(self) -> List[str]:
        inputs = self.options.get("input", ["stdin"])
        path = inputs[0] if isinstance(inputs, list) else inputs
        if path in ("stdin", "-"):
            return [l.rstrip("\n") for l in sys.stdin]
        with open(path, "r", encoding="utf-8") as fh:
            return [l.rstrip("\n") for l in fh]

    def run(self, lines: Optional[List[str]] = None, stream=None) -> List[str]:
        """Translate ``lines`` (or --input) and write to ``stream`` (or
        --output); returns the lines when ``lines`` were given."""
        keep = lines is not None
        if lines is None:
            lines = self._input_lines()
        sents = encode_lines(lines, self.src_vocab,
                             int(self.options.get("max-length", 1000)))
        out_path = self.options.get("output", "stdout")
        close = False
        if stream is None:
            if out_path in ("stdout", "-"):
                stream = sys.stdout
            else:
                stream = open(out_path, "w", encoding="utf-8")
                close = True
        collector = OutputCollector(stream)
        by_sid: Dict[int, str] = {}
        try:
            for batch in batches(
                    sents, int(self.options.get("mini-batch", 32) or 32),
                    int(self.options.get("maxi-batch", 100) or 1),
                    str(self.options.get("maxi-batch-sort", "src")),
                    int(self.options.get("mini-batch-words", 0) or 0)):
                nbests = self.search.search(batch.ids, batch.mask)
                for row in range(batch.size):
                    sid = int(batch.sentence_ids[row])
                    text = self.printer.line(sid, nbests[row])
                    if keep:
                        by_sid[sid] = text
                    collector.write(sid, text)
            collector.flush_remaining()
        finally:
            if close:
                stream.close()
        return [by_sid[s] for s in sorted(by_sid)] if keep else []


def translate_main(options) -> None:
    Translate(options).run()
