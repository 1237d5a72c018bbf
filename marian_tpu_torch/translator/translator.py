"""The translation entry point, ported from
``marian_tpu/translator/translator.py`` (reference src/translator/
translator.h :: Translate<BeamSearch>::run) for one model.

Loads the model, vocabs and ``--shortlist``, batches the input
(maxi-batch length sort, ``--mini-batch`` sentences or the
``--mini-batch-words`` token budget), runs the beam search batch by
batch on the resolved device (one shortlist a batch, from the union of
its source words), and writes translations in input order.

Every device batch counts in the reference's decode series on the
process-wide metrics registry (``marian_translate_batches_total``,
``marian_translate_sentences_total``, ``marian_translate_batch_fill_ratio``
over the padded batch), which a request-mode server's ``/metrics``
shows beside its scheduler's.

``--force-decode`` reads two ``--input`` files, the source and one
target prefix a line (an empty line: unconstrained), as the reference
does; lines given to ``run`` (the request-mode server's) carry the
prefix after a TAB, ``source<TAB>prefix``, the iteration engines' wire
convention (translator/decode_features.py).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..common import io as mio
from ..common import logging as log
from ..convert import params_from_numpy
from ..data.batching import batches, encode_lines
from ..data.shortlist import parse_shortlist_options
from ..data.vocab import create_vocab
from ..device import resolve_device
from ..models.encoder_decoder import apply_embedded_config, create_model
from ..serving import metrics as msm
from .beam_search import BeamSearch
from .output_collector import OutputCollector, OutputPrinter

# option → value at which the feature is off; set to anything else the
# decoder refuses to start instead of ignoring it
_UNPORTED = {
    "alignment": None,
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
        self.shortlist_gen = parse_shortlist_options(
            self.options.get("shortlist", []), self.src_vocab,
            self.trg_vocab)
        self.force_decode = bool(self.options.get("force-decode", False))
        self.printer = OutputPrinter(self.options, self.trg_vocab)
        self._m_batches = msm.counter(
            "marian_translate_batches_total", "Device batches decoded")
        self._m_sentences = msm.counter(
            "marian_translate_sentences_total", "Sentences decoded")
        self._m_fill = msm.histogram(
            "marian_translate_batch_fill_ratio",
            "Real source tokens / padded device-batch capacity",
            buckets=msm.RATIO_BUCKETS)
        log.info("Translating on {} with {}", self.device, model_path)

    def _read(self, path: str) -> List[str]:
        if path in ("stdin", "-"):
            return [l.rstrip("\n") for l in sys.stdin]
        with open(path, "r", encoding="utf-8") as fh:
            return [l.rstrip("\n") for l in fh]

    def _input_lines(self) -> List[str]:
        """The source lines of --input; under --force-decode each with
        its prefix line from the second --input file after a TAB."""
        inputs = self.options.get("input", ["stdin"])
        paths = inputs if isinstance(inputs, list) else [inputs]
        if not self.force_decode:
            return self._read(paths[0])
        if len(paths) != 2:
            raise ValueError(f"model expects 2 --input files (1 source + "
                             f"target prefix), got {len(paths)}")
        src, pfx = self._read(paths[0]), self._read(paths[1])
        if len(pfx) != len(src):
            raise ValueError(
                f"--force-decode: prefix file has {len(pfx)} lines but the "
                f"source has {len(src)} — one (possibly empty) prefix line "
                f"per source sentence required")
        return [f"{s}\t{p}" for s, p in zip(src, pfx)]

    def _split_prefixes(self, lines: List[str]):
        """(source lines, per line its forced target prefix ids, encoded
        without EOS so the hypothesis goes on past it)."""
        srcs, prefixes = [], []
        for line in lines:
            src, _, pfx = line.partition("\t")
            srcs.append(src)
            prefixes.append(self.trg_vocab.encode(pfx, add_eos=False)
                            if pfx.strip() else [])
        return srcs, prefixes

    def _batch_features(self, batch, prefixes):
        """The batch's shortlist (the union of its real source ids) and
        its [rows, P] prefix matrix (-1 pad), each None when off."""
        shortlist = None
        if self.shortlist_gen is not None:
            shortlist = self.shortlist_gen.generate(
                np.unique(batch.ids[batch.mask > 0]))
        prefix = None
        if prefixes is not None:
            sids = [int(s) for s in batch.sentence_ids if s >= 0]
            plen = max([1] + [len(prefixes[s]) for s in sids])
            prefix = np.full((batch.ids.shape[0], plen), -1, np.int64)
            for row, sid in enumerate(sids):
                prefix[row, :len(prefixes[sid])] = prefixes[sid]
        return shortlist, prefix

    def run(self, lines: Optional[List[str]] = None, stream=None) -> List[str]:
        """Translate ``lines`` (or --input) and write to ``stream`` (or
        --output); returns the lines when ``lines`` were given."""
        keep = lines is not None
        if lines is None:
            lines = self._input_lines()
        prefixes = None
        if self.force_decode:
            lines, prefixes = self._split_prefixes(lines)
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
                shortlist, prefix = self._batch_features(batch, prefixes)
                self._m_batches.inc()
                self._m_sentences.inc(batch.size)
                self._m_fill.observe(float(batch.mask.sum())
                                     / max(batch.ids.size, 1))
                nbests = self.search.search(batch.ids, batch.mask,
                                            shortlist=shortlist,
                                            prefix=prefix)
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
