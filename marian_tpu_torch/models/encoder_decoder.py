"""EncoderDecoder: the model-level API, ported from
``marian_tpu/models/encoder_decoder.py`` for ``--type transformer``:
``loss`` (the teacher-forced training graph) and the decode API
(``encode_for_decode``, ``start_state``, ``step``). Parameters are passed
in on every call, as in the reference.

The loss takes the fused CE (``ops/kernels/fused_ce.py``) under
``--fused-ce``: ``auto`` engages it on the card, where the CUDA kernels
run; on the CPU ``auto`` stays dense, as the reference's does off the
TPU, and ``on`` runs the kernels' plain versions. As in the reference,
the fused CE is skipped when --unlikelihood-loss meets data weights: the
dense logits then go through ``layers/loss.py``. Under
--guided-alignment a batch that carries the alignment matrix adds the
guided cost (``layers/loss.guided_alignment_loss``) of the alignment
layer's cross-attention weights, at label scale for --multi-loss-type
sum and scaled, per label for mean.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import yaml

from ..layers.loss import (RationalLoss, cross_entropy_loss,
                           guided_alignment_loss, weighted_loss)
from ..ops.kernels.fused_ce import fused_softmax_xent
from . import transformer as T


class EncoderDecoder:
    def __init__(self, options, src_vocab: int, trg_vocab: int):
        self.options = options
        self.model_type = options.get("type", "transformer")
        if self.model_type != "transformer":
            raise NotImplementedError(
                f"--type {self.model_type} is not ported to marian_tpu_torch "
                f"yet (this slice decodes --type transformer; ROADMAP A7)")
        self.cfg = T.config_from_options(options, src_vocab, trg_vocab)
        self.label_smoothing = float(options.get("label-smoothing", 0.0)
                                     or 0.0)
        self.fused_ce_mode = str(options.get("fused-ce", "auto") or "auto")
        if self.fused_ce_mode not in ("auto", "on", "off"):
            raise ValueError(f"--fused-ce {self.fused_ce_mode}: auto, on or "
                             f"off")
        self.guided_weight = float(options.get("guided-alignment-weight",
                                               0.1))
        self.multi_loss_type = str(options.get("multi-loss-type", "sum")
                                   or "sum")
        self.unlikelihood = bool(options.get("unlikelihood-loss", False))
        self.guided_cost = str(options.get("guided-alignment-cost", "ce"))
        ga = options.get("guided-alignment", "none")
        self.use_guided = bool(ga and ga != "none")

    # -- training graph (reference: EncoderDecoder::build + costs.h) --------
    def loss(self, params, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             train: bool = True):
        """(summed CE plus the guided cost, aux dict with ce_sum / labels,
        and ``guided`` when it was added) of one batch; dropout masks come
        from ``generator``."""
        cparams = T.cast_params(params, self.cfg.compute_dtype)
        src_mask = batch["src_mask"]
        enc_out = T.encode(self.cfg, cparams, batch["src_ids"], src_mask,
                           train, generator)
        want_align = self.use_guided and "guided" in batch
        table = self._fused_ce_table(cparams, enc_out.device)
        hidden = T.decode_train(self.cfg, cparams, enc_out, src_mask,
                                batch["trg_ids"], batch["trg_mask"], train,
                                generator, return_hidden=table is not None,
                                return_alignment=want_align)
        align = None
        if want_align:
            hidden, align = hidden
        if table is not None and not (self.unlikelihood
                                      and "data_weights" in batch):
            rl = self._fused_ce_loss(cparams, table, hidden, batch)
        else:
            if table is not None:      # the fused CE skipped: unlikelihood
                hidden = T.output_logits(self.cfg, cparams, hidden)
            rl = cross_entropy_loss(hidden, batch["trg_ids"],
                                    batch["trg_mask"], self.label_smoothing,
                                    batch.get("data_weights"),
                                    unlikelihood=self.unlikelihood)
        total = rl.loss_sum
        aux = {"ce_sum": rl.loss_sum, "labels": rl.labels}
        if align is not None:
            ga = guided_alignment_loss(align, batch["guided"],
                                       batch["trg_mask"], self.guided_cost)
            # --multi-loss-type (reference: MultiRationalLoss): sum and
            # scaled add the guided cost at the CE's label count (both
            # counts are the target labels, so scaled's factor is 1);
            # mean adds the per-label mean
            if self.multi_loss_type == "mean":
                total = total + self.guided_weight * ga
            else:
                total = total + self.guided_weight * ga * rl.labels
            aux["guided"] = ga
        return total, aux

    def _fused_ce_table(self, cparams, device: torch.device):
        """[V, E] output table when the fused CE applies, else None (dense
        logits + layers/loss.py). On the card the kernels take every
        hidden size, so ``auto`` and ``on`` never go dense there."""
        if self.fused_ce_mode == "off" or (self.fused_ce_mode == "auto"
                                           and device.type != "cuda"):
            return None
        return T._plain_output_table(self.cfg, cparams)

    def _fused_ce_loss(self, cparams, table, hidden, batch) -> RationalLoss:
        """Label-smoothed CE straight from the decoder's hidden states; the
        logits exist only tile by tile inside the kernels."""
        b, t, e = hidden.shape
        bias = cparams.get("decoder_ff_logit_out_b")
        bias = (bias.reshape(-1) if bias is not None
                else torch.zeros(table.shape[0], device=hidden.device))
        ce = fused_softmax_xent(hidden.reshape(b * t, e), table, bias,
                                batch["trg_ids"].reshape(-1),
                                self.label_smoothing)
        return weighted_loss(ce.reshape(b, t), batch["trg_mask"],
                             batch.get("data_weights"))

    @property
    def beam_carried_suffixes(self):
        return T.BEAM_CARRIED_SUFFIXES

    @property
    def fused_decode_reorder(self) -> bool:
        """True when the fused decode kernel owns the beam reorder of the
        self-attention caches: the beam search then passes pending
        backpointers into step() (beam_src) instead of gathering the
        cache leaves itself."""
        return T.fused_decode_active(self.cfg)

    def encode_for_decode(self, params, src_ids, src_mask):
        return T.encode(self.cfg, params, src_ids, src_mask)

    def start_state(self, params, enc_out, src_mask, max_len: int):
        return T.init_decode_state(self.cfg, params, enc_out, src_mask,
                                   max_len)

    def start_paged_state(self, params, enc_out, src_mask, n_pages: int,
                          page_len: int, max_pages: int):
        """Decode state over a paged KV pool (iteration-level decoding;
        see ``transformer.init_paged_decode_state``). Its ``page_table``
        and ``pos`` are per row and owned by the caller's slot engine
        (translator/iteration.py)."""
        return T.init_paged_decode_state(self.cfg, params, enc_out,
                                         src_mask, n_pages, page_len,
                                         max_pages)

    def step(self, params, state, prev_ids, src_mask, beam_src=None,
             shortlist=None):
        return T.decode_step(self.cfg, params, state, prev_ids, src_mask,
                             beam_src=beam_src, shortlist=shortlist)


def create_model(options, src_vocab: int, trg_vocab: int) -> EncoderDecoder:
    """Model factory (reference: models::createModelFromOptions)."""
    return EncoderDecoder(options, src_vocab, trg_vocab)


ARCH_KEY_PREFIXES = ("transformer", "enc-", "dec-", "dim-", "tied-",
                     "factors-", "lemma-", "input-types", "bert-", "char-",
                     "ulr")
ARCH_KEYS = ("type", "skip", "layer-normalization", "right-left",
             "max-length")


def apply_embedded_config(options, config_yaml: Optional[str]):
    """Overlay the architecture part of a checkpoint's embedded
    special:model.yml onto runtime options (disabled by
    --ignore-model-config), as the reference does."""
    if not config_yaml or options.get("ignore-model-config", False):
        return options
    emb = yaml.safe_load(config_yaml) or {}
    keys = [k for k in emb
            if k.startswith(ARCH_KEY_PREFIXES) or k in ARCH_KEYS]
    return options.with_(**{k: emb[k] for k in keys})


def batch_to_arrays(batch, device) -> Dict[str, torch.Tensor]:
    """CorpusBatch → dict of tensors on ``device`` for ``loss``: int64 ids
    and f32 masks per stream, plus the guided-alignment matrix
    (``guided``) and the data weights when present."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype, non_blocking=True)

    out = {"src_ids": put(batch.src.ids, torch.long),
           "src_mask": put(batch.src.mask, torch.float32),
           "trg_ids": put(batch.trg.ids, torch.long),
           "trg_mask": put(batch.trg.mask, torch.float32)}
    if batch.guided_alignment is not None:
        out["guided"] = put(batch.guided_alignment, torch.float32)
    if batch.data_weights is not None:
        out["data_weights"] = put(batch.data_weights, torch.float32)
    return out
