"""EncoderDecoder: the model-level decode API (``encode_for_decode``,
``start_state``, ``step``), ported from
``marian_tpu/models/encoder_decoder.py`` for ``--type transformer``.
Parameters are passed in on every call, as in the reference; they are
already in the compute dtype (``convert.params_from_numpy``).
"""

from __future__ import annotations

from typing import Optional

import yaml

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

    def step(self, params, state, prev_ids, src_mask, beam_src=None):
        return T.decode_step(self.cfg, params, state, prev_ids, src_mask,
                             beam_src=beam_src)


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
