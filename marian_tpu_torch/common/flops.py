"""Analytic FLOPs accounting and the card's peaks, ported from
``marian_tpu/common/flops.py``: the cost functions price a transformer
train step and a served batch in matmul FLOPs from the batch shapes;
the peak tables map a CUDA device name to its data-sheet peaks, for the
perf plane's MFU gauge (obs/perf.py).

Conventions (PaLM-appendix style "model FLOPs"):
- only matmul work is counted (elementwise/softmax/norms are
  bandwidth-bound noise beside the matmuls);
- a matmul [m,k]x[k,n] costs 2*m*k*n;
- token counts are REAL (mask-counted) tokens — padding rows burn
  cycles but do no useful work, so they lower MFU, which is the point;
- attention-score terms use the PADDED sequence width: each real token
  genuinely attends over the padded row on the device;
- causal self-attention is priced at full width (no causal-sparsity
  discount);
- train = 3x forward (activation grads + weight grads each replay every
  forward matmul once).

The peaks are the H100 SXM data sheet's, the constants chip_smoke.py
bounds its kernels by: 989e12 dense bf16 FLOPs/s on the tensor cores,
67e12 f32 FLOPs/s outside them (the port runs f32 with TF32 off), and
3.35e12 bytes/s of HBM. The reference's TPU tables, its decode-step
roofline (``decode_step_cost``, ``decode_step_time``) and its
decode-lever advisor (``decode_defaults_hint``, ``decode_lever_report``,
which price int8 TPU weights) are not carried.
"""

from __future__ import annotations

from typing import Optional


def transformer_train_flops(emb: int, ffn: int, enc_depth: int,
                            dec_depth: int, vocab: int,
                            src_tokens: float, trg_tokens: float,
                            src_width: int, trg_width: int) -> float:
    """Matmul FLOPs for ONE training step (fwd+bwd) of an encoder-decoder
    transformer on a batch with the given real token counts and padded
    widths. Tied embeddings are assumed (the output projection is the
    only embedding matmul priced; input embedding is a gather)."""
    d, f = float(emb), float(ffn)
    # encoder layer, per src token: QKV+out projections (4 matmuls of
    # d x d) + FFN (d x f, f x d); scores+values: QK^T and AV, each
    # 2*width*d per token.
    enc_tok = 8 * d * d + 4 * d * f + 4 * src_width * d
    enc = enc_depth * src_tokens * enc_tok
    # decoder layer: self-attn like the encoder (trg width); cross-attn
    # Q+out projections per trg token, K+V projections per SRC token
    # (computed once over encoder output), scores over src width.
    dec_tok = (8 * d * d + 4 * trg_width * d      # self-attn
               + 4 * d * d + 4 * src_width * d    # cross-attn Q/out+scores
               + 4 * d * f)                       # FFN
    dec_kv = 4 * d * d * src_tokens               # cross K/V per src token
    dec = dec_depth * (trg_tokens * dec_tok + dec_kv)
    logits = 2 * d * float(vocab) * trg_tokens
    return 3.0 * (enc + dec + logits)


def transformer_serve_flops(emb: int, ffn: int, enc_depth: int,
                            dec_depth: int, vocab: int,
                            src_tokens: float, trg_tokens: float,
                            src_width: int, trg_width: int,
                            beam: int = 1) -> float:
    """Matmul FLOPs for serving ONE batch: encoder forward over the real
    source tokens plus incremental beam decode of the real target
    tokens. The live-MFU companion of :func:`transformer_train_flops`
    (obs/perf.py).

    Conventions as above (real tokens, padded widths for attention
    spans), plus decode-specifics:
    - every generated target token is paid ``beam`` times (each beam
      hypothesis runs the full decoder stack per step);
    - self-attention over the growing cache is priced at the AVERAGE
      past length ``trg_width/2`` (the cache grows 0..trg_width);
    - cross K/V projections are paid once per source token (cached);
    - the output projection prices the full vocab (no shortlist
      discount — the gauge should read LOW when a shortlist would
      help, same reasoning as padding lowering MFU).
    """
    d, f = float(emb), float(ffn)
    enc_tok = 8 * d * d + 4 * d * f + 4 * src_width * d
    enc = enc_depth * src_tokens * enc_tok
    dec_tok = (8 * d * d + 4 * (trg_width / 2.0) * d   # self + cache
               + 4 * d * d + 4 * src_width * d         # cross Q/out+scores
               + 4 * d * f)                            # FFN
    rows = max(1, int(beam))
    dec = dec_depth * (trg_tokens * rows * dec_tok
                       + 4 * d * d * src_tokens)       # cross K/V once
    logits = 2 * d * float(vocab) * trg_tokens * rows
    return enc + dec + logits


# Data-sheet peaks per CUDA device, matched as a lower-case substring of
# torch.cuda.get_device_name(); None = an unknown device (MFU reads 0).
_PEAK_BF16 = (("h100", 989e12),)
_PEAK_F32 = (("h100", 67e12),)
_HBM_BW = (("h100", 3.35e12),)


def _lookup(table, device_kind: str) -> Optional[float]:
    kind = (device_kind or "").lower()
    for tag, value in table:
        if tag in kind:
            return value
    return None


def peak_bf16_flops(device_kind: str) -> Optional[float]:
    """Peak dense bf16 FLOPs/s of the named CUDA device (tensor cores),
    or None for an unknown name (the CPU always)."""
    return _lookup(_PEAK_BF16, device_kind)


def peak_f32_flops(device_kind: str) -> Optional[float]:
    """Peak f32 FLOPs/s outside the tensor cores (TF32 off), or None."""
    return _lookup(_PEAK_F32, device_kind)


def peak_flops(device_kind: str, dtype: str = "float32") -> Optional[float]:
    """The peak of a model's compute dtype: bf16 under ``--precision
    bfloat16``, f32 otherwise."""
    if str(dtype).replace("torch.", "") in ("bfloat16", "bf16"):
        return peak_bf16_flops(device_kind)
    return peak_f32_flops(device_kind)


def hbm_bandwidth(device_kind: str) -> Optional[float]:
    """HBM bytes/s of the named CUDA device, or None."""
    return _lookup(_HBM_BW, device_kind)
