"""Transformer encoder-decoder, training and inference, as plain functions
over a flat parameter dict, ported from the default-config part of
``marian_tpu/models/transformer.py``.

- Parameters keep Marian's flat names (``encoder_l1_self_Wq``, ``Wemb``,
  ``decoder_ff_logit_out_b``, ...) and Marian's [in, out] weight layout,
  applied as ``x @ W``; ``convert.params_from_numpy`` makes them tensors.
- Pre/post-process strings follow Marian: 'a' residual add, 'n'
  layer-norm, 'd' dropout (``--transformer-dropout``) when training. FFN
  dropout (``--transformer-dropout-ffn``), attention dropout
  (``--transformer-dropout-attention``, which sends attention to the dense
  path, as in the reference) and whole-word dropout (``--dropout-src``,
  ``--dropout-trg``) also apply only when training. Every mask is drawn
  from an explicit ``torch.Generator`` passed down from the trainer.
- Training decodes with teacher forcing (``decode_train``): the gold
  target embeddings shifted right, a causal self-attention with the target
  mask as key mask, and cross-attention with the source mask as key mask:
  the structured masks the flash and packed attention kernels take.
- A Python loop over layers stands in for the reference's --scan-layers.
  Under --gradient-checkpointing each layer runs in training under
  ``torch.utils.checkpoint`` (non-reentrant), its activations recomputed
  in the backward; the recompute draws its dropout masks from a copy of
  the layer's generator state at entry, so its masks are the forward's
  and the gradients are those of a run without checkpointing, bit for
  bit (``_layer``). Guided alignment's layer is not checkpointed.
- ``decode_train(..., return_alignment=True)`` also returns the
  head-averaged cross-attention weights [B, Tt, Ts] of the
  --transformer-guided-alignment-layer (``last`` or a 1-based number):
  that one cross-attention takes the dense path, since no kernel returns
  weights; every other attention keeps its kernel.
- --transformer-depth-scaling scales layer l's Glorot bound by
  1/sqrt(l); --output-omit-bias leaves out ``decoder_ff_logit_out_b``.
- Incremental decoding keeps fixed-size [B, H, L, Dh] self-attention
  caches. With the fused decode kernel the beam reorder is folded into
  the kernel's cache read (``beam_src``) and the kernel writes the next
  cache into a second buffer per layer (ping-pong, no allocation per
  step); without it the step writes its k/v into the cache in place.
- Paged decoding (iteration-level serving, ``init_paged_decode_state``)
  replaces those caches by per-layer page pools shared by all rows, one
  page table and a per-row position vector; the step inserts into the
  pools in place and reads through ``paged_decode_attention``.

Not ported yet (ROADMAP A7): MoE, ULR, AAN/SSRU decoders, factors and
lemma, multi-source, learned positions, tied layers, LSH, int8 weights,
the sequence/tensor-parallel branches. ``config_from_options`` refuses
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import MAX_HEAD_SIZE
from ..ops.kernels.kv_pool import paged_decode_attention, state_key_groups
from ..ops.ops import (activation, affine, dropout, layer_norm,
                       logits_matmul, scalar)

Params = Dict[str, torch.Tensor]

# decode-state keys with these suffixes are per-beam: the beam search
# reorders them by backpointers unless the fused kernel does it
BEAM_CARRIED_SUFFIXES = ("_self_k", "_self_v")

_DTYPES = {"float32": torch.float32, "float16": torch.bfloat16,
           "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static model hyperparameters of the decode slice."""
    src_vocab: int
    trg_vocab: int
    dim_emb: int = 512
    heads: int = 8
    dim_ffn: int = 2048
    dec_dim_ffn: int = 0            # 0 → dim_ffn
    ffn_depth: int = 2
    dec_ffn_depth: int = 0          # 0 → ffn_depth
    enc_depth: int = 6
    dec_depth: int = 6
    ffn_activation: str = "relu"
    preprocess: str = ""
    postprocess: str = "dan"
    postprocess_emb: str = "d"
    postprocess_top: str = ""
    tied_embeddings: bool = False
    tied_embeddings_src: bool = False
    tied_embeddings_all: bool = True
    no_projection: bool = False
    flash_attention: str = "auto"           # auto (T >= 1024) | on | off
    packed_attention: str = "auto"          # auto | on | off (CUDA kernel)
    fused_decode_attention: str = "auto"    # auto | on | off (CUDA kernel)
    compute_dtype: torch.dtype = torch.float32
    dropout: float = 0.0                    # between-layer (pre/post 'd')
    attention_dropout: float = 0.0
    ffn_dropout: float = 0.0
    dropout_src: float = 0.0                # whole-word dropout
    dropout_trg: float = 0.0
    depth_scaling: bool = False             # --transformer-depth-scaling
    output_omit_bias: bool = False          # --output-omit-bias
    gradient_checkpointing: bool = False    # recompute layers in backward
    guided_alignment_layer: str = "last"    # 'last' or a 1-based layer

    @property
    def dim_head(self) -> int:
        return self.dim_emb // self.heads

    @property
    def dec_ffn(self) -> int:
        return self.dec_dim_ffn or self.dim_ffn

    @property
    def dec_ffn_d(self) -> int:
        return self.dec_ffn_depth or self.ffn_depth


# option → value at which the feature is off; anything else is refused
_UNPORTED = {
    "transformer-decoder-autoreg": "self-attention",
    "transformer-tied-layers": [],
    "transformer-train-position-embeddings": False,
    "transformer-moe-experts": 0,
    "factors-dim-emb": 0,
    "lemma-dim-emb": 0,
    "ulr": False,
    "output-approx-knn": [],
    "sequence-parallel": "none",
}


def config_from_options(options, src_vocab: int,
                        trg_vocab: int) -> TransformerConfig:
    """Map Marian flags → TransformerConfig (the reference's
    ``config_from_options`` for inference, default-config features)."""
    g = options.get
    for name, off in _UNPORTED.items():
        val = g(name, None)
        if val is None or val == off or (not isinstance(off, str)
                                         and not val):
            continue
        raise NotImplementedError(
            f"--{name} {val} is not ported to marian_tpu_torch yet "
            f"(ROADMAP A7)")
    precision = g("precision", ["float32"])
    compute = precision[0] if isinstance(precision, list) else precision
    cfg = TransformerConfig(
        src_vocab=int(src_vocab),
        trg_vocab=int(trg_vocab),
        dim_emb=int(g("dim-emb", 512)),
        heads=int(g("transformer-heads", 8)),
        dim_ffn=int(g("transformer-dim-ffn", 2048)),
        dec_dim_ffn=int(g("transformer-decoder-dim-ffn", 0)),
        ffn_depth=int(g("transformer-ffn-depth", 2)),
        dec_ffn_depth=int(g("transformer-decoder-ffn-depth", 0)),
        enc_depth=int(g("enc-depth", 6)),
        dec_depth=int(g("dec-depth", 6)),
        ffn_activation=str(g("transformer-ffn-activation", "relu")),
        preprocess=str(g("transformer-preprocess", "")),
        postprocess=str(g("transformer-postprocess", "dan")),
        postprocess_emb=str(g("transformer-postprocess-emb", "d")),
        postprocess_top=str(g("transformer-postprocess-top", "")),
        tied_embeddings=bool(g("tied-embeddings", False)),
        tied_embeddings_src=bool(g("tied-embeddings-src", False)),
        tied_embeddings_all=bool(g("tied-embeddings-all", False)),
        no_projection=bool(g("transformer-no-projection", False)),
        flash_attention=str(g("transformer-flash-attention", "auto")),
        packed_attention=str(g("transformer-packed-attention", "auto")),
        fused_decode_attention=str(
            g("transformer-fused-decode-attention", "auto")),
        compute_dtype=_DTYPES.get(str(compute), torch.float32),
        dropout=float(g("transformer-dropout", 0.0) or 0.0),
        attention_dropout=float(g("transformer-dropout-attention", 0.0)
                                or 0.0),
        ffn_dropout=float(g("transformer-dropout-ffn", 0.0) or 0.0),
        dropout_src=float(g("dropout-src", 0.0) or 0.0),
        dropout_trg=float(g("dropout-trg", 0.0) or 0.0),
        depth_scaling=bool(g("transformer-depth-scaling", False)),
        output_omit_bias=bool(g("output-omit-bias", False)),
        gradient_checkpointing=bool(g("gradient-checkpointing", False)),
        guided_alignment_layer=str(
            g("transformer-guided-alignment-layer", "last")),
    )
    # the flash kernels are built up to MAX_HEAD_SIZE (smaller head sizes
    # run zero-padded to a built one); 'auto' routes larger ones dense
    if cfg.flash_attention == "on" and cfg.dim_head > MAX_HEAD_SIZE:
        raise NotImplementedError(
            f"--transformer-flash-attention on at head size {cfg.dim_head} "
            f"(--dim-emb {cfg.dim_emb} / --transformer-heads {cfg.heads}) is "
            f"not ported to marian_tpu_torch yet: the flash kernels are built "
            f"up to head size {MAX_HEAD_SIZE} (use auto, which takes the "
            f"dense path there)")
    return cfg


# ---------------------------------------------------------------------------
# Initialization (names follow the reference's init_params)
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int) -> Params:
    """Glorot-uniform weights, zero biases, unit layer-norm scales, made
    on the CPU from ``seed`` with an explicit torch.Generator (f32).
    Under --transformer-depth-scaling layer l's attention and FFN bounds
    are scaled by 1/sqrt(l), as the reference scales them."""
    gen = torch.Generator().manual_seed(int(seed))
    d = cfg.dim_emb
    p: Params = {}

    def glorot(shape, layer: int = 0):
        scale = 1.0 / math.sqrt(layer) if (cfg.depth_scaling and layer) \
            else 1.0
        limit = scale * math.sqrt(6.0 / (shape[0] + shape[-1]))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit

    def ln(prefix):
        if "n" in cfg.preprocess or "n" in cfg.postprocess:
            p[f"{prefix}_ln_scale"] = torch.ones(1, d)
            p[f"{prefix}_ln_bias"] = torch.zeros(1, d)

    def attn_block(prefix, layer):
        for n in ("q", "k", "v") + (() if cfg.no_projection else ("o",)):
            p[f"{prefix}_W{n}"] = glorot((d, d), layer)
            p[f"{prefix}_b{n}"] = torch.zeros(1, d)
        ln(f"{prefix}_Wo")

    def ffn_block(prefix, dim_ffn, depth, layer):
        dims = [d] + [dim_ffn] * (depth - 1) + [d]
        for i in range(depth):
            p[f"{prefix}_W{i + 1}"] = glorot((dims[i], dims[i + 1]), layer)
            p[f"{prefix}_b{i + 1}"] = torch.zeros(1, dims[i + 1])
        ln(f"{prefix}_ffn")

    if cfg.tied_embeddings_all or cfg.tied_embeddings_src:
        if cfg.src_vocab != cfg.trg_vocab:
            raise ValueError("tied src embeddings require equal vocab sizes")
        p["Wemb"] = glorot((cfg.trg_vocab, d))
    else:
        p["encoder_Wemb"] = glorot((cfg.src_vocab, d))
        p["decoder_Wemb"] = glorot((cfg.trg_vocab, d))
    for side in ("encoder", "decoder"):
        if "n" in cfg.postprocess_emb:
            p[f"{side}_emb_ln_scale"] = torch.ones(1, d)
            p[f"{side}_emb_ln_bias"] = torch.zeros(1, d)
    for l in range(1, cfg.enc_depth + 1):
        attn_block(f"encoder_l{l}_self", l)
        ffn_block(f"encoder_l{l}_ffn", cfg.dim_ffn, cfg.ffn_depth, l)
    for l in range(1, cfg.dec_depth + 1):
        attn_block(f"decoder_l{l}_self", l)
        attn_block(f"decoder_l{l}_context", l)
        ffn_block(f"decoder_l{l}_ffn", cfg.dec_ffn, cfg.dec_ffn_d, l)
    if "n" in cfg.postprocess_top or "n" in cfg.preprocess:
        for side in ("encoder", "decoder"):
            p[f"{side}_top_ln_scale"] = torch.ones(1, d)
            p[f"{side}_top_ln_bias"] = torch.zeros(1, d)
    if not (cfg.tied_embeddings_all or cfg.tied_embeddings):
        p["decoder_ff_logit_out_W"] = glorot((d, cfg.trg_vocab))
    if not cfg.output_omit_bias:
        p["decoder_ff_logit_out_b"] = torch.zeros(1, cfg.trg_vocab)
    return p


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _pre_post(cfg: TransformerConfig, ops: str, x: torch.Tensor,
              residual: Optional[torch.Tensor], prefix: str, params: Params,
              train: bool = False, generator=None) -> torch.Tensor:
    """Apply a Marian process string ('d','a','n') to x."""
    for op in ops:
        if op == "d":
            if train:
                x = dropout(x, cfg.dropout, generator)
        elif op == "a":
            if residual is not None:
                x = x + residual
        elif op == "n":
            x = layer_norm(x, params[f"{prefix}_ln_scale"],
                           params[f"{prefix}_ln_bias"])
        else:
            raise ValueError(f"Unknown process op '{op}'")
    return x


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def fused_decode_active(cfg: TransformerConfig) -> bool:
    """Whether the fused decode kernel handles the cached self-attention
    step. 'auto' engages wherever a beam reorder exists to fold: on the
    card the CUDA kernel runs, on the CPU its plain version, so both run
    the same pending-backpointer contract."""
    return cfg.fused_decode_attention != "off"


def _mha(cfg: TransformerConfig, params: Params, prefix: str,
         q_in: torch.Tensor, kv_in: Optional[torch.Tensor],
         mask: Optional[torch.Tensor],
         cache: Optional[Dict[str, torch.Tensor]] = None,
         cache_pos: Optional[int] = None, static_kv: bool = False,
         kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
         beam_src: Optional[torch.Tensor] = None, train: bool = False,
         generator=None,
         page_table: Optional[torch.Tensor] = None,
         return_weights: bool = False):
    """Multi-head attention with an optional decode cache; with
    ``return_weights`` it returns (output, the head-averaged [B, Tq, Tk]
    attention weights), from the dense path.

    cache (self-attention): 'k','v' [B,H,L,Dh] (+ 'spare_k','spare_v',
    the fused kernel's second buffers); this step's k/v land at
    cache_pos. static_kv (cross-attention): K/V precomputed in cache.
    beam_src [rows]: pending beam backpointers for the fused kernel.
    page_table [rows, MP]: cache 'k','v' are page pools
    [n_pages,H,page_len,Dh] and cache_pos the per-row [rows] positions
    (paged decoding; the pools are written in place).
    """
    h = cfg.heads

    def proj(x, n):
        return _split_heads(affine(x, params[f"{prefix}_W{n}"],
                                   params[f"{prefix}_b{n}"]), h)

    q = proj(q_in, "q")
    if static_kv:
        k_, v_ = cache["k"], cache["v"]
    else:
        k_, v_ = proj(kv_in, "k"), proj(kv_in, "v")
    out = None
    if cache is not None and not static_kv and page_table is not None:
        # the page table is row identity: no beam reorder exists here
        out = paged_decode_attention(q, k_, v_, cache["k"], cache["v"],
                                     page_table, cache_pos)
    elif cache is not None and not static_kv:
        use_fused = fused_decode_active(cfg) and (
            beam_src is not None or cfg.fused_decode_attention == "on")
        if use_fused:
            # gather + insert + attention read in one kernel; it writes
            # the next cache into the spare buffers, which swap roles
            out, nk, nv = decode_attention(
                q, k_, v_, cache["k"], cache["v"], cache_pos,
                src_rows=beam_src, out_k=cache.get("spare_k"),
                out_v=cache.get("spare_v"))
            if "spare_k" in cache:
                cache["spare_k"], cache["spare_v"] = cache["k"], cache["v"]
            cache["k"], cache["v"] = nk, nv
        else:
            cache["k"][:, :, cache_pos] = k_[:, :, 0].to(cache["k"].dtype)
            cache["v"][:, :, cache_pos] = v_[:, :, 0].to(cache["v"].dtype)
            k_, v_ = cache["k"], cache["v"]
    weights = None
    if out is None:
        out, weights = attention(q, k_, v_, mask, kv_mask=kv_mask,
                                 causal=causal, return_weights=return_weights,
                                 flash=cfg.flash_attention,
                                 packed=cfg.packed_attention,
                                 dropout_rate=(cfg.attention_dropout if train
                                               else 0.0),
                                 generator=generator)
    if cfg.no_projection:
        out = _merge_heads(out)
    else:
        out = affine(_merge_heads(out), params[f"{prefix}_Wo"],
                     params[f"{prefix}_bo"])
    if return_weights:
        return out, weights.mean(dim=1)
    return out


def _ffn(cfg: TransformerConfig, params: Params, prefix: str,
         x: torch.Tensor, dim_ffn: int, depth: int, train: bool = False,
         generator=None) -> torch.Tensor:
    act = activation(cfg.ffn_activation)
    for i in range(depth):
        x = affine(x, params[f"{prefix}_W{i + 1}"], params[f"{prefix}_b{i + 1}"])
        if i < depth - 1:
            x = act(x)
            if train:
                x = dropout(x, cfg.ffn_dropout, generator)
    return x


def sinusoidal_positions(length: int, dim: int, start: int = 0,
                         device=None) -> torch.Tensor:
    """Tensor2tensor-style timing signal in f32: first half sin, second
    half cos (the reference's sinusoidal_positions_dynamic)."""
    pos = (torch.arange(length, dtype=torch.float32, device=device)
           + float(start))[:, None]
    half = dim // 2
    inv_freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                       device=device)
                         * (math.log(10000.0) / max(half - 1, 1)))
    angles = pos * inv_freq[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _embed_words(cfg: TransformerConfig, params: Params, ids: torch.Tensor,
                 side: str) -> torch.Tensor:
    """Token embedding * sqrt(dim) (reference: transformer.h embFactor)."""
    own = "encoder_Wemb" if side == "src" else "decoder_Wemb"
    if cfg.tied_embeddings_all or (cfg.tied_embeddings_src and side == "src") \
            or ("Wemb" in params and own not in params):
        table = params["Wemb"]
    else:
        table = params[own]
    x = table[ids].to(cfg.compute_dtype)
    return x * scalar(math.sqrt(cfg.dim_emb), x)


def _add_pos(cfg: TransformerConfig, x: torch.Tensor,
             start_pos=0) -> torch.Tensor:
    """x [.., t, D] plus the positions start_pos .. start_pos + t - 1;
    an [R] tensor ``start_pos`` gives each row of x [R, t, D] its own
    (iteration-level decoding: rows of different ages share a step)."""
    if torch.is_tensor(start_pos) and start_pos.dim() == 1:
        pos_ids = (torch.arange(x.shape[-2], device=x.device)[None, :]
                   + start_pos.to(x.device)[:, None])
        return x + _sinusoidal_rows(pos_ids, cfg.dim_emb).to(x.dtype)
    return x + sinusoidal_positions(x.shape[-2], cfg.dim_emb, start_pos,
                                    x.device).to(x.dtype)


def _sinusoidal_rows(pos_ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings of an [R, t] position grid, the values of
    ``sinusoidal_positions`` (same inv_freq expression) row by row."""
    pos = pos_ids.to(torch.float32)[..., None]              # [R, t, 1]
    half = dim // 2
    inv_freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                       device=pos_ids.device)
                         * (math.log(10000.0) / max(half - 1, 1)))
    angles = pos * inv_freq[None, None, :]                  # [R, t, half]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _word_dropout(x: torch.Tensor, rate: float, train: bool,
                  generator) -> torch.Tensor:
    """Whole-word dropout (reference: --dropout-src/--dropout-trg)."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = torch.empty(x.shape[:-1], dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - rate,
                                                   generator=generator)
    return x * keep[..., None].to(x.dtype)


def encode(cfg: TransformerConfig, params: Params, src_ids: torch.Tensor,
           src_mask: torch.Tensor, train: bool = False,
           generator=None) -> torch.Tensor:
    """[B, Ts] ids + mask → [B, Ts, D] encoder states."""
    x = _word_dropout(_embed_words(cfg, params, src_ids, "src"),
                      cfg.dropout_src, train, generator)
    x = _add_pos(cfg, x)
    kw = {"train": train, "generator": generator}
    x = _pre_post(cfg, cfg.postprocess_emb, x, None, "encoder_emb", params,
                  **kw)
    attn_mask = src_mask[:, None, None, :]

    def enc_layer(x, lp, gen):
        kw = {"train": train, "generator": gen}
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_self_Wo",
                        params, **kw)
        out = _mha(cfg, params, f"{lp}_self", pre, pre, attn_mask,
                   kv_mask=src_mask, **kw)
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_self_Wo", params,
                      **kw)
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_ffn_ffn",
                        params, **kw)
        out = _ffn(cfg, params, f"{lp}_ffn", pre, cfg.dim_ffn, cfg.ffn_depth,
                   **kw)
        return _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_ffn_ffn",
                         params, **kw)

    for l in range(1, cfg.enc_depth + 1):
        x = _layer(cfg, lambda x, gen, lp=f"encoder_l{l}": enc_layer(
            x, lp, gen), x, train, generator)
    return _pre_post(cfg, cfg.postprocess_top, x, None, "encoder_top",
                     params, **kw)


# ---------------------------------------------------------------------------
# Decoder, teacher-forced (training)
# ---------------------------------------------------------------------------

def shift_right_embeddings(x: torch.Tensor) -> torch.Tensor:
    """Target embeddings one step right, a zero vector at t=0: Marian's
    decoder start (no BOS token)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _layer(cfg: TransformerConfig, fn: Callable, x: torch.Tensor,
           train: bool, generator) -> torch.Tensor:
    """One layer, ``fn(x, generator)``. Under --gradient-checkpointing in
    training it runs through ``torch.utils.checkpoint``: only x is kept,
    and the backward recomputes the layer. ``preserve_rng_state`` covers
    the global generators only, and every dropout mask here comes from
    ``generator``; so its state is taken at entry, the forward advances
    ``generator`` as it would without checkpointing, and the recompute
    draws from a fresh generator set to that state: the same masks."""
    if not (cfg.gradient_checkpointing and train):
        return fn(x, generator)
    state = generator.get_state() if generator is not None else None
    calls = []

    def body(x):
        gen = generator
        if calls and generator is not None:         # the recompute
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        calls.append(1)
        return fn(x, gen)
    return checkpoint(body, x, use_reentrant=False,
                      preserve_rng_state=False)


def _is_alignment_layer(cfg: TransformerConfig, l: int) -> bool:
    gal = cfg.guided_alignment_layer
    if gal == "last":
        return l == cfg.dec_depth
    return l == int(gal)


def decode_train(cfg: TransformerConfig, params: Params,
                 enc_out: torch.Tensor, src_mask: torch.Tensor,
                 trg_ids: torch.Tensor, trg_mask: torch.Tensor,
                 train: bool = True, generator=None,
                 return_hidden: bool = False,
                 return_alignment: bool = False):
    """Teacher-forced decoder: [B, Tt] gold target ids → [B, Tt, V] f32
    logits, or the pre-logits hidden states when ``return_hidden`` (the
    fused CE computes the output projection itself). With
    ``return_alignment`` it returns (that, the alignment layer's
    head-averaged cross-attention weights [B, Tt, Ts])."""
    kw = {"train": train, "generator": generator}
    we = shift_right_embeddings(_embed_words(cfg, params, trg_ids, "trg"))
    we = _word_dropout(we, cfg.dropout_trg, train, generator)
    x = _add_pos(cfg, we)
    x = _pre_post(cfg, cfg.postprocess_emb, x, None, "decoder_emb", params,
                  **kw)
    tt = trg_ids.shape[1]
    causal = torch.tril(torch.ones((tt, tt), dtype=trg_mask.dtype,
                                   device=trg_mask.device))
    self_mask = causal[None, None] * trg_mask[:, None, None, :]
    cross_mask = src_mask[:, None, None, :]
    align = None

    def dec_layer(x, lp, gen, want_align=False):
        kw = {"train": train, "generator": gen}
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_self_Wo",
                        params, **kw)
        out = _mha(cfg, params, f"{lp}_self", pre, pre, self_mask,
                   kv_mask=trg_mask, causal=True, **kw)
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_self_Wo", params,
                      **kw)
        cname = f"{lp}_context"
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{cname}_Wo", params,
                        **kw)
        out = _mha(cfg, params, cname, pre, enc_out, cross_mask,
                   kv_mask=src_mask, return_weights=want_align, **kw)
        align_l = None
        if want_align:
            out, align_l = out
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{cname}_Wo", params,
                      **kw)
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_ffn_ffn",
                        params, **kw)
        out = _ffn(cfg, params, f"{lp}_ffn", pre, cfg.dec_ffn, cfg.dec_ffn_d,
                   **kw)
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_ffn_ffn", params,
                      **kw)
        return (x, align_l) if want_align else x

    for l in range(1, cfg.dec_depth + 1):
        if return_alignment and _is_alignment_layer(cfg, l):
            # the alignment layer runs as is: its weights leave the layer
            x, align = dec_layer(x, f"decoder_l{l}", generator, True)
        else:
            x = _layer(cfg, lambda x, gen, lp=f"decoder_l{l}": dec_layer(
                x, lp, gen), x, train, generator)
    x = _pre_post(cfg, cfg.postprocess_top, x, None, "decoder_top", params,
                  **kw)
    out = x if return_hidden else output_logits(cfg, params, x)
    return (out, align) if return_alignment else out


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating parameters in the compute dtype (the optimizer keeps f32;
    a no-op at f32)."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Output layer and incremental decoding
# ---------------------------------------------------------------------------

def _plain_output_table(cfg: TransformerConfig, params: Params):
    """The [V, E] output table: the tied embedding, or the transpose of
    the untied output weight (a view)."""
    if cfg.tied_embeddings_all:
        return params["Wemb"]
    if cfg.tied_embeddings:
        return params["Wemb"] if "Wemb" in params else params["decoder_Wemb"]
    return params["decoder_ff_logit_out_W"].t()


def output_logits(cfg: TransformerConfig, params: Params,
                  x: torch.Tensor,
                  shortlist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[.., D] decoder states → [.., V] f32 logits (tied embeddings: the
    table's transpose, a view, not a copy), by ``logits_matmul`` on the
    compute-dtype operands, as the reference computes them.

    ``shortlist``: a 1-D [K] index set (one per batch) takes the K
    columns of the table and the bias; a 2-D [R, K] one (a row's own
    set, the paged engines') needs [R, D] states and gives [R, K]."""
    if cfg.tied_embeddings_all:
        table = params["Wemb"]
    elif cfg.tied_embeddings:
        table = params["Wemb"] if "Wemb" in params else params["decoder_Wemb"]
    else:
        table = None
    b = params.get("decoder_ff_logit_out_b")
    if shortlist is not None and shortlist.dim() == 2:
        return _per_row_logits(table, params, x, b, shortlist)
    w = table.t() if table is not None else params["decoder_ff_logit_out_W"]
    if shortlist is not None:
        idx = shortlist.long()
        w = table[idx].t() if table is not None else w[:, idx]
        b = None if b is None else b[:, idx]
    y = logits_matmul(x, w.to(x.dtype))
    return y if b is None else y + b.float()


def per_row_gather_bytes(rows: int, k: int, vocab: int, dim: int,
                         itemsize: int) -> Tuple[int, int]:
    """Bytes the two forms of per-row shortlisted logits move: (the
    gathered [R, K, D] table rows, written then read; the whole [V, D]
    table read once plus the [R, V] f32 logits written and read)."""
    return (2 * rows * k * dim * itemsize,
            vocab * dim * itemsize + 2 * rows * vocab * 4)


def _per_row_logits(table, params: Params, x: torch.Tensor, b,
                    shortlist: torch.Tensor) -> torch.Tensor:
    """[R, D] states → [R, K] f32 logits at each row's own K coordinates,
    by whichever form moves fewer bytes (``per_row_gather_bytes``): the
    reference's gathered product over [R, K, D] table rows, or the full
    [R, V] product followed by a gather of each row's K columns."""
    if x.dim() != 2:
        raise ValueError("per-row [R, K] shortlist needs [R, d] "
                         "activations (single decode position)")
    rows_table = table if table is not None \
        else params["decoder_ff_logit_out_W"].t()          # [V, D]
    idx = shortlist.long()
    r, k = idx.shape
    gathered, full = per_row_gather_bytes(
        r, k, rows_table.shape[0], rows_table.shape[1],
        rows_table.element_size())
    if gathered <= full:
        wg = rows_table[idx].float()                        # [R, K, D]
        y = torch.bmm(wg, x.float()[:, :, None])[:, :, 0]
    else:
        y = logits_matmul(x, rows_table.t().to(x.dtype)).gather(1, idx)
    return y if b is None else y + b[0].float()[idx]


def cross_kv(cfg: TransformerConfig, params: Params, enc_out: torch.Tensor,
             layer: int):
    """Decoder layer ``layer``'s cross-attention K and V of the encoder
    states, stored contiguous [B, H, Ts, Dh]: as head-split views every
    step's score and context products would copy them whole."""
    cname = f"decoder_l{layer}_context"
    return tuple(_split_heads(affine(enc_out, params[f"{cname}_W{n}"],
                                     params[f"{cname}_b{n}"]),
                              cfg.heads).contiguous() for n in ("k", "v"))


def init_decode_state(cfg: TransformerConfig, params: Params,
                      enc_out: torch.Tensor, src_mask: torch.Tensor,
                      max_len: int) -> Dict[str, Any]:
    """Precompute cross-attention K/V (``cross_kv``) and allocate the
    fixed-size self-attention caches (plus the fused kernel's second
    buffers on the card)."""
    b = enc_out.shape[0]
    h, dh = cfg.heads, cfg.dim_head
    state: Dict[str, Any] = {"pos": 0}
    spares = enc_out.is_cuda and fused_decode_active(cfg)
    for l in range(1, cfg.dec_depth + 1):
        state[f"l{l}_cross_k"], state[f"l{l}_cross_v"] = cross_kv(
            cfg, params, enc_out, l)
        kinds = ("self_k", "self_v") + (("spare_k", "spare_v") if spares
                                        else ())
        for kind in kinds:
            state[f"l{l}_{kind}"] = torch.zeros(
                (b, h, max_len, dh), dtype=cfg.compute_dtype,
                device=enc_out.device)
    return state


def init_paged_decode_state(cfg: TransformerConfig, params: Params,
                            enc_out: torch.Tensor, src_mask: torch.Tensor,
                            n_pages: int, page_len: int,
                            max_pages: int) -> Dict[str, Any]:
    """Decode state for iteration-level decoding: per-layer page pools
    ``l{l}_pool_k/v`` [n_pages, H, page_len, Dh] shared by all rows (page
    0 is the trash page), one ``page_table`` [rows, max_pages] int32 for
    every layer (all layers write the same positions), per-row ``pos``
    [rows] int32, and the dense per-row cross-attention K/V. The rows'
    slot engine (translator/iteration.py) owns the table and positions.
    """
    b = enc_out.shape[0]
    dev = enc_out.device
    state: Dict[str, Any] = {}
    for l in range(1, cfg.dec_depth + 1):
        state[f"l{l}_cross_k"], state[f"l{l}_cross_v"] = cross_kv(
            cfg, params, enc_out, l)
        for kind in ("pool_k", "pool_v"):
            state[f"l{l}_{kind}"] = torch.zeros(
                (n_pages, cfg.heads, page_len, cfg.dim_head),
                dtype=cfg.compute_dtype, device=dev)
    state["page_table"] = torch.zeros((b, max_pages), dtype=torch.int32,
                                      device=dev)
    state["pos"] = torch.zeros((b,), dtype=torch.int32, device=dev)
    return state


def fork_paged_rows(state: Dict[str, Any], src_mask: torch.Tensor,
                    src_slots: torch.Tensor, dst_slots: torch.Tensor) -> None:
    """Copy the ROW leaves of a paged decode state (each layer's
    cross-attention K/V, the sentence's encoder summary) and the source
    mask row from ``src_slots`` to ``dst_slots``, IN PLACE: a new beam
    hypothesis row takes its sentence without another encoder pass (its
    decoder history travels as page-table aliases, ``kv_pool``). Pairs
    with ``src == dst`` are self-copies, so callers may pad with
    ``(0, 0)``. Pools and ``pos``/``page_table`` are untouched."""
    row_keys, _, _ = state_key_groups(state)
    src = src_slots.to(device=src_mask.device, dtype=torch.long)
    dst = dst_slots.to(device=src_mask.device, dtype=torch.long)
    for k in row_keys:
        state[k][dst] = state[k][src]
    src_mask[dst] = src_mask[src]


def decode_step(cfg: TransformerConfig, params: Params, state: Dict[str, Any],
                prev_ids: torch.Tensor, src_mask: torch.Tensor,
                beam_src: Optional[torch.Tensor] = None,
                shortlist: Optional[torch.Tensor] = None):
    """One decode step on [B, 1] previous ids → ([B, V] logits, new state).
    ``state['pos']`` is the time index; the self-attention mask allows
    positions <= pos. ``beam_src`` [B]: pending beam backpointers for the
    fused kernel (the beam search passes them instead of reordering the
    self-attention caches).

    A paged state (``page_table`` present) carries per-row positions
    ``pos`` [B] (< 0: an idle slot) and page pools instead of the dense
    caches; each row masks at its own position (the paged kernel applies
    that mask) and the pools are written in place.

    ``shortlist`` ([K], or [B, K] per row) restricts the logits to its
    coordinates (``output_logits``)."""
    pos = state["pos"]
    page_table = state.get("page_table")
    we = _embed_words(cfg, params, prev_ids, "trg")
    # Marian's no-BOS decoder start: step 0 sees a zero embedding (per
    # row when paged; <= covers idle slots with deterministic zeros)
    if page_table is not None:
        we = torch.where((pos <= 0)[:, None, None], torch.zeros_like(we), we)
    elif pos == 0:
        we = torch.zeros_like(we)
    x = _add_pos(cfg, we, pos)
    x = _pre_post(cfg, cfg.postprocess_emb, x, None, "decoder_emb", params)
    self_mask = None
    if page_table is None:
        max_len = state["l1_self_k"].shape[2]
        self_mask = (torch.arange(max_len, device=x.device) <= pos).to(
            cfg.compute_dtype)[None, None, None, :]
    cross_mask = src_mask[:, None, None, :]
    new_state = dict(state)
    for l in range(1, cfg.dec_depth + 1):
        lp = f"decoder_l{l}"
        kinds = ("pool_k", "pool_v") if page_table is not None \
            else ("self_k", "self_v")
        cache = {"k": state[f"l{l}_{kinds[0]}"],
                 "v": state[f"l{l}_{kinds[1]}"]}
        if f"l{l}_spare_k" in state:
            cache["spare_k"] = state[f"l{l}_spare_k"]
            cache["spare_v"] = state[f"l{l}_spare_v"]
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_self_Wo", params)
        out = _mha(cfg, params, f"{lp}_self", pre, pre, self_mask,
                   cache=cache, cache_pos=pos, beam_src=beam_src,
                   page_table=page_table)
        new_state[f"l{l}_{kinds[0]}"] = cache["k"]
        new_state[f"l{l}_{kinds[1]}"] = cache["v"]
        if "spare_k" in cache:
            new_state[f"l{l}_spare_k"] = cache["spare_k"]
            new_state[f"l{l}_spare_v"] = cache["spare_v"]
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_self_Wo", params)

        cname = f"{lp}_context"
        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{cname}_Wo", params)
        out = _mha(cfg, params, cname, pre, None, cross_mask,
                   cache={"k": state[f"l{l}_cross_k"],
                          "v": state[f"l{l}_cross_v"]}, static_kv=True)
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{cname}_Wo", params)

        pre = _pre_post(cfg, cfg.preprocess, x, None, f"{lp}_ffn_ffn", params)
        out = _ffn(cfg, params, f"{lp}_ffn", pre, cfg.dec_ffn, cfg.dec_ffn_d)
        x = _pre_post(cfg, cfg.postprocess, out, x, f"{lp}_ffn_ffn", params)
    x = _pre_post(cfg, cfg.postprocess_top, x, None, "decoder_top", params)
    new_state["pos"] = pos + 1
    return output_logits(cfg, params, x[:, 0, :], shortlist), new_state
