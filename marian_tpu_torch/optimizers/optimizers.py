"""Optimizers with Marian's exact semantics (reference:
src/optimizers/optimizers.cpp :: Adam::updateImpl, Adagrad, Sgd;
src/optimizers/exponential_smoothing.h), ported from
``marian_tpu/optimizers/optimizers.py``:

- Adam with bias correction (denominators 1-beta^t), epsilon added to the
  square root of the corrected second moment, and optional
  --mini-batch-words-ref scaling of lr and eps;
- exponential smoothing of params (EMA swapped in for saving);
- the statistics of --dynamic-gradient-scaling ('gstat': the windowed
  average of the (log-)gradient norm and its count), which the update
  tail ``training/graph_group.finalize_update`` keeps, as the
  reference's ``parallel/zero.py`` does;
- train-time compression (``compression.py``) in the reference's order:
  --gradient-dropping-rate sparsifies the (scaled, clipped) gradients
  before the step, with its residual in 'gerr'; --quantize-bits snaps
  the updated f32 master parameters to their grid after it, with the
  error in 'qerr', and before the EMA, so the smoothed parameters track
  the quantized model.

State is f32 whatever the compute dtype, except Adam's first moment m
under --optimizer-state-dtype bfloat16: it is stored in bf16, upcast for
the update math (f32), and the new m rounded back; v stays f32.
Gradients of any dtype are upcast to f32 here. Unlike the reference's
pure (state, grads) → (state, params) functions, ``apply_update``
updates the parameters and the state IN PLACE (under no_grad), which
saves a second copy of every tensor; it returns the same dicts for the
reference's call shape.

Adam's bias corrections 1 - beta^t are computed in f64 and rounded to
f32, and the square roots of Adam and Adagrad are taken in f64 and
rounded to f32, the correctly rounded f32 root. PyTorch's f32 pow and
sqrt are not correctly rounded for some inputs, on the card (0.7% of a
sqrt's elements on an H100) and on some CPU builds, so the two devices
differed in the last bit, and a quantized update (--quantize-bits) turns
such a bit into a whole step of its grid. So the optimizer step is the
same, bit for bit, on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .compression import drop_gradients, quantize_model

Params = Dict[str, torch.Tensor]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device: the f64
    root rounded to f32 (53 bits hold the f32 root's rounding exactly)."""
    return torch.sqrt(x.double()).float()


STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "adam"                 # adam | adagrad | sgd
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0             # 0 = off  (--clip-norm)
    smoothing: float = 0.0             # --exponential-smoothing
    ref_mb_words: int = 0              # --mini-batch-words-ref
    normalize_gradient: bool = False   # --normalize-gradient
    check_gradient_nan: bool = False   # --check-gradient-nan
    state_dtype: str = "float32"       # --optimizer-state-dtype (Adam's m)
    # --dynamic-gradient-scaling FACTOR [log]: a step whose (log-)norm
    # passes FACTOR x its windowed average is scaled down to it
    dyn_scale_factor: float = 0.0      # 0 = off
    dyn_scale_log: bool = False
    norm_window: int = 100             # --gradient-norm-average-window
    # train-time compression (compression.py)
    quantize_bits: int = 0             # --quantize-bits (0 = off)
    quantize_log: bool = False         # --quantize-log-based
    quantize_biases: bool = False      # --quantize-biases
    quantize_opt_steps: int = 0        # --quantize-optimization-steps
    quantize_range: float = 0.0        # --quantize-range (N stddevs)
    grad_drop_rate: float = 0.0        # --gradient-dropping-rate (0 = off)

    @classmethod
    def from_options(cls, options) -> "OptimizerConfig":
        params = [float(x) for x in options.get("optimizer-params", []) or []]
        name = options.get("optimizer", "adam")
        if name not in ("adam", "adagrad", "sgd"):
            raise ValueError(f"Unknown optimizer '{name}'")
        cfg = cls(name=name,
                  clip_norm=float(options.get("clip-norm", 1.0) or 0.0),
                  smoothing=float(options.get("exponential-smoothing", 0.0)
                                  or 0.0),
                  ref_mb_words=int(options.get("mini-batch-words-ref", 0)
                                   or 0),
                  normalize_gradient=bool(
                      options.get("normalize-gradient", False)),
                  check_gradient_nan=bool(
                      options.get("check-gradient-nan", False)),
                  state_dtype=str(options.get("optimizer-state-dtype",
                                              "float32") or "float32"),
                  norm_window=int(
                      options.get("gradient-norm-average-window", 100)
                      or 100),
                  quantize_bits=int(options.get("quantize-bits", 0) or 0),
                  quantize_log=bool(options.get("quantize-log-based",
                                                False)),
                  quantize_biases=bool(options.get("quantize-biases",
                                                   False)),
                  quantize_opt_steps=int(
                      options.get("quantize-optimization-steps", 0) or 0),
                  quantize_range=float(
                      options.get("quantize-range", 0.0) or 0.0),
                  grad_drop_rate=float(
                      options.get("gradient-dropping-rate", 0.0) or 0.0))
        dyn = options.get("dynamic-gradient-scaling", []) or []
        if dyn is True:
            dyn = ["2"]
        if isinstance(dyn, (str, int, float)):
            dyn = [dyn]
        if dyn:
            cfg.dyn_scale_factor = float(dyn[0])
            cfg.dyn_scale_log = any(str(v).lower() == "log"
                                    for v in dyn[1:])
        if cfg.state_dtype not in STATE_DTYPES:
            raise ValueError(
                f"--optimizer-state-dtype {cfg.state_dtype}: expected "
                f"float32 or bfloat16")
        if name == "adam":
            if len(params) > 0:
                cfg.beta1 = params[0]
            if len(params) > 1:
                cfg.beta2 = params[1]
            if len(params) > 2:
                cfg.eps = params[2]
        elif name == "adagrad" and params:
            cfg.eps = params[0]
        return cfg


def init_state(cfg: OptimizerConfig, params: Params) -> Dict[str, Any]:
    def zeros(dtype=torch.float32):
        return {k: torch.zeros(v.shape, dtype=dtype, device=v.device)
                for k, v in params.items()}

    dev = next(iter(params.values())).device
    st: Dict[str, Any] = {"t": torch.zeros((), dtype=torch.float32,
                                           device=dev)}
    if cfg.name == "adam":
        st["m"], st["v"] = zeros(STATE_DTYPES[cfg.state_dtype]), zeros()
    elif cfg.name == "adagrad":
        st["gt"] = zeros()
    if cfg.smoothing > 0:
        st["avg"] = {k: v.detach().float().clone() for k, v in params.items()}
    if cfg.quantize_bits > 0:     # quantization error feedback
        st["qerr"] = zeros()
    if cfg.grad_drop_rate > 0:    # gradient-dropping residual
        st["gerr"] = zeros()
    if cfg.dyn_scale_factor > 0:
        st["gstat"] = {"avg": torch.zeros((), dtype=torch.float32,
                                          device=dev),
                       "n": torch.zeros((), dtype=torch.float32, device=dev)}
    return st


@torch.no_grad()
def apply_update(cfg: OptimizerConfig, state: Dict[str, Any], params: Params,
                 grads: Params, lr: float,
                 mb_words: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, Any], Params]:
    """One optimizer step, in place. ``mb_words`` enables Marian's
    reference-batch LR scaling (lr and eps times T/Tref)."""
    state["t"] += 1.0
    t = state["t"]
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    eps = torch.as_tensor(cfg.eps, dtype=torch.float32, device=t.device)
    if cfg.ref_mb_words and mb_words is not None:
        ratio = mb_words.float() / float(cfg.ref_mb_words)
        lr, eps = lr * ratio, eps * ratio
    if cfg.grad_drop_rate > 0:
        grads, gerr = drop_gradients(grads, state["gerr"], cfg.grad_drop_rate)
        for k, r in gerr.items():
            state["gerr"][k].copy_(r)
    if cfg.name == "adam":
        t64 = t.double()
        bc1 = (1.0 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float64,
                                            device=t.device), t64)).float()
        bc2 = (1.0 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float64,
                                            device=t.device), t64)).float()
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            if m.dtype == torch.float32:
                m.mul_(cfg.beta1).add_((1.0 - cfg.beta1) * g)
            else:
                # a bf16 m: the update in f32, the new m rounded back
                m32 = cfg.beta1 * m.float() + (1.0 - cfg.beta1) * g
                m.copy_(m32)
                m = m32
            v.mul_(cfg.beta2).add_((1.0 - cfg.beta2) * torch.square(g))
            step = lr * (m / bc1) / (_sqrt(v / bc2) + eps)
            p.copy_((p.float() - step).to(p.dtype))
    elif cfg.name == "adagrad":
        for k, p in params.items():
            g = grads[k].float()
            gt = state["gt"][k]
            gt.add_(torch.square(g))
            p.copy_((p.float() - lr * g / (_sqrt(gt) + eps)).to(p.dtype))
    else:
        for k, p in params.items():
            p.copy_((p.float() - lr * grads[k].float()).to(p.dtype))
    if cfg.quantize_bits > 0:
        qp, qerr = quantize_model(
            params, state["qerr"], cfg.quantize_bits, cfg.quantize_log,
            cfg.quantize_opt_steps, cfg.quantize_biases,
            qrange=cfg.quantize_range)
        for k, p in params.items():
            p.copy_(qp[k])
            state["qerr"][k].copy_(qerr[k])
    if cfg.smoothing > 0:
        for k, p in params.items():
            avg = state["avg"][k]
            avg.add_(cfg.smoothing * (p.float() - avg))
    return state, params


def smoothed_params(cfg: OptimizerConfig, state: Dict[str, Any],
                    params: Params) -> Params:
    """EMA params for saving and decoding (reference: swapParams)."""
    if cfg.smoothing > 0 and "avg" in state:
        return {k: state["avg"][k].to(params[k].dtype) for k in params}
    return params
