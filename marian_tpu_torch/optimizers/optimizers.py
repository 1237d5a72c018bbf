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
  reference's ``parallel/zero.py`` does.

State is f32 whatever the compute dtype, except Adam's first moment m
under --optimizer-state-dtype bfloat16: it is stored in bf16, upcast for
the update math (f32), and the new m rounded back; v stays f32.
Gradients of any dtype are upcast to f32 here. Unlike the reference's
pure (state, grads) → (state, params) functions, ``apply_update``
updates the parameters and the state IN PLACE (under no_grad), which
saves a second copy of every tensor; it returns the same dicts for the
reference's call shape. Not ported yet: train-time quantization and
gradient dropping; ``from_options`` refuses their flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

# option → value at which the feature is off
_UNPORTED = {
    "quantize-bits": 0,
    "gradient-dropping-rate": 0.0,
}

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

    @classmethod
    def from_options(cls, options) -> "OptimizerConfig":
        for name, off in _UNPORTED.items():
            val = options.get(name, off)
            if val not in (off, None, 0, 0.0, [], ""):
                raise NotImplementedError(
                    f"--{name} {val} is not ported to marian_tpu_torch yet "
                    f"(ROADMAP)")
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
                      or 100))
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
    if cfg.name == "adam":
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float32,
                                           device=t.device), t)
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
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.copy_((p.float() - step).to(p.dtype))
    elif cfg.name == "adagrad":
        for k, p in params.items():
            g = grads[k].float()
            gt = state["gt"][k]
            gt.add_(torch.square(g))
            p.copy_((p.float() - lr * g / (torch.sqrt(gt) + eps)).to(p.dtype))
    else:
        for k, p in params.items():
            p.copy_((p.float() - lr * grads[k].float()).to(p.dtype))
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
