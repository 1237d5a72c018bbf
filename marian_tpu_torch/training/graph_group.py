"""The training-step engine on one device, ported from
``marian_tpu/training/graph_group.py`` (reference
src/training/graph_group_singleton.cpp) and the update tail of
``marian_tpu/parallel/zero.py :: finalize_update``.

One update: forward and backward of ``EncoderDecoder.loss`` by autograd
over one batch, or over the ``--optimizer-delay`` micro-batches of one
update with their gradients summed into f32 accumulators (the
reference's split path, graph_group.py ``update``), then cost-type
normalisation of the gradient, --normalize-gradient,
--dynamic-gradient-scaling, global-norm clipping (--clip-norm), the
optimizer step (with --gradient-dropping-rate and --quantize-bits,
``optimizers/compression.py``), and
--check-gradient-nan (a non-finite gradient norm skips the whole update,
params and optimizer state untouched). Parameters are f32 leaf tensors
on the device (the master weights, whatever --precision computes in)
and are updated in place. Gradients come back to them in f32 through the
loss's cast to the compute dtype, or, under --gradient-dtype bfloat16
with bf16 compute, in bf16 from a bf16 copy of the parameters; the cost
normalisation upcasts them to f32, as the reference's division by its
f32 denominator does.

--embedding-fix-src/-trg freeze their tables (``frozen_names``): the
gradients of those tables are zeroed before the global norm, so
--clip-norm and --dynamic-gradient-scaling see the reference's norm, and
Adam then leaves them byte-equal.

Not ported yet: meshes and ZeRO sharding, --dispatch-window; the trainer
refuses their flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..ops.ops import clip_by_global_norm, global_norm
from ..common import logging as log
from ..optimizers.optimizers import (STATE_DTYPES, OptimizerConfig,
                                     apply_update, init_state,
                                     smoothed_params)
from ..optimizers.schedule import LRSchedule

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainOutput:
    """Per-update metrics as device scalars: reading them with float()
    waits for the update, so the training loop reads them only at its
    display boundary."""
    loss_sum: Any
    labels: Any
    grad_norm: Any
    skipped: Any = None          # 0/1 under --check-gradient-nan
    guided: Any = None           # the guided-alignment cost, mean over
    # the micro-batches that carried an alignment matrix


def delay_of(options) -> int:
    """--optimizer-delay as micro-batches an update, and the reference's
    refusal of it beside --dispatch-window (graph_group.py)."""
    delay = max(1, int(float(options.get("optimizer-delay", 1))))
    window = max(1, int(options.get("dispatch-window", 1)))
    if window > 1 and delay > 1:
        raise ValueError("--dispatch-window requires --optimizer-delay 1 "
                         "(in-jit windowing and in-jit accumulation do "
                         "not compose; pick one)")
    return delay


def frozen_names(names, fix_src: bool, fix_trg: bool) -> frozenset:
    """The parameters --embedding-fix-src/-trg exclude from updates
    (reference: graph_group.py ``_frozen_names``); with tied embeddings
    the shared table freezes if either side is fixed."""
    out = set()
    if fix_src or fix_trg:
        for k in names:
            is_src = ((k.endswith("_Wemb") or k.endswith("_Wemb_factors"))
                      and not k.startswith("decoder")) or (k == "Wemb")
            is_trg = k in ("decoder_Wemb", "decoder_Wemb_factors",
                           "Wemb_dec") or (
                k == "Wemb" and not any(o in names
                                        for o in ("decoder_Wemb",
                                                  "Wemb_dec")))
            if (fix_src and is_src) or (fix_trg and is_trg):
                out.add(k)
    return frozenset(out)


def dropout_seed(seed: int, update: int, micro: int = 0) -> int:
    """Seed of the dropout generator for micro-batch ``micro`` of update
    ``update`` (micro 0 is the whole batch at delay 1)."""
    s = (int(seed) * 1_000_003 + int(update)) % (2**63 - 1)
    if micro:
        s = (s * 7_919 + int(micro)) % (2**63 - 1)
    return s


def cost_denominator(cost_type: str, labels: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """Gradient normaliser of a cost type (Marian's costScaleFactor):
    label count for ce-mean-words / perplexity, rows for ce-mean, else 1."""
    if cost_type in ("ce-mean-words", "perplexity"):
        return torch.clamp(labels, min=1.0)
    if cost_type == "ce-mean":
        return torch.tensor(float(rows), device=labels.device)
    return torch.ones((), device=labels.device)


def _grad_dtype(name, compute_dtype: torch.dtype) -> Optional[torch.dtype]:
    """--gradient-dtype as the dtype to differentiate in, or None for
    f32 gradients. As in the reference, bfloat16 gradients need bfloat16
    compute: otherwise the flag is ignored with a warning, since casting
    the parameters would change the compute dtype too."""
    name = str(name or "float32")
    if name not in STATE_DTYPES:
        raise ValueError(f"--gradient-dtype {name}: expected float32 or "
                         f"bfloat16")
    gd = STATE_DTYPES[name]
    if gd == torch.float32:
        return None
    if gd != compute_dtype:
        log.warn("--gradient-dtype {} ignored: compute precision is {} "
                 "(set --precision accordingly)", name,
                 str(compute_dtype).replace("torch.", ""))
        return None
    return gd


@torch.no_grad()
def finalize_update(opt_cfg: OptimizerConfig, opt_state, params: Params,
                    grads: Params, lr: float, labels: torch.Tensor,
                    denom: torch.Tensor):
    """The update tail (reference: parallel/zero.py :: finalize_update):
    cost normalisation → --normalize-gradient → --dynamic-gradient-scaling
    (statistics in opt_state['gstat']; an outlier scaled down to factor
    x the windowed average) → --clip-norm (of the scaled norm, so the
    two caps compose as a min) → optimizer step → --check-gradient-nan.
    Returns (raw gradient norm, skipped)."""
    if opt_cfg.normalize_gradient:
        denom = denom * torch.clamp(labels, min=1.0)
    grads = {k: g.float() / denom for k, g in grads.items()}
    gnorm = global_norm(grads)
    if opt_cfg.check_gradient_nan and not bool(torch.isfinite(gnorm)):
        # the reference reverts the whole state, gstat too; a non-finite
        # norm leaves gstat as it was in any case
        return gnorm, torch.ones((), device=gnorm.device)
    post_dyn_norm = gnorm
    if opt_cfg.dyn_scale_factor > 0:
        grads, post_dyn_norm = _dynamic_scaling(opt_cfg, opt_state["gstat"],
                                                grads, gnorm)
    if opt_cfg.clip_norm > 0:
        grads = clip_by_global_norm(grads, opt_cfg.clip_norm, post_dyn_norm)
    apply_update(opt_cfg, opt_state, params, grads, lr, labels)
    return gnorm, torch.zeros((), device=gnorm.device)


def _dynamic_scaling(opt_cfg: OptimizerConfig, gstat: Dict[str, Any],
                     grads: Params, gnorm: torch.Tensor):
    """--dynamic-gradient-scaling in the reference's op order: the
    windowed running average of the (log-)norm takes finite norms only
    (one NaN must not poison it), is warm after min(10, window) of them,
    and scales a step whose norm passes factor x average down to that
    threshold. Updates ``gstat`` in place; returns (grads, scaled
    norm)."""
    finite = torch.isfinite(gnorm)
    x = torch.log(torch.clamp(gnorm, min=1e-30)) \
        if opt_cfg.dyn_scale_log else gnorm
    n = gstat["n"] + torch.where(finite, 1.0, 0.0)
    w = torch.clamp(torch.clamp(n, min=1.0), max=float(opt_cfg.norm_window))
    avg = torch.where(finite, gstat["avg"] + (x - gstat["avg"]) / w,
                      gstat["avg"])
    thresh = (torch.exp(avg) * opt_cfg.dyn_scale_factor
              if opt_cfg.dyn_scale_log
              else avg * opt_cfg.dyn_scale_factor)
    warm = n >= min(10.0, float(opt_cfg.norm_window))
    scale = torch.where(warm & finite & (gnorm > thresh),
                        thresh / torch.clamp(gnorm, min=1e-30), 1.0)
    gstat["avg"].copy_(avg)
    gstat["n"].copy_(n)
    return {k: g * scale for k, g in grads.items()}, gnorm * scale


class GraphGroup:
    """Owns the parameters and the optimizer state on one device."""

    def __init__(self, model, options, device: torch.device):
        self.model = model
        self.options = options
        self.device = torch.device(device)
        self.opt_cfg = OptimizerConfig.from_options(options)
        self.schedule = LRSchedule.from_options(options)
        self.delay = delay_of(options)
        self.cost_type = options.get("cost-type", "ce-sum")
        self.grad_dtype = _grad_dtype(options.get("gradient-dtype",
                                                  "float32"),
                                      model.cfg.compute_dtype)
        self.params: Optional[Params] = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.frozen: frozenset = frozenset()

    # -- init / load --------------------------------------------------------
    def initialize(self, init_params: Dict[str, Any]) -> None:
        """Parameters from a flat dict of numpy arrays or tensors (f32
        leaves on the device); fresh optimizer state unless one was
        loaded."""
        self.params = {}
        for k, v in init_params.items():
            t = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
            self.params[k] = t.detach().to(
                device=self.device, dtype=torch.float32).clone(
                ).requires_grad_(True)
        self.frozen = frozen_names(
            list(self.params),
            bool(self.options.get("embedding-fix-src", False)),
            bool(self.options.get("embedding-fix-trg", False)))
        if self.opt_state is None:
            self.opt_state = init_state(self.opt_cfg, self.params)
        else:
            for k, v in init_state(self.opt_cfg, self.params).items():
                self.opt_state.setdefault(k, v)

    def reset_optimizer(self) -> None:
        """Fresh optimizer state (--lr-decay-reset-optimizer), keeping
        the parameters. The reference also rebuilds its jitted step
        here, since its schedule is baked into the trace; the port's
        step reads the schedule every update, so nothing is rebuilt."""
        self.opt_state = init_state(self.opt_cfg, self.params)

    # -- one update ---------------------------------------------------------
    def update(self, batches: Union[Dict[str, torch.Tensor],
                                    List[Dict[str, torch.Tensor]]],
               step: int, generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None) -> TrainOutput:
        """Forward, backward and optimizer step on one batch, or on a
        list of micro-batches (tensors on the device) whose gradients
        are summed in f32 whatever --gradient-dtype is (bf16 adds would
        absorb the later micro-batches' small terms), with the cost
        normalised by their summed labels or rows. ``step`` is the
        1-based update number; with ``generator`` and ``seed``, micro-
        batch i draws its dropout from ``dropout_seed(seed, step, i)``."""
        if isinstance(batches, dict):
            batches = [batches]
        names = list(self.params)
        acc: Optional[List[torch.Tensor]] = None
        ce_sum = labels = None
        guided = []
        rows = 0
        for i, batch in enumerate(batches):
            if generator is not None and seed is not None:
                generator.manual_seed(dropout_seed(seed, step, i))
            leaves = [self.params[k] for k in names]
            if self.grad_dtype is not None:
                # differentiate with respect to the parameters already
                # cast: the loss's own cast is then an identity and the
                # gradients come out in the grad dtype (reference:
                # zero.py _grads_of)
                leaves = [p.detach().to(self.grad_dtype).requires_grad_(True)
                          for p in leaves]
            total, aux = self.model.loss(dict(zip(names, leaves)), batch,
                                         generator, train=True)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            if len(batches) == 1:
                acc = grads
            elif acc is None:
                # owned copies: autograd may hand two leaves one tensor
                acc = [g.to(torch.float32, copy=True) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            del grads           # freed before the next micro-batch's forward
            if "guided" in aux:
                guided.append(aux["guided"].detach())
            ce = aux["ce_sum"].detach()
            lab = aux["labels"].detach()
            ce_sum = ce if ce_sum is None else ce_sum + ce
            labels = lab if labels is None else labels + lab
            rows += int(batch["trg_ids"].shape[0])
        if self.frozen:
            # fixed tables: no update and no share of the global norm
            acc = [torch.zeros_like(g) if k in self.frozen else g
                   for k, g in zip(names, acc)]
        denom = cost_denominator(self.cost_type, labels, rows)
        gnorm, skipped = finalize_update(
            self.opt_cfg, self.opt_state, self.params,
            dict(zip(names, acc)), self.schedule(step), labels, denom)
        return TrainOutput(ce_sum, labels, gnorm,
                           skipped if self.opt_cfg.check_gradient_nan
                           else None,
                           sum(guided) / len(guided) if guided else None)

    # -- EMA access and checkpoint glue ---------------------------------------
    def smoothed(self) -> Params:
        return smoothed_params(self.opt_cfg, self.opt_state,
                               self.export_params())

    def export_params(self) -> Params:
        return {k: p.detach() for k, p in self.params.items()}

    def optimizer_tensors(self) -> Dict[str, torch.Tensor]:
        """Flat-named optimizer state, the reference's ``.optimizer.npz``
        layout ('t', 'm:<name>', 'v:<name>', ..., 'qerr:<name>',
        'gerr:<name>', 'gstat:avg', 'gstat:n'), as the live tensors on the
        device."""
        flat = {"t": self.opt_state["t"]}
        for part in ("m", "v", "gt", "avg", "qerr", "gerr", "gstat"):
            for k, v in self.opt_state.get(part, {}).items():
                flat[f"{part}:{k}"] = v.detach()
        return flat

    def optimizer_arrays(self) -> Dict[str, np.ndarray]:
        """``optimizer_tensors`` as numpy; a bf16 m is saved as f32, as
        the reference saves it (numpy has no bfloat16, and the file
        resumes under either state dtype)."""
        return {k: v.float().cpu().numpy()
                for k, v in self.optimizer_tensors().items()}

    def load_optimizer_arrays(self, flat: Dict[str, np.ndarray]) -> None:
        """Optimizer state from ``optimizer_arrays``' layout; m takes
        this run's --optimizer-state-dtype. Once the parameters exist, a
        group the arrays lack (a checkpoint from before --quantize-bits,
        --gradient-dropping-rate or EMA was turned on) is backfilled with
        fresh state, as the reference's ``initialize`` does."""
        m_dtype = STATE_DTYPES[self.opt_cfg.state_dtype]
        st: Dict[str, Any] = {"t": torch.as_tensor(
            np.asarray(flat["t"], dtype=np.float32)).to(self.device)}
        for key, v in flat.items():
            if ":" in key:
                part, name = key.split(":", 1)
                st.setdefault(part, {})[name] = torch.as_tensor(
                    np.asarray(v, dtype=np.float32)).to(
                        self.device, m_dtype if part == "m"
                        else torch.float32)
        if self.params is not None:
            for k, v in init_state(self.opt_cfg, self.params).items():
                st.setdefault(k, v)
        self.opt_state = st
