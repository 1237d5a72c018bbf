"""The port's optimizer, LR schedule and update tail vs the JAX package's
(``optimizers/optimizers.py``, ``optimizers/schedule.py``,
``parallel/zero.py :: finalize_update``) over 5 steps of random
gradients: Adam with bias correction, EMA, clip-norm and ce-mean-words
normalisation.

Both sides do the same f32 elementwise arithmetic; what differs is the
gradient norm's summation order and a few ulps of pow/sqrt, so the
parameters, moments and EMA agree to rtol 1e-5 / atol 1e-7 and the
learning rates to rtol 1e-6 (the JAX schedule rounds to f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common import Options
from marian_tpu.optimizers import optimizers as jopt
from marian_tpu.optimizers.schedule import LRSchedule as JSchedule
from marian_tpu.parallel.zero import finalize_update as jfinalize
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.optimizers import optimizers as topt
from marian_tpu_torch.optimizers.schedule import LRSchedule
from marian_tpu_torch.training.graph_group import (cost_denominator,
                                                   finalize_update)

SHAPES = {"Wemb": (11, 6), "encoder_l1_self_Wq": (6, 6),
          "encoder_l1_self_bq": (1, 6), "decoder_ff_logit_out_b": (1, 11)}
OPTS = {"optimizer": "adam", "optimizer-params": [0.9, 0.98, 1e-9],
        "learn-rate": 3e-3, "lr-warmup": "3", "lr-decay-inv-sqrt": ["4"],
        "clip-norm": 1.0, "exponential-smoothing": 0.05,
        "cost-type": "ce-mean-words"}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-7, err_msg=what)


@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd"])
def test_five_updates_match_jax(name):
    opts = {**OPTS, "optimizer": name}
    if name == "adagrad":
        opts["optimizer-params"] = [1e-6]
    jcfg = jopt.OptimizerConfig.from_options(Options(opts))
    tcfg = topt.OptimizerConfig.from_options(TOptions(opts))
    jsched, tsched = (JSchedule.from_options(Options(opts)),
                      LRSchedule.from_options(TOptions(opts)))
    init = _params(0)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jst = jopt.init_state(jcfg, jp)
    tp = {k: torch.tensor(v) for k, v in init.items()}
    tst = topt.init_state(tcfg, tp)
    rng = np.random.RandomState(1)
    for step in range(1, 6):
        # large gradients on even steps so clip-norm engages
        mag = 40.0 if step % 2 == 0 else 0.3
        grads = {k: (rng.randn(*s) * mag).astype(np.float32)
                 for k, s in SHAPES.items()}
        labels = float(rng.randint(5, 50))
        lr = tsched(step)
        np.testing.assert_allclose(lr, float(jsched(step)), rtol=1e-6)
        jl = jnp.asarray(labels, jnp.float32)
        jp, jst, jnorm, _ = jfinalize(
            jcfg, jst, jp, {k: jnp.asarray(v) for k, v in grads.items()},
            jsched(step), jl, jnp.maximum(jl, 1.0))
        tl = torch.tensor(labels)
        tnorm, skipped = finalize_update(
            tcfg, tst, tp, {k: torch.tensor(v) for k, v in grads.items()},
            lr, tl, cost_denominator("ce-mean-words", tl, 8))
        assert float(skipped) == 0.0
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
        for k in SHAPES:
            _close(tp[k], jp[k], f"param {k} step {step}")
            for part in ("m", "v", "gt", "avg"):
                if part in jst:
                    _close(tst[part][k], jst[part][k],
                           f"{part}:{k} step {step}")
    assert float(tst["t"]) == float(jst["t"]) == 5.0
    smooth = topt.smoothed_params(tcfg, tst, tp)
    jsmooth = jopt.smoothed_params(jcfg, jst, jp)
    for k in SHAPES:
        _close(smooth[k], jsmooth[k], f"ema {k}")


def test_schedule_matches_jax_over_warmup_and_decay():
    opts = {"learn-rate": 2e-4, "lr-warmup": "8000",
            "lr-decay-inv-sqrt": ["8000"]}
    j, t = (JSchedule.from_options(Options(opts)),
            LRSchedule.from_options(TOptions(opts)))
    for step in (1, 2, 100, 7999, 8000, 8001, 20000, 10**6):
        np.testing.assert_allclose(t(step), j.host_lr(step), rtol=1e-12)
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


def test_check_gradient_nan_skips_the_whole_update():
    opts = {**OPTS, "check-gradient-nan": True}
    cfg = topt.OptimizerConfig.from_options(TOptions(opts))
    init = _params(2)
    tp = {k: torch.tensor(v) for k, v in init.items()}
    st = topt.init_state(cfg, tp)
    grads = {k: torch.ones(s) for k, s in SHAPES.items()}
    grads["Wemb"][0, 0] = float("nan")
    norm, skipped = finalize_update(cfg, st, tp, grads, 1e-3,
                                    torch.tensor(3.0), torch.tensor(3.0))
    assert float(skipped) == 1.0 and not np.isfinite(float(norm))
    assert float(st["t"]) == 0.0
    for k in SHAPES:
        assert np.array_equal(tp[k].numpy(), init[k])


@pytest.mark.parametrize("flag,value", [
    ("quantize-bits", 8), ("gradient-dropping-rate", 0.9),
    ("dynamic-gradient-scaling", ["2"])])
def test_unported_optimizer_flags_raise(flag, value):
    """Each flag was refused until it was ported; each now configures the
    update as the reference's OptimizerConfig does: the compression
    flags (held to the reference in tests/test_torch_compression.py) and
    --dynamic-gradient-scaling (tests/test_torch_recipe.py)."""
    fields = ("quantize_bits", "grad_drop_rate", "dyn_scale_factor",
              "dyn_scale_log")
    got = topt.OptimizerConfig.from_options(TOptions({flag: value}))
    ref = jopt.OptimizerConfig.from_options(Options({flag: value}))
    assert [getattr(got, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    assert [getattr(got, f) for f in fields] != \
        [getattr(topt.OptimizerConfig(), f) for f in fields]


def test_optimizer_state_dtype_other_than_f32_or_bf16_raises_as_reference():
    opts = {**OPTS, "optimizer-state-dtype": "float16"}
    with pytest.raises(ValueError) as ref:
        jopt.OptimizerConfig.from_options(Options(opts))
    with pytest.raises(ValueError) as got:
        topt.OptimizerConfig.from_options(TOptions(opts))
    assert str(got.value) == str(ref.value)
