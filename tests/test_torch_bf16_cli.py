"""Mixed precision through the port's command lines, on the CPU, with the
golden corpus and the tiny transformer of tests/test_torch_checkpoint_files.py:

- ``--fp16``, ``--precision float16`` and their combinations parse to
  the precision the reference's parser gives, in training and in
  translation mode;
- ``marian_train --precision bfloat16 float32`` and ``--fp16`` train the
  tiny model: the cost falls, and the saved model is the f32 master
  weights;
- under ``--optimizer-state-dtype bfloat16`` the ``.optimizer.npz`` holds
  m as f32 (values a bf16 holds exactly), and both packages resume from
  it. The port resumed by the port ends where an uninterrupted port run
  ends (rtol 1e-5, as tests/test_torch_train_cli.py holds its f32
  resume); resumed by the JAX package, the costs of the two resumed
  updates agree with the port's uninterrupted ones to 2^-7, two bf16
  roundings, since the two packages round their bf16 steps apart (the
  reference's CPU backend sums bias gradients in bf16).
"""

import re

import numpy as np
import pytest
import torch

from marian_tpu.common.config_parser import parse_options as jax_parse
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.io import load_model
from tests.test_torch_checkpoint_files import (costs, train, train_args,
                                               work)  # noqa: F401

torch.set_num_threads(2)

RESUME_RTOL = 1e-5
CROSS_RTOL = 2.0 ** -7


@pytest.mark.parametrize("mode", ["training", "translation"])
@pytest.mark.parametrize("flags", [
    ["--fp16"], ["--precision", "float16"],
    ["--precision", "float16", "float32"], ["--fp16", "--precision",
                                            "float32", "float32"],
    ["--precision", "bfloat16", "float32"], []])
def test_precision_flags_parse_as_the_reference_parses(mode, flags):
    need = (["--train-sets", "a", "b", "--vocabs", "v", "v"]
            if mode == "training" else ["--models", "m.npz", "--vocabs",
                                        "v", "v"])
    want = jax_parse(need + flags, mode=mode).get("precision")
    assert parse_options(need + flags, mode=mode).get("precision") == want


@pytest.mark.parametrize("flags", [["--precision", "bfloat16", "float32"],
                                   ["--fp16"]])
def test_bf16_training_cost_falls_and_saves_f32(work, flags):
    name = "fp16" if flags == ["--fp16"] else "bf16"
    log = work / f"{name}.log"
    train("torch", work, f"{name}.npz", 12, *flags, "--log", str(log))
    cost = [c for _, c in costs(log)]
    assert len(cost) == 12 and cost[-1] < cost[0]
    params, config = load_model(str(work / f"{name}.npz"))
    assert all(v.dtype == np.float32 for v in params.values())
    assert re.search(r"precision:\n- bfloat16\n- float32", config)


@pytest.mark.parametrize("second", ["torch", "jax"])
def test_bf16_optimizer_state_saves_f32_and_resumes(work, second):
    flags = ("--precision", "bfloat16", "float32",
             "--optimizer-state-dtype", "bfloat16")
    full = work / "m16_full.log"
    if not full.exists():
        train("torch", work, "m16_full.npz", 8, *flags, "--log", str(full))
    model = f"m16_part_{second}.npz"
    train("torch", work, model, 6, *flags)
    with np.load(work / f"{model}.optimizer.npz") as z:
        m = {k: z[k] for k in z.files if k.startswith("m:")}
    assert m and all(v.dtype == np.float32 for v in m.values())
    for v in m.values():
        as_bf16 = torch.from_numpy(v).bfloat16().float().numpy()
        assert np.array_equal(as_bf16, v)
    part = work / f"m16_part_{second}.log"
    train(second, work, model, 8, *flags, "--log", str(part))
    want, got = costs(full), costs(part)
    assert [u for u, _ in got] == [7, 8]
    np.testing.assert_allclose(
        [c for _, c in got], [c for u, c in want if u > 6],
        rtol=RESUME_RTOL if second == "torch" else CROSS_RTOL)
