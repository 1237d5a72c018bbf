"""marian_tpu_torch's marian-decoder vs marian_tpu's, end to end on one
tiny ``.npz`` saved once (with its embedded special:model.yml).

Single-best stdout must be identical byte for byte. In ``--n-best``
output every field is identical byte for byte except the two printed
scores, which must agree within rtol 1e-6: they are f32 sums over up to
L per-step log-probs, which XLA's and PyTorch's CPU kernels round a few
ulps apart, and "%.6f" prints digits below one f32 ulp at these
magnitudes (|score| ~ 10-60, ulp ~ 2-4e-6).
"""

import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from marian_tpu.cli import marian_decoder as jax_cli
from marian_tpu.common.io import save_model
from marian_tpu.data.vocab import DefaultVocab
from marian_tpu_torch.cli import marian_decoder as torch_cli
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(2)

V = 23


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    _, jp, _, _, opts = tiny_pair(vocab=V, seed=11)
    save_model(str(d / "model.npz"), {k: np.asarray(v) for k, v in jp.items()},
               opts.as_yaml())
    DefaultVocab({"</s>": 0, "<unk>": 1,
                  **{f"w{i}": i for i in range(2, V)}}).save(str(d / "v.yml"))
    rng = np.random.RandomState(12)
    lines = [" ".join(f"w{j}" for j in rng.randint(2, V, size=n))
             for n in (9, 3, 12, 5, 7, 4, 11)]
    lines.append("w5 unknown_word w7")
    (d / "in.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return d


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _args(d, *extra):
    return ["--models", str(d / "model.npz"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--input", str(d / "in.txt"), "--beam-size",
            "4", "--mini-batch", "3", "--maxi-batch", "2", "--num-devices",
            "1", "--quiet", *extra]


def test_single_best_stdout_identical(model_dir, capsys):
    ref = _run(jax_cli.main, _args(model_dir), capsys)
    got = _run(torch_cli.main, _args(model_dir, "--cpu-threads", "1"), capsys)
    assert got == ref
    assert len(got.splitlines()) == 8


def test_nbest_stdout_identical_up_to_score_rounding(model_dir, capsys):
    ref = _run(jax_cli.main, _args(model_dir, "--n-best", "--normalize",
                                   "0.6"), capsys)
    got = _run(torch_cli.main, _args(model_dir, "--n-best", "--normalize",
                                     "0.6", "--cpu-threads", "1"), capsys)
    score = re.compile(r"-?\d+\.\d{6}")
    assert score.sub("S", got) == score.sub("S", ref)
    np.testing.assert_allclose([float(x) for x in score.findall(got)],
                               [float(x) for x in score.findall(ref)],
                               rtol=1e-6)
    assert len(got.splitlines()) == 8 * 4
    assert all(l.split(" ||| ")[2].startswith("Score= ")
               for l in got.splitlines())


def test_output_file_and_stdin(model_dir, monkeypatch, capsys):
    """--output writes the same lines; stdin is the default input."""
    out = model_dir / "out.txt"
    text = (model_dir / "in.txt").read_text(encoding="utf-8")
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    args = [a for a in _args(model_dir, "--cpu-threads", "1")]
    i = args.index("--input")
    del args[i:i + 2]
    torch_cli.main(args + ["--output", str(out)])
    ref = _run(torch_cli.main, _args(model_dir, "--cpu-threads", "1"), capsys)
    assert out.read_text(encoding="utf-8") == ref
    assert os.path.getsize(out) > 0
