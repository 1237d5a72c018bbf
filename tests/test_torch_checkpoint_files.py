"""Checkpoint files across the two packages, on the CPU, with the flags
of tests/test_torch_train_cli.py:

- with a save frequency below the last update, the JAX trainer and the
  port's leave the same file names in their model directories, with and
  without --overwrite: without it, both keep a params + config copy
  ``<model>.iter<N>.npz`` of every periodic save and of the final one,
  and both commit every save as a checksummed bundle under
  ``<model>.npz.bundles`` (the same bundle names, and in each the same
  member names, each of which validates);
- the port's ``.iter<N>.npz`` decodes to identical tokens through both
  packages' marian-decoder;
- training resumes across the packages: 6 updates of one package
  resumed by the other to 8 end where 8 uninterrupted updates of the
  first package end. The two packages round f32 sums a few ulps apart on
  the CPU (XLA's and PyTorch's kernels), and Adam's normalised step
  turns near-zero gradients' rounding noise into steps of up to lr.
  Readings on this file's runs: costs within 9.4e-8 relative in both
  directions; parameters within 9.5e-7 absolute with JAX resumed by the
  port, and within 5.3e-6 the other way (decoder_l2_context_Wk, 2x what
  the port-only resume test's rtol 1e-5 / atol 1e-6 allows). Limits:
  costs rtol 5e-7, parameters rtol 1e-5 with atol 1e-5 (about 2x the
  worst reading). As in the port-only test, the attention key biases,
  whose gradient is zero in exact arithmetic, are left out.
"""

import os
import pathlib
import re

import numpy as np
import pytest
import torch

from marian_tpu.cli import marian_decoder as jax_decoder
from marian_tpu.cli import marian_train as jax_train
from marian_tpu_torch.cli import marian_decoder as torch_decoder
from marian_tpu_torch.cli import marian_train as torch_train
from marian_tpu_torch.common.io import load_model
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.training.bundle import validate_bundle

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
COST = re.compile(r"Ep\. (\d+) : Up\. (\d+) : Sen\. [\d,]+ : Cost ([\d.]+)")
COST_RTOL = 5e-7
PARAM_RTOL = PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_files")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    (d / "in.txt").write_text("\n".join(
        (DATA / "train.src").read_text().splitlines()[:8]) + "\n")
    return d


def train_args(d, model, *extra):
    return ["--type", "transformer", "--train-sets", str(DATA / "train.src"),
            str(DATA / "train.trg"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--model", str(d / model), "--dim-emb", "32",
            "--transformer-heads", "4", "--transformer-dim-ffn", "64",
            "--enc-depth", "2", "--dec-depth", "2", "--tied-embeddings-all",
            "--transformer-ffn-activation", "relu", "--learn-rate", "0.05",
            "--optimizer-params", "0.9", "0.98", "1e-9", "--clip-norm", "1",
            "--cost-type", "ce-mean-words", "--label-smoothing", "0.1",
            "--mini-batch", "16", "--maxi-batch", "4", "--maxi-batch-sort",
            "src", "--max-length", "24", "--seed", "1234", "--disp-freq",
            "1", "--quiet", *extra]


def train(pkg, d, model, updates, *extra):
    """``updates`` updates of ``pkg`` ('jax' or 'torch') into d/model."""
    if pkg == "jax":
        jax_train.main(train_args(d, model, "--after-batches", str(updates),
                                  *extra))
    else:
        torch_train.main(train_args(d, model, "--after-batches",
                                    str(updates), "--cpu-threads", "2",
                                    *extra))


def costs(log):
    return [(int(u), float(c)) for _, u, c in COST.findall(log.read_text())]


@pytest.mark.parametrize("overwrite", [False, True])
def test_both_packages_leave_the_same_files(work, overwrite):
    flags = ["--save-freq", "2"] + (["--overwrite"] if overwrite else [])
    names, bundles = {}, {}
    for pkg in ("jax", "torch"):
        sub = f"files_{pkg}_{int(overwrite)}"
        (work / sub).mkdir()
        train(pkg, work, f"{sub}/m.npz", 5, *flags)
        names[pkg] = sorted(os.listdir(work / sub))
        root = work / sub / "m.npz.bundles"
        bundles[pkg] = {b: sorted(os.listdir(root / b))
                        for b in sorted(os.listdir(root))}
        for b in bundles[pkg]:
            ok, why, _ = validate_bundle(str(root / b))
            assert ok, f"{pkg} {b}: {why}"
    assert names["jax"] == names["torch"]
    assert "m.npz.bundles" in names["torch"]
    # saves at 2, 4 and the final 5: three bundles, the default keep
    assert bundles["jax"] == bundles["torch"] == {
        f"bundle-0000000{i}": ["MANIFEST.json", "m.npz",
                               "m.npz.optimizer.npz", "m.npz.progress.yml"]
        for i in (1, 2, 3)}
    iters = sorted(n for n in names["torch"] if ".iter" in n)
    assert iters == ([] if overwrite else
                     ["m.iter2.npz", "m.iter4.npz", "m.iter5.npz"])
    if not overwrite:
        final, _ = load_model(str(work / "files_torch_0" / "m.npz"))
        last, config = load_model(str(work / "files_torch_0"
                                      / "m.iter5.npz"))
        assert config and sorted(last) == sorted(final)
        for k in final:
            np.testing.assert_array_equal(last[k], final[k], err_msg=k)


def test_port_iteration_copy_decodes_in_both_packages(work, capsys):
    (work / "iter_decode").mkdir()
    train("torch", work, "iter_decode/m.npz", 12, "--save-freq", "6",
          "--learn-rate", "0.01")
    args = ["--models", str(work / "iter_decode" / "m.iter6.npz"),
            "--vocabs",
            str(work / "v.yml"), str(work / "v.yml"), "--input",
            str(work / "in.txt"), "--beam-size", "4", "--n-best",
            "--num-devices", "1", "--quiet"]
    capsys.readouterr()
    jax_decoder.main(args)
    ref = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    torch_decoder.main(args + ["--cpu-threads", "1"])
    got = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    assert len(ref) == 8 * 4
    assert [g[:2] for g in got] == [r[:2] for r in ref]


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_resume_across_packages(work, first, second):
    """6 updates of ``first`` resumed by ``second`` to 8 end where 8
    uninterrupted updates of ``first`` end."""
    full = work / f"full_{first}.log"
    part = work / f"part_{first}_{second}.log"
    train(first, work, f"full_{first}.npz", 8, "--log", str(full))
    # 6 updates are one epoch of the golden corpus: stop there, resume
    model = f"part_{first}_{second}.npz"
    train(first, work, model, 6)
    train(second, work, model, 8, "--log", str(part))
    want, got = costs(full), costs(part)
    assert [u for u, _ in got] == [7, 8]
    np.testing.assert_allclose([c for _, c in got],
                               [c for u, c in want if u > 6],
                               rtol=COST_RTOL)
    a, _ = load_model(str(work / f"full_{first}.npz"))
    b, _ = load_model(str(work / model))
    assert sorted(a) == sorted(b)
    for k in a:
        if not k.endswith("_bk"):
            np.testing.assert_allclose(b[k], a[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    trainer run in this process enables the port's perf plane (the
    parser defaults --perf-accounting on), which would change what later
    tests in the process see; disable it again after every test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()
