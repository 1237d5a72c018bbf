"""The port's marian-train end to end on the golden corpus (tiny
transformer, golden options), on the CPU:

- ``python -m marian_tpu_torch.cli.marian_train --cpu-threads 2`` prints
  Marian's cost lines and writes the checkpoint (model, optimizer state,
  progress);
- the model.npz it writes decodes to identical tokens through the JAX
  package's marian-decoder and the port's: every hypothesis of the beam-4
  n-best lists (a model this small mostly ranks the empty sentence first),
  with the scores within rtol 1e-5 (f32 sums of per-step log-probs that
  XLA's and PyTorch's CPU kernels round a few ulps apart);
- a run stopped at an epoch boundary and resumed from its checkpoint
  ends with the same parameters and the same cost lines as one
  uninterrupted run: the checkpoint round-trips f32 exactly and both
  runs do the same f32 operations, but PyTorch's multi-threaded CPU
  reductions may split a sum differently between processes, so values
  agree to rtol 1e-5 with an absolute floor of 1e-6 (weights are ~0.3;
  Adam's normalised step turns a near-zero gradient's rounding noise into
  a step of up to lr). The attention key
  biases are left out: their gradient is exactly zero in exact
  arithmetic (a softmax does not see a shift shared by all keys), so
  both runs feed rounding noise to Adam, whose normalised step magnifies
  it, and those biases cannot change any output;
- without --cpu-threads and without a card it raises.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from marian_tpu.cli import marian_decoder as jax_decoder
from marian_tpu_torch.cli import marian_decoder as torch_decoder
from marian_tpu_torch.cli import marian_train
from marian_tpu_torch.common.io import load_model
from marian_tpu_torch.data.vocab import DefaultVocab

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
COST = re.compile(r"Ep\. (\d+) : Up\. (\d+) : Sen\. [\d,]+ : Cost ([\d.]+)")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    (d / "in.txt").write_text("\n".join(
        (DATA / "train.src").read_text().splitlines()[:8]) + "\n")
    # the side files of the ported training flags: a tab-separated copy
    # of the corpus, diagonal Pharaoh alignments, word weights of both
    # signs and word2vec vectors of the first source words
    src = (DATA / "train.src").read_text().splitlines()
    trg = (DATA / "train.trg").read_text().splitlines()
    (d / "train.tsv").write_text(
        "".join(f"{a}\t{b}\n" for a, b in zip(src, trg)))
    (d / "align.txt").write_text("".join(
        " ".join(f"{min(i, len(a.split()) - 1)}-{i}"
                 for i in range(len(b.split()))) + "\n"
        for a, b in zip(src, trg)))
    (d / "weights.txt").write_text("".join(
        " ".join(("-0.5" if i % 3 == 1 else "1")
                 for i in range(len(b.split()) + 1)) + "\n" for b in trg))
    words = sorted({w for l in src for w in l.split()})[:5]
    rng = np.random.RandomState(3)
    (d / "src.vec").write_text(f"{len(words)} 32\n" + "".join(
        w + " " + " ".join(f"{x:.5f}" for x in rng.randn(32)) + "\n"
        for w in words))
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


def costs(log):
    return [(int(u), float(c)) for _, u, c in COST.findall(log.read_text())]


def test_cli_prints_costs_and_writes_checkpoint(work):
    log = work / "cli.log"
    proc = subprocess.run(
        [sys.executable, "-m", "marian_tpu_torch.cli.marian_train",
         *train_args(work, "cli.npz", "--after-batches", "4",
                     "--cpu-threads", "2", "--log", str(log))],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = costs(log)
    assert [u for u, _ in got] == [1, 2, 3, 4]
    assert all(np.isfinite(c) and c > 0 for _, c in got)
    for suffix in ("", ".optimizer.npz", ".progress.yml"):
        assert (work / f"cli.npz{suffix}").exists()
    assert "batches: 4" in (work / "cli.npz.progress.yml").read_text()


def test_trained_model_decodes_identically_in_both_packages(work, capsys):
    marian_train.main(train_args(work, "dec.npz", "--after-batches", "40",
                                 "--learn-rate", "0.01",
                                 "--cpu-threads", "2"))
    args = ["--models", str(work / "dec.npz"), "--vocabs",
            str(work / "v.yml"), str(work / "v.yml"), "--input",
            str(work / "in.txt"), "--beam-size", "4", "--n-best",
            "--num-devices", "1", "--quiet"]
    capsys.readouterr()
    jax_decoder.main(args)
    ref = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    torch_decoder.main(args + ["--cpu-threads", "1"])
    got = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    assert len(got) == 8 * 4 and sum(len(g[1].split()) for g in got) >= 16
    np.testing.assert_allclose([float(g[2].split()[1]) for g in got],
                               [float(r[2].split()[1]) for r in ref],
                               rtol=1e-5)


def test_resume_continues_the_uninterrupted_trajectory(work):
    marian_train.main(train_args(work, "full.npz", "--after-batches", "8",
                                 "--cpu-threads", "2", "--log",
                                 str(work / "full.log")))
    # 6 updates are one epoch of the golden corpus: stop there, resume
    marian_train.main(train_args(work, "part.npz", "--after-batches", "6",
                                 "--cpu-threads", "2"))
    marian_train.main(train_args(work, "part.npz", "--after-batches", "8",
                                 "--cpu-threads", "2", "--log",
                                 str(work / "part.log")))
    full, part = costs(work / "full.log"), costs(work / "part.log")
    assert [u for u, _ in part] == [7, 8]
    np.testing.assert_allclose([c for _, c in part],
                               [c for u, c in full if u > 6], rtol=1e-5)
    a, _ = load_model(str(work / "full.npz"))
    b, _ = load_model(str(work / "part.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        if not k.endswith("_bk"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_train_entry_point_raises_without_card(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        marian_train.main(train_args(work, "none.npz", "--after-batches",
                                     "1"))
    assert not (work / "none.npz").exists()


@pytest.mark.parametrize("flag", [["--mesh", "data:2"],
                                  ["--dispatch-window", "4"],
                                  ["--auto-tune"],
                                  ["--profile-server", "6009"]])
def test_unported_training_flags_raise(work, flag):
    """What the port still refuses by name. --transformer-depth-scaling,
    --guided-alignment and --gradient-checkpointing, once refused here,
    now train (test_ported_training_flags_run)."""
    with pytest.raises(NotImplementedError, match=flag[0][2:]):
        marian_train.main(train_args(work, "x.npz", "--cpu-threads", "1",
                                     *flag))


@pytest.mark.parametrize("flag,progress", [
    (["--optimizer-delay", "2"], "batches: 3"),
    (["--dynamic-gradient-scaling", "2"], "batches: 3"),
    (["--async-save", "--save-freq", "1"], "batches: 3"),
    (["--mini-batch-warmup", "2", "--mini-batch-track-lr"], "batches: 3"),
    (["--mini-batch-fit", "--max-length", "12", "--max-length-crop"],
     "batches: 3"),
    (["--lr-decay", "0.5", "--lr-decay-strategy", "batches",
      "--lr-decay-freq", "1", "--valid-sets", str(DATA / "train.src"),
      str(DATA / "train.trg"), "--valid-freq", "1u"], "factor: 0.125"),
    (["--transformer-depth-scaling"], "batches: 3"),
    (["--guided-alignment", "{work}/align.txt", "--guided-alignment-cost",
      "mse", "--transformer-guided-alignment-layer", "1",
      "--multi-loss-type", "mean"], "batches: 3"),
    (["--gradient-checkpointing", "--transformer-dropout", "0.1"],
     "batches: 3"),
    (["--tsv", "--train-sets", "{work}/train.tsv", "--tsv-fields", "2"],
     "batches: 3"),
    (["--right-left"], "batches: 3"),
    (["--unlikelihood-loss", "--data-weighting", "{work}/weights.txt",
      "--data-weighting-type", "word"], "batches: 3"),
    (["--embedding-vectors", "{work}/src.vec", "--embedding-normalization",
      "--embedding-fix-src"], "batches: 3"),
    (["--output-omit-bias"], "batches: 3"),
    (["--quantize-bits", "4", "--quantize-log-based", "--quantize-biases",
      "--quantize-optimization-steps", "1"], "batches: 3"),
    (["--gradient-dropping-rate", "0.9"], "batches: 3")])
def test_ported_training_flags_run(work, flag, progress):
    """--optimizer-delay, --lr-decay, --dynamic-gradient-scaling,
    --async-save, --mini-batch-warmup with --mini-batch-track-lr and
    --mini-batch-fit, and the rest of the training slice (depth scaling,
    guided alignment, gradient checkpointing, --tsv, --right-left, the
    unlikelihood loss, pretrained and fixed embeddings, --output-omit-bias,
    train-time quantization and gradient dropping), once refused, now
    train: 3 updates (of 2 batches each under the delay); a decay by half
    after each of 3 validations."""
    flag = [f.format(work=work) for f in flag]
    marian_train.main(train_args(work, "ported.npz", "--after-batches", "3",
                                 "--cpu-threads", "1", "--no-reload",
                                 *flag))
    assert progress in (work / "ported.npz.progress.yml").read_text()


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
