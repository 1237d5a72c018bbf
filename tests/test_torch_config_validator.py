"""The port's option checks against the reference's, on the CPU.

Every ``raise`` of ``marian_tpu/common/config_validator.py`` gets an
argv, run through both packages' ``parse_options`` in the matching mode
(training, translation, server): both refuse with the same exception
type and message, or both accept. Where the raise needs a flag the port
does not carry, the case pins the port's own refusal instead: its
parser's unknown-option exit. ``--optimizer-delay`` above 1 with
``--dispatch-window`` above 1, which the reference refuses when its
GraphGroup is built, the port refuses with the same message in its
trainer's option check, before ``--dispatch-window`` is refused by
name. A few
argv that both parsers accept but whose feature the port's trainer does
not carry (``--tsv``, ``--right-left``, ``--guided-alignment``) are
pinned to the trainer's refusal by name (``_UNPORTED``). Last, the
port's ``marian_train`` with ``--cost-type foo`` exits non-zero before
any update and writes no model.
"""

import pathlib
import subprocess
import sys

import pytest

from marian_tpu.common.config_parser import parse_options as jax_parse
from marian_tpu_torch.common.config_parser import parse_options as torch_parse
from marian_tpu_torch.training.train import _refuse_unported

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"

TRAIN = ["--type", "transformer", "--train-sets", "a.src", "a.trg"]
DECODE = ["--models", "m.npz"]

# (mode, argv, the port's own refusal or None for the reference's):
# one argv per raise of the reference's validator, in its order
REFUSED = [
    ("training", TRAIN + ["--dim-emb", "0"], None),
    ("translation", DECODE + ["--dim-emb", "-4"], None),
    ("training", TRAIN[2:] + ["--type", "foo"], None),
    ("translation", DECODE + ["--type", "foo"], None),
    ("server", DECODE + ["--type", "foo"], None),
    ("training", TRAIN + ["--dim-emb", "36", "--transformer-heads", "8"],
     None),
    ("translation", DECODE + ["--type", "transformer", "--dim-emb", "36"],
     None),
    ("training", TRAIN[2:] + ["--type", "transformer-lm",
                              "--guided-alignment", "a.txt"], None),
    ("training", TRAIN + ["--right-left", "--guided-alignment", "a.txt"],
     None),
    ("training", TRAIN + ["--right-left", "--data-weighting", "w.txt",
                          "--data-weighting-type", "word"], None),
    ("training", ["--type", "transformer"], None),
    ("training", TRAIN + ["--tsv"], None),
    ("training", TRAIN + ["--vocabs", "v.yml"], None),
    ("training", TRAIN + ["--label-smoothing", "1.5"], None),
    ("training", TRAIN + ["--label-smoothing", "-0.5"], None),
    ("training", TRAIN + ["--optimizer-delay", "0"], None),
    ("training", TRAIN + ["--early-stopping", "-1"], None),
    ("training", TRAIN + ["--cost-type", "foo"], None),
    ("translation", ["--model", ""], None),
    ("server", ["--model", ""], None),
    ("translation", DECODE + ["--weights", "1", "2"], None),
    ("server", DECODE + ["--weights", "1", "2"], None),
    ("translation", DECODE + ["--beam-size", "0"], None),
    ("server", DECODE + ["--beam-size", "0"], None),
]

ACCEPTED = [
    ("training", TRAIN),
    ("training", TRAIN + ["--vocabs", "v.yml", "v.yml", "--label-smoothing",
                          "0.1", "--cost-type", "ce-mean-words"]),
    ("training", TRAIN + ["--dim-emb", "32", "--transformer-heads", "4",
                          "--cost-type", "perplexity"]),
    ("translation", DECODE),
    ("translation", DECODE + ["--type", "transformer", "--beam-size", "1",
                              "--weights", "1"]),
    ("server", DECODE + ["--beam-size", "1"]),
]


def _outcome(parse, argv, mode):
    try:
        parse(argv, mode=mode)
    except (ValueError, SystemExit) as err:
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("mode,argv,port_refusal", REFUSED,
                         ids=lambda x: " ".join(x) if isinstance(x, list)
                         else None)
def test_refused_like_the_reference(mode, argv, port_refusal):
    ref = _outcome(jax_parse, argv, mode)
    assert ref is not None and ref[0] == "ValueError", ref
    got = _outcome(torch_parse, argv, mode)
    if port_refusal is None:
        assert got == ref
    else:
        assert got == ("SystemExit", port_refusal)


@pytest.mark.parametrize("mode,argv", ACCEPTED,
                         ids=lambda x: " ".join(x) if isinstance(x, list)
                         else None)
def test_accepted_like_the_reference(mode, argv):
    assert _outcome(jax_parse, argv, mode) is None
    assert _outcome(torch_parse, argv, mode) is None


@pytest.mark.parametrize("flags", [["--dispatch-window", "4"],
                                   ["--auto-tune"],
                                   ["--mesh", "data:2"]])
def test_parsed_but_unported_features_are_refused_by_the_trainer(flags):
    """Both parsers take these argv; the port's trainer refuses the
    feature by name before anything is built. --tsv, --right-left and
    --guided-alignment, once refused here, now pass the trainer's check
    (test_ported_training_features_pass_the_trainers_check)."""
    argv = ["--type", "transformer", "--train-sets", "a.src", "a.trg",
            *flags]
    assert _outcome(jax_parse, argv, "training") is None
    opts = torch_parse(argv, mode="training")
    with pytest.raises(NotImplementedError, match=flags[0]):
        _refuse_unported(opts)


@pytest.mark.parametrize("flags", [["--tsv", "--train-sets", "a.tsv"],
                                   ["--right-left"],
                                   ["--guided-alignment", "a.txt"]])
def test_ported_training_features_pass_the_trainers_check(flags):
    """Features the trainer refused until this slice ported them: both
    parsers take the argv and the port's trainer lets it through."""
    argv = ["--type", "transformer", "--train-sets", "a.src", "a.trg",
            *flags]
    assert _outcome(jax_parse, argv, "training") is None
    _refuse_unported(torch_parse(argv, mode="training"))


def test_train_cli_refuses_unknown_cost_type(tmp_path):
    model = tmp_path / "m.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "marian_tpu_torch.cli.marian_train",
         "--type", "transformer", "--train-sets", str(DATA / "train.src"),
         str(DATA / "train.trg"), "--model", str(model), "--dim-emb", "32",
         "--transformer-heads", "4", "--transformer-dim-ffn", "64",
         "--enc-depth", "1", "--dec-depth", "1", "--after-batches", "2",
         "--cost-type", "foo", "--cpu-threads", "1"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "ValueError: Unknown --cost-type foo" in proc.stderr
    assert "Up. " not in proc.stderr
    assert not model.exists()


def test_delay_with_dispatch_window_refused_like_the_reference():
    from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
    argv = TRAIN + ["--optimizer-delay", "2", "--dispatch-window", "2"]
    with pytest.raises(ValueError) as ref:
        JGraphGroup(None, jax_parse(argv, mode="training"))
    with pytest.raises(ValueError) as got:
        _refuse_unported(torch_parse(argv, mode="training"))
    assert str(got.value) == str(ref.value)
    assert "--dispatch-window requires --optimizer-delay 1" in str(got.value)
