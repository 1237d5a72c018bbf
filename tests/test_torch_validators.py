"""Validation, early stopping, --lr-decay and --keep-best in the port
against the JAX package on the CPU.

- ``corpus_bleu`` / ``corpus_chrf`` of ``marian_tpu_torch.translator.
  metrics`` equal the reference's on fixed strings (exactly: the same
  integer counts through the same float operations).
- The cross-entropy, perplexity, ce-mean-words, bleu (bleu-detok and
  bleu-segmented score as bleu, as in the reference) and chrf validators
  equal the JAX validators on one parameter dict (the JAX init of a
  1+1-layer dim-16 transformer) and one dev set: the dev losses to 1e-5
  relative, the decoded hypotheses string for string, hence the scores;
  the translation validator writes the same decodes to
  --valid-translation-output (its {U}/{E} template expanded) and both
  script validators return the same --valid-script-path score.
- ``register_validation`` (per-metric epsilon, ``--early-stopping-on
  first|all|any``), ``keep_going``'s early stop, ``reset_stalled`` and
  every ``maybe_decay_lr`` strategy decide as the JAX ``Scheduler`` over
  scripted value sequences, and a state saved by either package's
  ``TrainingState`` resumes in the other with the same decisions.
- ``marian_train`` of both packages, resumed from one checkpoint (a
  1+1-layer model the port trained for 4 updates) with ``--shuffle
  none`` and no dropout, validating every 2 updates, prints the same
  ``[valid]`` lines (values to 1e-4 relative), writes the same
  ``.best-*`` files and stops at the same update under
  ``--early-stopping``.
"""

import pathlib
import re
import shutil

import numpy as np
import pytest
import torch
import yaml

from marian_tpu.common import Options, prng
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.training.scheduler import Scheduler as JScheduler
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu.training.validators import create_validators as jcreate
from marian_tpu.translator import metrics as jmetrics
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.optimizers.schedule import LRSchedule
from marian_tpu_torch.training.scheduler import Scheduler
from marian_tpu_torch.training.training_state import TrainingState
from marian_tpu_torch.training.validators import create_validators
from marian_tpu_torch.translator import metrics
from tests.test_torch_train import PATHS

torch.set_num_threads(1)

HYPS = ["the cat sat on the mat", "a quick brown fox", "",
        "jumps over the lazy dog dog", "x"]
REFS = ["the cat is on the mat", "the quick brown fox", "nothing here",
        "jumps over the lazy dog", "y z"]


@pytest.mark.parametrize("fn", ["corpus_bleu", "corpus_chrf"])
@pytest.mark.parametrize("rows", [slice(0, 1), slice(0, 2), slice(1, 4),
                                  slice(0, 5), slice(2, 3)])
def test_metrics_equal_the_reference(fn, rows):
    h, r = HYPS[rows], REFS[rows]
    assert getattr(metrics, fn)(h, r) == getattr(jmetrics, fn)(h, r)


# -- validators on one parameter dict ------------------------------------

MODEL = {"type": "transformer", "dim-emb": 16, "transformer-heads": 2,
         "transformer-dim-ffn": 32, "enc-depth": 1, "dec-depth": 1,
         "tied-embeddings-all": True, "max-length": 30, "beam-size": 3,
         "valid-mini-batch": 8, "precision": ["float32", "float32"],
         "seed": 5}


@pytest.fixture(scope="module")
def dev(tmp_path_factory):
    d = tmp_path_factory.mktemp("dev")
    for side, path in zip(("src", "trg"), PATHS):
        lines = pathlib.Path(path).read_text().splitlines()[:20]
        (d / f"dev.{side}").write_text("\n".join(lines) + "\n")
    return d


def _vocabs():
    lines = [l for p in PATHS for l in pathlib.Path(p).read_text()
             .splitlines()]
    return JVocab.build(lines), DefaultVocab.build(lines)


@pytest.mark.parametrize("metric", ["cross-entropy", "perplexity",
                                    "ce-mean-words", "bleu", "bleu-detok",
                                    "bleu-segmented", "chrf"])
def test_validators_equal_the_jax_validators(dev, metric):
    cfg = {**MODEL, "valid-sets": [str(dev / "dev.src"),
                                   str(dev / "dev.trg")],
           "valid-metrics": [metric], "cost-type": "ce-mean-words"}
    jv, tv = _vocabs()
    jm = jax_model(Options(cfg), jv, jv)
    jparams = jm.init(prng.stream(prng.root_key(5), prng.STREAM_INIT))
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    [jval] = jcreate(Options(cfg), [jv, jv], jm)
    tm = create_model(TOptions(cfg), len(tv), len(tv))
    [tval] = create_validators(TOptions(cfg), [tv, tv], tm,
                               torch.device("cpu"))
    assert (tval.name, tval.lower_is_better) == (jval.name,
                                                 jval.lower_is_better)
    if metric.startswith(("bleu", "chrf")):
        jh, jr = jval.decode_dev(jparams)
        th, tr = tval.decode_dev(tparams)
        assert th == jh and tr == jr
        assert any(th)                  # not all empty
        assert tval.validate(tparams) == jval.validate(jparams)
    else:
        np.testing.assert_allclose(tval.validate(tparams),
                                   jval.validate(jparams), rtol=1e-5)


def _script(path: pathlib.Path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("metric", ["translation", "valid-script"])
def test_script_validators_equal_the_jax_validators(dev, metric, tmp_path):
    """``translation`` writes its decodes to --valid-translation-output
    (``{U}`` and ``{E}`` expanded from the training state) and scores
    them with --valid-script-path (here: their word count);
    ``valid-script`` runs the script alone. Both take the last token of
    the script's output, as the reference does."""
    script = (_script(tmp_path / "count.sh", 'wc -w < "$1"')
              if metric == "translation" else
              _script(tmp_path / "score.sh", "echo score: 42.5"))
    out = {}
    for name in ("port", "jax"):
        cfg = {**MODEL, "valid-sets": [str(dev / "dev.src"),
                                       str(dev / "dev.trg")],
               "valid-metrics": [metric], "valid-script-path": script,
               "valid-translation-output": str(tmp_path / f"{name}."
                                               "{U}.{E}.txt")}
        jv, tv = _vocabs()
        jm = jax_model(Options(cfg), jv, jv)
        jparams = jm.init(prng.stream(prng.root_key(5), prng.STREAM_INIT))
        if name == "jax":
            [val] = jcreate(Options(cfg), [jv, jv], jm)
            params, state = jparams, JState(batches=7, epochs=1)
        else:
            [val] = create_validators(
                TOptions(cfg), [tv, tv], create_model(TOptions(cfg), len(tv),
                                                      len(tv)),
                torch.device("cpu"))
            params = {k: torch.tensor(np.asarray(v))
                      for k, v in jparams.items()}
            state = TrainingState(batches=7, epochs=1)
        val.training_state = state
        out[name] = (val.name, val.lower_is_better, val.validate(params))
    assert out["port"] == out["jax"]
    if metric == "translation":
        got = (tmp_path / "port.7.2.txt").read_text()
        assert got == (tmp_path / "jax.7.2.txt").read_text()
        assert len(got.splitlines()) == 20
        assert out["port"][2] == len(got.split())
    else:
        assert out["port"][2] == 42.5


# -- the Scheduler's decisions -------------------------------------------

def _schedulers(cfg):
    return (Scheduler(TOptions(cfg), TrainingState()),
            JScheduler(Options(cfg), JState()))


def _state(s):
    st = s.state
    return (st.stalled, st.max_stalled, st.factor,
            {k: dict(v) for k, v in st.validators.items()})


SEQ = [(5.0, 10.0), (4.9, 10.5), (4.95, 10.4), (4.0, 10.45), (4.0, 11.0),
       (4.5, 10.0), (3.99, 9.0), (3.99, 9.0)]


@pytest.mark.parametrize("on", ["first", "all", "any"])
@pytest.mark.parametrize("eps", [[0.0], [0.05], [0.05, 0.2]])
def test_register_validation_decides_as_jax(on, eps):
    cfg = {"valid-metrics": ["cross-entropy", "bleu"],
           "early-stopping": 3, "early-stopping-epsilon": eps,
           "early-stopping-on": on}
    mine, ref = _schedulers(cfg)
    for ce, bleu in SEQ:
        for s in (mine, ref):
            s.improved = (s.register_validation("cross-entropy", ce, True),
                          s.register_validation("bleu", bleu, False))
        assert mine.improved == ref.improved
        assert _state(mine) == _state(ref)
        assert mine.keep_going() == ref.keep_going()
    for reset_best in (False, True):
        for s in (mine, ref):
            s.reset_stalled(reset_best=reset_best)
        assert _state(mine) == _state(ref) and mine.keep_going()


class _GG:
    """Counts the optimizer resets a decay asks for."""

    def __init__(self):
        self.resets = 0

    def reset_optimizer(self):
        self.resets += 1

    def rebuild(self):
        pass


@pytest.mark.parametrize("strategy,start", [
    ("epoch", [2]), ("batches", [1]), ("stalled", [2]),
    ("epoch+batches", [2, 1]), ("epoch+stalled", [2, 2]),
    ("epoch+stalled", [1]), ("stalled", [1])])
@pytest.mark.parametrize("extra", [{}, {"lr-decay-repeat-warmup": True,
                                        "lr-decay-reset-optimizer": True}])
def test_maybe_decay_lr_decides_as_jax(strategy, start, extra):
    from marian_tpu.optimizers.schedule import LRSchedule as JLRSchedule
    cfg = {"lr-decay": 0.5, "lr-decay-strategy": strategy,
           "lr-decay-start": start, "lr-decay-freq": 3, "learn-rate": 0.1,
           "lr-warmup": "4", **extra}
    mine, ref = _schedulers(cfg)
    sched = (LRSchedule.from_options(TOptions(cfg)),
             JLRSchedule.from_options(Options(cfg)))
    ggs = (_GG(), _GG())
    for epochs, batches, stalled in [(0, 1, 0), (0, 3, 1), (1, 4, 2),
                                     (1, 6, 0), (2, 9, 3), (2, 10, 1),
                                     (3, 12, 2)]:
        for s, sc, gg in zip((mine, ref), sched, ggs):
            s.state.epochs, s.state.batches = epochs, batches
            s.state.stalled = stalled
            s.maybe_decay_lr(sc, gg)
        assert _state(mine) == _state(ref)
        assert sched[0].decay_factor == sched[1].decay_factor
        assert sched[0].warmup_offset == sched[1].warmup_offset
        assert ggs[0].resets == ggs[1].resets
        step = batches + 1
        np.testing.assert_allclose(sched[0](step),
                                   sched[1].host_lr(step), rtol=1e-7)
    assert mine.state.factor < 1.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_validation_state_resumes_across_packages(writer, tmp_path):
    cfg = {"valid-metrics": ["cross-entropy", "chrf"], "early-stopping": 4,
           "early-stopping-on": "any", "lr-decay": 0.5,
           "lr-decay-strategy": "stalled", "lr-decay-start": [2]}
    mine, ref = _schedulers(cfg)
    first = mine if writer == "port" else ref
    for ce, ch in SEQ[:5]:
        first.register_validation("cross-entropy", ce, True)
        first.register_validation("chrf", ch, False)
        first.maybe_decay_lr(type("S", (), {})(), None)
    path = str(tmp_path / "m.npz.progress.yml")
    first.state.save(path)
    mine = Scheduler(TOptions(cfg), TrainingState.load(path))
    ref = JScheduler(Options(cfg), JState.load(path))
    assert _state(mine) == _state(ref) and mine.state.factor < 1.0
    for ce, ch in SEQ[5:]:
        got = [(s.register_validation("cross-entropy", ce, True),
                s.register_validation("chrf", ch, False)) for s in
               (mine, ref)]
        assert got[0] == got[1] and _state(mine) == _state(ref)


# -- the trainers end to end ---------------------------------------------

def _train_argv(d, model, *extra):
    return ["--type", "transformer", "--train-sets", str(d / "t.src"),
            str(d / "t.trg"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--model", str(d / model), "--dim-emb", "16",
            "--transformer-heads", "2", "--transformer-dim-ffn", "16",
            "--enc-depth", "1", "--dec-depth", "1", "--tied-embeddings-all",
            "--mini-batch", "4", "--maxi-batch", "1", "--shuffle", "none",
            "--max-length", "20", "--learn-rate", "0.01",
            "--disp-freq", "1", "--seed", "3", *extra]


def _valid_lines(path):
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        m = re.search(r"\[valid\] (Ep\. \d+ : Up\. \d+ : [\w-]+) : "
                      r"([-\d.e+]+) : (.*)$", line)
        if m:
            out.append((m.group(1), float(m.group(2)), m.group(3)))
    return out


def test_trainers_validate_keep_best_and_stop_alike(dev, tmp_path):
    from marian_tpu.cli import marian_train as jtrain
    from marian_tpu_torch.cli import marian_train
    lines = pathlib.Path(PATHS[0]).read_text().splitlines()[:24]
    tlines = pathlib.Path(PATHS[1]).read_text().splitlines()[:24]
    (tmp_path / "t.src").write_text("\n".join(lines) + "\n")
    (tmp_path / "t.trg").write_text("\n".join(tlines) + "\n")
    _vocabs()[1].save(str(tmp_path / "v.yml"))
    marian_train.main(_train_argv(tmp_path, "start.npz", "--after-batches",
                                  "4", "--cpu-threads", "1"))
    for name in ("port", "jax"):
        for suffix in ("", ".optimizer.npz", ".progress.yml"):
            shutil.copy(tmp_path / f"start.npz{suffix}",
                        tmp_path / f"{name}.npz{suffix}")
    valid = ["--valid-sets", str(dev / "dev.src"), str(dev / "dev.trg"),
             "--valid-freq", "2u", "--valid-metrics", "cross-entropy",
             "perplexity", "--early-stopping", "2",
             "--early-stopping-epsilon", "1e9", "0", "--keep-best",
             "--after-batches", "20"]
    marian_train.main(_train_argv(
        tmp_path, "port.npz", *valid, "--cpu-threads", "1", "--valid-log",
        str(tmp_path / "port.valid.log")))
    jtrain.main(_train_argv(tmp_path, "jax.npz", *valid, "--valid-log",
                            str(tmp_path / "jax.valid.log")))
    got = _valid_lines(tmp_path / "port.valid.log")
    want = _valid_lines(tmp_path / "jax.valid.log")
    assert [(g[0], g[2]) for g in got] == [(w[0], w[2]) for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-4)
    # cross-entropy: new best once, then 2 stalls (epsilon 1e9): stop
    assert [g[2] for g in got if g[0].endswith("cross-entropy")] == [
        "new best", "stalled 1 times", "stalled 2 times"]
    for name in ("port", "jax"):
        state = yaml.safe_load((tmp_path / f"{name}.npz.progress.yml")
                               .read_text())
        assert state["batches"] == 10 and state["stalled"] == 2
    best = sorted(p.name.replace("port", "X") for p in
                  tmp_path.glob("port.best-*.npz"))
    assert best == sorted(p.name.replace("jax", "X") for p in
                          tmp_path.glob("jax.best-*.npz"))
    assert best == ["X.best-cross-entropy.npz", "X.best-perplexity.npz"]


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
