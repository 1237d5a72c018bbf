"""The transformer-base recipe in the port against the JAX package, on
the CPU:

- ``--task`` for each of the four aliases, from the command line and
  from a config file, with and without command-line and config-file
  values beside it: the port's merged options equal the JAX parser's on
  every key both parsers know (the bundle over the config file, the
  command line over the bundle); a bare ``--dynamic-gradient-scaling``
  is factor 2 in both, and ``--mini-batch-fit-step`` gets the
  reference's warning;
- ``--mini-batch-fit``: the grow-then-bisect search sends the same
  probe batches and fits the same budget as JAX's
  ``fit_mini_batch_words``, against graph groups that run out of memory
  above the same token count (``torch.OutOfMemoryError`` against the
  allocator's RESOURCE_EXHAUSTED); the port's probes are real updates of
  a tiny model, run to their end even when they "run out of memory",
  and its parameters and optimizer state come back bit-exact; an error
  that is not an out-of-memory error propagates;
- ``--mini-batch-warmup``: a window's rows and sentences under a budget
  scale equal the JAX generator's, and the update count is parsed (and
  another unit refused) as the reference does;
- ``--dynamic-gradient-scaling`` in ``finalize_update`` against
  ``marian_tpu.parallel.zero.finalize_update`` over 15 steps with an
  outlier and a NaN (linear and log, windows 4 and 100, with and without
  --clip-norm): the gradients that reach the optimizer and ``gstat``
  within 2e-5;
- ``gstat:avg`` and ``gstat:n`` round-trip across the two packages'
  bundles;
- the recipe through ``marian_train``: the fit, the warmup's ramp,
  --mini-batch-track-lr and ``gstat:n`` equal to the update count;
  label-counted LR schedules are still refused by name.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from marian_tpu.common import Options as JOptions
from marian_tpu.common import prng
from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.data import BatchGenerator as JBatchGenerator
from marian_tpu.data import Corpus as JCorpus
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.optimizers import optimizers as jopt
from marian_tpu.parallel.zero import finalize_update as jfinalize
from marian_tpu.training import batch_fit as jfit
from marian_tpu.training import checkpoint as jckpt
from marian_tpu.training import train as jtrain
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu_torch.cli import marian_train as torch_train
from marian_tpu_torch.common import aliases as taliases
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options
from marian_tpu_torch.data.batch_generator import BatchGenerator
from marian_tpu_torch.data.corpus import Corpus
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.optimizers import optimizers as topt
from marian_tpu_torch.training import batch_fit as tfit
from marian_tpu_torch.training import train as ttrain
from marian_tpu_torch.training.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from marian_tpu_torch.training.graph_group import (GraphGroup,
                                                   finalize_update)
from marian_tpu_torch.training.training_state import TrainingState

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).resolve().parent / "golden" / "data"
PATHS = [str(DATA / "train.src"), str(DATA / "train.trg")]
ALIASES = sorted(taliases.ALIASES)
TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    trainer run in this process enables the port's perf plane (the
    parser defaults --perf-accounting on); disable it again after every
    test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()


# -- --task -------------------------------------------------------------------

def _both(argv):
    j = jparse(argv, mode="training").as_dict()
    t = parse_options(argv, mode="training").as_dict()
    keys = set(j) & set(t)
    assert len(keys) > 100
    return {k: (j[k], t[k]) for k in keys}


def _same(pairs):
    assert {k: v for k, v in pairs.items() if v[0] != v[1]} == {}


@pytest.mark.parametrize("task", ALIASES)
@pytest.mark.parametrize("where", ["cli", "config", "config+cli"])
def test_task_merges_as_the_jax_parser(tmp_path, task, where):
    assert taliases.ALIASES == __import__(
        "marian_tpu.common.aliases", fromlist=["ALIASES"]).ALIASES
    base = ["--train-sets", "a", "b", "--vocabs", "v", "v"]
    cfg = tmp_path / "c.yml"
    # config-file values under the bundle (learn-rate, max-length are
    # the bundle's), and one it does not set
    cfg.write_text(yaml.safe_dump({
        "learn-rate": 0.5, "max-length": 40, "seed": 99,
        **({"task": task} if where != "cli" else {})}))
    argv = base + (["--task", task] if where == "cli" else
                   ["--config", str(cfg)])
    if where == "config+cli":
        argv += ["--dim-emb", "256", "--mini-batch-fit", "false",
                 "--learn-rate", "0.001"]
    pairs = _both(argv)
    _same(pairs)
    got = {k: v[1] for k, v in pairs.items()}
    assert got["task"] == task
    bundle = taliases.ALIASES[task]
    if where == "config+cli":
        assert got["dim-emb"] == 256 and got["mini-batch-fit"] is False
        assert got["learn-rate"] == 0.001
    else:
        assert got["dim-emb"] == bundle["dim-emb"]
        assert got["learn-rate"] == bundle["learn-rate"]
        assert got["mini-batch-fit"] is True
    if where != "cli":
        assert got["seed"] == 99 and got["max-length"] == 100


def test_unknown_task_exits_as_jax():
    argv = ["--task", "transformer-huge", "--train-sets", "a", "b"]
    with pytest.raises(SystemExit) as j:
        jparse(argv, mode="training")
    with pytest.raises(SystemExit) as t:
        parse_options(argv, mode="training")
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("flag", [[], ["3"], ["2", "log"], ["1.5", "log"]])
def test_dynamic_gradient_scaling_parses_as_jax(flag):
    argv = ["--train-sets", "a", "b", "--dynamic-gradient-scaling", *flag,
            "--gradient-norm-average-window", "7"]
    pairs = _both(argv)
    _same(pairs)
    j = jopt.OptimizerConfig.from_options(jparse(argv, mode="training"))
    t = topt.OptimizerConfig.from_options(parse_options(argv,
                                                        mode="training"))
    assert (t.dyn_scale_factor, t.dyn_scale_log, t.norm_window) == \
        (j.dyn_scale_factor, j.dyn_scale_log, j.norm_window)
    assert t.dyn_scale_factor == float((flag or ["2"])[0])


def test_mini_batch_fit_step_warns():
    from marian_tpu_torch.common import logging as tlog
    seen = []
    orig = tlog.warn
    try:
        tlog.warn = lambda fmt, *a: seen.append(fmt.format(*a))
        parse_options(["--train-sets", "a", "b", "--mini-batch-fit-step",
                       "5"], mode="training")
        parse_options(["--train-sets", "a", "b"], mode="training")
    finally:
        tlog.warn = orig
    assert seen == ["--mini-batch-fit-step has no effect: bucketed static "
                    "shapes replace the binary batch-fitting search"]
    assert "bucketed static shapes replace the binary batch-fitting " \
        "search" in str(__import__(
            "marian_tpu.common.config_parser",
            fromlist=["x"]).UNIMPLEMENTED_FLAGS["mini-batch-fit-step"])


# -- --mini-batch-fit ----------------------------------------------------------

TINY = {"type": "transformer", "dim-emb": 16, "transformer-heads": 2,
        "transformer-dim-ffn": 32, "enc-depth": 1, "dec-depth": 1,
        "tied-embeddings-all": True, "precision": ["float32", "float32"],
        "max-length": 16, "learn-rate": 0.05, "optimizer": "adam",
        "exponential-smoothing": 1e-3, "dynamic-gradient-scaling": ["2"],
        "optimizer-state-dtype": "bfloat16"}


class JOutOfMemoryAbove:
    """A JAX graph group stand-in that runs out of device memory above
    ``budget`` tokens a batch, recording each probe's batch shape."""
    delay = 1

    def __init__(self, budget):
        self.budget, self.probes = budget, []
        self.params = {"w": jnp.zeros(3)}

    def optimizer_arrays(self):
        return {"t": np.zeros((), np.float32)}

    def load_optimizer_arrays(self, flat):
        pass

    def initialize(self, key, params):
        self.params = params

    def update(self, batches, step, key):
        rows, width = batches[0]["trg_ids"].shape
        self.probes.append((rows, width))
        if rows * width > self.budget:
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while "
                               "trying to allocate")


class OutOfMemoryAbove(GraphGroup):
    """The port's GraphGroup on a tiny model whose update runs to its end
    (optimizer step included) and then raises ``torch.OutOfMemoryError``
    above ``budget`` tokens, as an allocation failing late in the step
    would leave the state half updated; records each probe's shape."""

    def __init__(self, budget, error=torch.OutOfMemoryError):
        opts = Options(TINY)
        super().__init__(create_model(opts, 40, 40), opts,
                         torch.device("cpu"))
        from marian_tpu_torch.models import transformer as T
        self.initialize(T.init_params(self.model.cfg, 3))
        self.budget, self.error, self.probes = budget, error, []

    def update(self, batches, step, generator=None, seed=None):
        if isinstance(batches, dict):
            batches = [batches]
        rows, width = batches[0]["trg_ids"].shape
        self.probes.append((rows, width))
        out = super().update(batches, step, generator, seed)
        if rows * width > self.budget:
            raise self.error("CUDA out of memory (a stand-in)")
        return out


@pytest.mark.parametrize("budget,start", [(5000, 0), (3000, 1024),
                                          (900, 0), (200_000, 65536)])
def test_fit_probes_as_jax_and_restores_bit_exact(budget, start):
    opts = {"max-length": 16, "mini-batch-words": start}
    j = JOutOfMemoryAbove(budget)
    jwords = jfit.fit_mini_batch_words(j, JOptions(opts), 40)
    t = OutOfMemoryAbove(budget)
    params = {k: v.detach().clone() for k, v in t.params.items()}
    opt = {k: v.copy() for k, v in t.optimizer_arrays().items()}
    assert "gstat:n" in opt
    twords = tfit.fit_mini_batch_words(t, Options(opts), 40)
    assert twords == jwords
    assert t.probes == j.probes and len(t.probes) >= 2
    assert any(r * w > budget for r, w in t.probes) or budget > 131072
    assert sorted(t.params) == sorted(params)
    for k, v in params.items():
        assert torch.equal(t.params[k], v), k
        assert t.params[k].requires_grad
    after = t.optimizer_arrays()
    assert sorted(after) == sorted(opt)
    for k, v in opt.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert t.opt_state["m"][next(iter(params))].dtype == torch.bfloat16


def test_fit_lets_other_errors_through():
    t = OutOfMemoryAbove(1000, error=ValueError)
    with pytest.raises(ValueError):
        tfit.fit_mini_batch_words(t, Options({"max-length": 16}), 40)


def test_fit_probe_rows_as_jax():
    for words in (256, 1000, 2048, 50_000, 131072):
        for max_len in (16, 50, 100):
            assert tfit.probe_rows(words, max_len) == \
                max(8, (words // max_len) // 8 * 8)


# -- --mini-batch-warmup ---------------------------------------------------------

def _lines():
    return [l for p in PATHS for l in pathlib.Path(p).read_text().splitlines()]


@pytest.mark.parametrize("words", [0, 200])
def test_warmup_batches_match_jax(words):
    opts = {"mini-batch": 32, "mini-batch-words": words, "maxi-batch": 2,
            "maxi-batch-sort": "trg", "shuffle": "data", "seed": 1234,
            "max-length": 24}
    jv, tv = JVocab.build(_lines()), DefaultVocab.build(_lines())
    jc = JCorpus(PATHS, [jv, jv], JOptions(opts))
    tc = Corpus(PATHS, [tv, tv], Options(opts))

    def ramp():
        scales = iter([0.25, 0.5, 0.75] + [1.0] * 100)
        return lambda: next(scales)
    jb = list(JBatchGenerator(jc, JOptions(opts), prefetch=False,
                              budget_scale=ramp()))
    tb = list(BatchGenerator(tc, Options(opts), budget_scale=ramp()))
    full = list(BatchGenerator(Corpus(PATHS, [tv, tv], Options(opts)),
                               Options(opts)))
    assert len(jb) == len(tb) > len(full)
    for a, b in zip(jb, tb):
        assert a.sub[1].ids.shape == b.sub[1].ids.shape
        assert np.array_equal(a.sentence_ids, b.sentence_ids)
        assert np.array_equal(a.sub[0].ids, b.sub[0].ids)


@pytest.mark.parametrize("raw", ["0", "4", "4u", "16000", "100t", "2e"])
def test_warmup_updates_as_jax(raw):
    opts = {"mini-batch-warmup": raw}
    try:
        want = jtrain._warmup_updates(JOptions(opts))
    except ValueError as e:
        with pytest.raises(ValueError, match="only update-counted"):
            ttrain.warmup_updates(Options(opts))
        assert "only update-counted" in str(e)
        return
    assert ttrain.warmup_updates(Options(opts)) == want


# -- --dynamic-gradient-scaling ---------------------------------------------------

def _grad_steps(seed=5, n=15):
    rs = np.random.RandomState(seed)
    steps = []
    for i in range(n):
        g = {"a": rs.normal(size=(4, 3)).astype(np.float32),
             "b": rs.normal(size=(6,)).astype(np.float32)}
        if i == 7:
            g["a"][1, 2] = np.nan
        if i == 12:
            g = {k: v * 40.0 for k, v in g.items()}
        steps.append(g)
    return steps


@pytest.mark.parametrize("log,window,clip", [
    (False, 4, 0.0), (True, 4, 0.0), (False, 100, 0.0), (True, 4, 2.5),
    (False, 4, 2.5)])
def test_finalize_update_scales_as_jax(log, window, clip):
    o = {"optimizer": "sgd", "clip-norm": clip,
         "dynamic-gradient-scaling": ["2"] + (["log"] if log else []),
         "gradient-norm-average-window": window}
    jcfg = jopt.OptimizerConfig.from_options(JOptions(o))
    tcfg = topt.OptimizerConfig.from_options(Options(o))
    shapes = {"a": (4, 3), "b": (6,)}
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jst = jopt.init_state(jcfg, jp)
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    tst = topt.init_state(tcfg, tp)
    scaled = 0
    for i, g in enumerate(_grad_steps()):
        # params at 0 and lr 1 each step: the update is minus the
        # gradient that reached the optimizer
        new_p, jst, jnorm, _ = jfinalize(
            jcfg, jst, jp, {k: jnp.asarray(v) for k, v in g.items()},
            1.0, jnp.asarray(10.0), jnp.asarray(3.0))
        for v in tp.values():
            v.zero_()
        tnorm, _ = finalize_update(
            tcfg, tst, tp, {k: torch.from_numpy(v.copy())
                            for k, v in g.items()},
            1.0, torch.tensor(10.0), torch.tensor(3.0))
        np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm),
                                   rtol=TOL)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(new_p[k]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {i} {k}")
        for k in ("avg", "n"):
            np.testing.assert_allclose(tst["gstat"][k].numpy(),
                                       np.asarray(jst["gstat"][k]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"step {i} gstat {k}")
        if i == 12 and window == 4:
            # the outlier: scaled down to factor x the windowed average,
            # which takes the outlier's own norm first
            raw = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                    for v in g.values()))) / 3.0
            got = float(torch.sqrt(sum((v.double() ** 2).sum()
                                       for v in tp.values())))
            assert got < 0.75 * raw
            scaled += 1
    # the NaN step left the statistics' count one short
    assert float(tst["gstat"]["n"]) == 14.0
    assert scaled == (1 if window == 4 else 0)


def _jax_gg(dyn=True):
    o = {**TINY, "seed": 7, "optimizer-state-dtype": "float32"}
    if not dyn:
        o.pop("dynamic-gradient-scaling")
    opts = JOptions(o)
    gg = JGraphGroup(jax_model(opts, 40, 40), opts)
    gg.initialize(prng.root_key(7))
    return gg


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"src_ids": rs.randint(2, 40, (8, 6)).astype(np.int32),
            "src_mask": np.ones((8, 6), np.float32),
            "trg_ids": rs.randint(2, 40, (8, 7)).astype(np.int32),
            "trg_mask": np.ones((8, 7), np.float32)}


def test_gstat_round_trips_across_the_packages_bundles(tmp_path):
    t = OutOfMemoryAbove(10 ** 9)
    for i in range(2):
        t.update({k: torch.from_numpy(v.astype(np.int64) if "ids" in k
                                      else v)
                  for k, v in _batch(i).items()}, i + 1)
    assert float(t.opt_state["gstat"]["n"]) == 2.0
    mp = str(tmp_path / "port.npz")
    save_checkpoint(mp, t.export_params(), "x: 1\n", t,
                    TrainingState(batches=2))
    j = _jax_gg()
    jckpt.load_checkpoint(mp, j)
    for k in ("avg", "n"):
        assert float(j.opt_state["gstat"][k]) == \
            float(t.opt_state["gstat"][k])
    # and back: a JAX bundle with its own statistics
    j = _jax_gg()
    for i in range(3):
        j.update(_batch(i), i + 1, jax.random.key(i))
    jp = str(tmp_path / "jax.npz")
    st = JState()
    st.batches = 3
    jckpt.save_checkpoint(jp, j.export_params(), "x: 1\n", j, st)
    t = OutOfMemoryAbove(10 ** 9)
    load_checkpoint(jp, t)
    assert float(t.opt_state["gstat"]["n"]) == 3.0
    for k in ("avg", "n"):
        assert float(t.opt_state["gstat"][k]) == \
            float(np.asarray(j.opt_state["gstat"][k]))


# -- the recipe through marian_train ---------------------------------------------

def test_recipe_through_marian_train(tmp_path):
    lines = _lines()
    DefaultVocab.build(lines).save(str(tmp_path / "v.yml"))
    from marian_tpu_torch.training import graph_group as tgg_mod
    calls = []
    update = tgg_mod.GraphGroup.update

    def recorded(gg, batches, step, *args, **kw):
        calls.append((int(batches[0]["trg_ids"].shape[0]),
                      gg.opt_cfg.ref_mb_words))
        return update(gg, batches, step, *args, **kw)
    tgg_mod.GraphGroup.update = recorded
    try:
        torch_train.main([
            "--task", "transformer-base", "--train-sets", *PATHS,
            "--vocabs", str(tmp_path / "v.yml"), str(tmp_path / "v.yml"),
            "--model", str(tmp_path / "m.npz"), "--dim-emb", "32",
            "--transformer-heads", "4", "--transformer-dim-ffn", "64",
            "--enc-depth", "1", "--dec-depth", "1", "--max-length", "12",
            "--max-length-crop", "--maxi-batch", "1", "--mini-batch", "64",
            "--after-batches", "6", "--mini-batch-warmup", "4",
            "--mini-batch-track-lr", "--dynamic-gradient-scaling", "2",
            "log", "--gradient-norm-average-window", "4", "--overwrite",
            "--disp-freq", "1", "--quiet", "--cpu-threads", "1"])
    finally:
        tgg_mod.GraphGroup.update = update
    # the fit's probes (no CPU runs out of memory: up to the cap), then 6
    # updates with --mini-batch-track-lr anchored at the fitted budget
    probes, updates = calls[:-6], calls[-6:]
    assert len(probes) == 7
    assert probes[-1][0] == tfit.probe_rows(131072, 12)
    assert all(ref == 0 for _, ref in probes)
    assert all(ref == 131072 for _, ref in updates)
    with np.load(tmp_path / "m.npz.optimizer.npz") as z:
        assert float(z["gstat:n"]) == 6.0 == float(z["t"])
        assert np.isfinite(z["gstat:avg"])
    prog = yaml.safe_load((tmp_path / "m.npz.progress.yml").read_text())
    assert prog["batches"] == 6


def test_label_counted_lr_schedules_are_still_refused():
    with pytest.raises(NotImplementedError, match="lr-warmup"):
        from marian_tpu_torch.optimizers.schedule import LRSchedule
        LRSchedule.from_options(Options({"lr-warmup": "16000t"}))
    with pytest.raises(NotImplementedError, match="lr-decay-inv-sqrt"):
        from marian_tpu_torch.optimizers.schedule import LRSchedule
        LRSchedule.from_options(Options({"lr-decay-inv-sqrt": ["16000t"]}))
