"""marian_tpu_torch's dense decode surface against marian_tpu's on the
CPU: force-decode, per-word scores and output sampling in the beam
search, ``Translate`` and the output printer.

- force-decode (a target prefix a sentence, -1 padded) at beam 1 and 4:
  tokens identical to the JAX search, raw scores within 2e-5; the forced
  tokens keep their true log-probs, so the per-word scores of the trunk
  are the model's; the search refuses a shortlist with a prefix and a
  prefix as long as the cap;
- ``--word-scores``: the trail within 2e-5 of JAX's, summing to the raw
  score; the printer's single-best and n-best lines are the JAX
  printer's;
- sampling at ``topk 1``: tokens identical to JAX's sampled search (every
  beam its own trajectory from score 0). The pick (``sample_pick``) is
  held to the reference's lines on shared numpy noise. The noise
  (``gumbel_noise``) is a function of (seed, lane, step, coordinate):
  the same arguments replay it bit for bit, a row's draws do not depend
  on the rows beside it, other lanes and steps draw otherwise; drawn
  tokens lie inside the top n; at a fixed seed the draws' frequencies
  follow the softmax;
- ``Translate`` with ``--force-decode`` (two ``--input`` files, or TAB
  lines through ``run``), ``--word-scores`` and ``--output-sampling
  topk 1`` prints the JAX ``Translate``'s lines.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.common.io import save_model
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.translator.beam_search import BeamSearch as JaxBeamSearch
from marian_tpu.translator.output_collector import \
    OutputPrinter as JPrinter
from marian_tpu.translator.translator import Translate as JTranslate
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.shortlist import Shortlist
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.translator.beam_search import (NEG_INF, BeamSearch,
                                                     gumbel_noise,
                                                     noise_bits,
                                                     sample_pick)
from marian_tpu_torch.translator.output_collector import OutputPrinter
from marian_tpu_torch.translator.translator import Translate
from tests.test_torch_transformer import random_batch, tiny_pair

torch.set_num_threads(2)

V = 40
TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(vocab=V, seed=3)


def _search_both(pair, beam, prefix=None, **opts_over):
    jm, jp, _, tp, opts = pair
    o = opts.with_(**{"beam-size": beam, "normalize": 0.6, "n-best": True,
                      "max-length": 12, "max-length-factor": 1.5,
                      "num-devices": 1,
                      "transformer-fused-decode-attention": "off",
                      **opts_over})
    ids, mask = random_batch(V, 3, 7, seed=5)
    ref = JaxBeamSearch(jm, [jp], None, o, None).search(ids, mask,
                                                        prefix=prefix)
    to = TOptions(o.as_dict())
    got = BeamSearch(create_model(to, V, V), tp, to,
                     torch.device("cpu")).search(ids, mask, prefix=prefix)
    return ref, got


def _assert_same(ref, got, word_scores=False):
    for r, g in zip(ref, got):
        assert [h["tokens"] for h in g] == [h["tokens"] for h in r]
        np.testing.assert_allclose([h["score"] for h in g],
                                   [h["score"] for h in r], atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose([h["norm_score"] for h in g],
                                   [h["norm_score"] for h in r], atol=TOL,
                                   rtol=0)
        if word_scores:
            for hg, hr in zip(g, r):
                np.testing.assert_allclose(hg["word_scores"],
                                           hr["word_scores"], atol=TOL,
                                           rtol=0)


PREFIX = np.array([[5, 6, 7], [9, -1, -1], [-1, -1, -1]], np.int32)


@pytest.mark.parametrize("beam", [1, 4])
def test_force_decode_matches_jax(pair, beam):
    ref, got = _search_both(pair, beam, prefix=PREFIX)
    _assert_same(ref, got)
    for i, row in enumerate(PREFIX):
        forced = [int(t) for t in row if t >= 0]
        for h in got[i]:
            assert h["tokens"][:len(forced)] == forced


@pytest.mark.parametrize("beam", [1, 4])
def test_word_scores_match_jax_and_sum_to_the_score(pair, beam):
    ref, got = _search_both(pair, beam, prefix=PREFIX,
                            **{"word-scores": True})
    _assert_same(ref, got, word_scores=True)
    for nbest in got:
        for h in nbest:
            assert len(h["word_scores"]) >= len(h["tokens"])
            assert abs(sum(h["word_scores"]) - h["score"]) < 1e-4
            # a forced token keeps its true log-prob: never NEG_INF
            assert all(w > NEG_INF / 2 for w in h["word_scores"])


def test_search_refusals(pair):
    _, _, tm, tp, opts = pair
    o = TOptions(opts.with_(**{"beam-size": 2, "max-length": 12}).as_dict())
    bs = BeamSearch(create_model(o, V, V), tp, o, torch.device("cpu"))
    ids, mask = random_batch(V, 2, 5, seed=1)
    with pytest.raises(ValueError, match="lexical shortlist"):
        bs.search(ids, mask, shortlist=Shortlist(np.arange(8)),
                  prefix=np.zeros((2, 1), np.int32))
    with pytest.raises(ValueError, match="exceeds --max-length"):
        bs.search(ids, mask, prefix=np.zeros((2, 12), np.int32))


@pytest.mark.parametrize("n_best", [False, True])
def test_printer_word_scores_match_jax(n_best):
    words = {"</s>": 0, "<unk>": 1, "a": 2, "b": 3}
    opts = {"n-best": n_best, "word-scores": True}
    nbest = [{"tokens": [2, 3], "score": -1.5, "norm_score": -0.75,
              "word_scores": [-0.5, -0.25, -0.75]},
             {"tokens": [3], "score": -2.0, "norm_score": -1.0,
              "word_scores": [-1.25, -0.75]}]
    got = OutputPrinter(TOptions(opts), DefaultVocab(words)).line(3, nbest)
    want = JPrinter(TOptions(opts), JVocab(words)).line(3, nbest)
    assert got == want and "WordScores= " in got


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam", [1, 3])
def test_sampling_topk1_matches_jax(pair, beam):
    """At ``topk 1`` the draw is the argmax whatever the noise: every beam
    its own trajectory from score 0, as the JAX sampled search."""
    ref, got = _search_both(pair, beam,
                            **{"output-sampling": ["topk", "1"]})
    _assert_same(ref, got)


def _reference_pick(logp, g, temp, n):
    """The reference's sampled pick (beam_search_jit), on JAX arrays."""
    slp = logp / max(temp, 1e-6)
    if n:
        kth = jax.lax.top_k(slp, n)[0][..., -1:]
        slp = jnp.where(slp < kth, -1e9, slp)
    return jnp.argmax(slp + g, axis=-1)


@pytest.mark.parametrize("temp,n", [(1.0, 0), (0.7, 0), (1.0, 5),
                                    (0.5, 3), (2.0, 1)])
def test_pick_matches_the_reference_lines_on_shared_noise(temp, n):
    rng = np.random.RandomState(int(temp * 10) + n)
    logp = np.log(rng.dirichlet(np.ones(30), size=(4, 3))).astype(np.float32)
    logp[:, :, 7] = NEG_INF                    # a suppressed coordinate
    g = rng.gumbel(size=logp.shape).astype(np.float32)
    want = np.asarray(_reference_pick(jnp.asarray(logp), jnp.asarray(g),
                                      temp, n))
    got = sample_pick(torch.from_numpy(logp), torch.from_numpy(g), temp, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_is_a_function_of_seed_lane_step_coordinate():
    coords = torch.arange(1000)
    a = noise_bits(7, 3, 11, coords)
    assert torch.equal(a, noise_bits(7, 3, 11, coords))
    assert a.dtype == torch.int64 and int(a.min()) >= 0 \
        and int(a.max()) < 2 ** 32
    # a row's draws do not depend on the rows beside it
    lanes = torch.tensor([[3], [5], [3]])
    rows = noise_bits(7, lanes, torch.tensor([[11], [2], [11]]),
                      coords[None, :])
    assert torch.equal(rows[0], a) and torch.equal(rows[2], a)
    # another seed, lane, step or coordinate draws otherwise
    for other in (noise_bits(8, 3, 11, coords), noise_bits(7, 4, 11, coords),
                  noise_bits(7, 3, 12, coords),
                  noise_bits(7, 3, 11, coords + 1000)):
        assert float((other == a).double().mean()) < 0.01
    g = gumbel_noise(7, 3, 11, torch.arange(200000))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    # a standard gumbel: mean Euler's gamma, variance pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_draws_stay_inside_the_top_n_and_follow_the_softmax():
    """At a fixed seed: topk 3 draws only the 3 most probable tokens;
    full sampling at temperature 1 draws each token at its probability
    (20,000 draws, one step each on its own lane)."""
    p = np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04])
    logp = torch.log(torch.tensor(p, dtype=torch.float32))[None, :].expand(
        20000, -1)
    lanes = torch.arange(20000)[:, None]
    noise = gumbel_noise(1234, lanes, 0, torch.arange(6)[None, :])
    top3 = sample_pick(logp, noise, 1.0, 3)
    assert set(top3.tolist()) == {0, 1, 2}
    full = sample_pick(logp, noise, 1.0, 0)
    freq = np.bincount(full.numpy(), minlength=6) / 20000.0
    np.testing.assert_allclose(freq, p, atol=0.012)
    # a lower temperature sharpens toward the argmax
    cold = np.bincount(sample_pick(logp, noise, 0.3, 0).numpy(),
                       minlength=6) / 20000.0
    assert cold[0] > freq[0] + 0.2


def test_sampled_search_replays_and_distinct_calls_differ(pair):
    """The same seed replays a sampled search in a fresh BeamSearch; the
    second call of one BeamSearch draws on the next lane."""
    _, _, _, tp, opts = pair
    o = TOptions(opts.with_(**{"beam-size": 3, "n-best": True,
                               "max-length": 12,
                               "output-sampling": ["full", "1.0"],
                               "seed": 5}).as_dict())
    ids, mask = random_batch(V, 3, 7, seed=5)

    def toks(bs):
        return [[h["tokens"] for h in n] for n in bs.search(ids, mask)]
    a = BeamSearch(create_model(o, V, V), tp, o, torch.device("cpu"))
    b = BeamSearch(create_model(o, V, V), tp, o, torch.device("cpu"))
    first = toks(a)
    assert first == toks(b)
    assert toks(a) != first


# ---------------------------------------------------------------------------
# Translate end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface_cli")
    _, jp, _, _, opts = tiny_pair(vocab=V, seed=11)
    save_model(str(d / "model.npz"), {k: np.asarray(v) for k, v in jp.items()},
               opts.as_yaml())
    JVocab({"</s>": 0, "<unk>": 1,
            **{f"w{i}": i for i in range(2, V)}}).save(str(d / "v.yml"))
    rng = np.random.RandomState(12)
    src = [" ".join(f"w{j}" for j in rng.randint(2, V, n))
           for n in (6, 3, 9, 4)]
    pfx = ["w5 w6", "", "w7", "w9 w9 w9"]
    (d / "src.txt").write_text("\n".join(src) + "\n")
    (d / "pfx.txt").write_text("\n".join(pfx) + "\n")
    return d, src, pfx


def _argv(d, *extra):
    return ["--models", str(d / "model.npz"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--beam-size", "3", "--mini-batch", "2",
            "--quiet", "--num-devices", "1", *extra]


def _split_scores(text):
    """Output lines with every score field replaced, and the scores."""
    import re
    score = re.compile(r"-?\d+\.\d{6}")
    return score.sub("S", text), [float(x) for x in score.findall(text)]


@pytest.mark.parametrize("extra", [
    ("--force-decode",), ("--force-decode", "--word-scores"),
    ("--force-decode", "--n-best", "--word-scores"),
    ("--output-sampling", "topk", "1", "--n-best")])
def test_translate_matches_jax(model_dir, extra, tmp_path):
    d, src, pfx = model_dir
    files = ["--input", str(d / "src.txt"), str(d / "pfx.txt")] \
        if "--force-decode" in extra else ["--input", str(d / "src.txt")]
    jout, tout = tmp_path / "jax.out", tmp_path / "port.out"
    JTranslate(jparse(_argv(d, *extra, *files, "--output", str(jout)),
                      mode="translation")).run()
    Translate(parse_options(_argv(d, *extra, *files, "--output", str(tout),
                                  "--cpu-threads", "1"))).run()
    got, want = tout.read_text(), jout.read_text()
    gs, gv = _split_scores(got)
    ws, wv = _split_scores(want)
    assert gs == ws
    np.testing.assert_allclose(gv, wv, atol=TOL, rtol=0)
    if "--force-decode" in extra and "--n-best" not in extra:
        for line, p in zip(got.splitlines(), pfx):
            assert line.split(" ||| ")[0].startswith(p)


def test_force_decode_tab_lines_equal_the_two_files(model_dir):
    """``run(lines=...)`` (the request-mode server's call) reads
    ``source<TAB>prefix`` lines as the two --input files."""
    d, src, pfx = model_dir
    opts = parse_options(_argv(d, "--force-decode", "--cpu-threads", "1",
                               "--input", str(d / "src.txt"),
                               str(d / "pfx.txt")))
    out = io.StringIO()
    Translate(opts).run(stream=out)
    got = Translate(opts).run(lines=[f"{s}\t{p}" for s, p in zip(src, pfx)],
                              stream=io.StringIO())
    assert got == out.getvalue().splitlines()


def test_force_decode_needs_a_prefix_line_a_sentence(model_dir, tmp_path):
    d, _, _ = model_dir
    (tmp_path / "short.txt").write_text("w5\n")
    tr = Translate(parse_options(_argv(
        d, "--force-decode", "--cpu-threads", "1", "--input",
        str(d / "src.txt"), str(tmp_path / "short.txt"))))
    with pytest.raises(ValueError, match="one \\(possibly empty\\) prefix"):
        tr.run(stream=io.StringIO())
    tr = Translate(parse_options(_argv(
        d, "--force-decode", "--cpu-threads", "1", "--input",
        str(d / "src.txt"))))
    with pytest.raises(ValueError, match="2 --input files"):
        tr.run(stream=io.StringIO())


@pytest.mark.parametrize("flag,value", [("--alignment", ["soft"]),
                                        ("--output-approx-knn", ["8", "4"]),
                                        ("--weights", ["1.0"])])
def test_still_refused_by_name(model_dir, flag, value):
    d, _, _ = model_dir
    with pytest.raises(NotImplementedError, match=flag):
        Translate(parse_options(_argv(d, "--cpu-threads", "1", flag,
                                      *value)))
