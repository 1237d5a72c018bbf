"""marian_tpu_torch's lexical shortlist against marian_tpu's on the CPU.

- ``LexicalShortlistGenerator`` (text ``src trg prob`` and ``.npz``
  tables, ``first``/``best``/``prune``, the EOS padding to a multiple of
  ``k_multiple``, ``max_k``) gives the JAX generator's index sets, and a
  ``save_binary`` table reads back the same in either package;
- ``output_logits`` with a 1-D [K] shortlist and a 2-D per-row [R, K]
  one, in both per-row forms (the gathered [R, K, D] product and the
  full product followed by a gather), within 2e-5 of the JAX function;
- the dense beam search at beam 1 and 4 with a shortlist gives JAX's
  tokens (scores within 2e-5), also where EOS and its padding
  duplicates tie at the k-th place, and ``--shortlist`` through
  ``Translate`` gives the JAX ``Translate``'s output lines.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.common.io import save_model
from marian_tpu.data.shortlist import LexicalShortlistGenerator as JGen
from marian_tpu.data.shortlist import Shortlist as JShortlist
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models import transformer as JT
from marian_tpu.translator.beam_search import BeamSearch as JaxBeamSearch
from marian_tpu.translator.translator import Translate as JTranslate
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.shortlist import (LexicalShortlistGenerator,
                                             Shortlist,
                                             parse_shortlist_options)
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models import transformer as T
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.translator import beam_search as tbs
from marian_tpu_torch.translator.translator import Translate
from tests.test_torch_transformer import random_batch, tiny_pair

torch.set_num_threads(2)

V = 40
TOL = 2e-5


def vocabs():
    words = {"</s>": 0, "<unk>": 1, **{f"w{i}": i for i in range(2, V)}}
    return JVocab(dict(words)), DefaultVocab(dict(words))


def lex_lines(seed=0):
    """A lex table over w2..w39: every source word 5 targets with
    descending probabilities, a few unknown words and a comment-short
    line the reader skips."""
    rng = np.random.RandomState(seed)
    lines = []
    for s in range(2, V):
        for j, t in enumerate(rng.choice(np.arange(2, V), 5, replace=False)):
            lines.append(f"w{s} w{t} {0.9 / (j + 1):.4f}")
    lines += ["w3 unknown_target 0.5", "unknown_source w4 0.7", "short"]
    return lines


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("lex")
    (d / "lex.s2t").write_text("\n".join(lex_lines()) + "\n",
                               encoding="utf-8")
    return d


@pytest.mark.parametrize("first,best,prune,k_multiple,max_k", [
    (100, 100, 0.0, 128, 0), (4, 3, 0.0, 8, 0), (4, 5, 0.3, 8, 0),
    (0, 2, 0.0, 8, 16), (10, 5, 0.0, 16, 0)])
def test_generator_index_sets_equal_jax(tables, first, best, prune,
                                        k_multiple, max_k):
    jv, tv = vocabs()
    path = str(tables / "lex.s2t")
    jg = JGen(path, jv, jv, first, best, prune, k_multiple, max_k)
    tg = LexicalShortlistGenerator(path, tv, tv, first, best, prune,
                                   k_multiple, max_k)
    rng = np.random.RandomState(first + best)
    for n in (1, 3, 8, 20):
        src = rng.randint(0, V, n)
        got, want = tg.generate(src), jg.generate(src)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.indices.dtype == np.int32 and got.indices[0] == 0
        assert len(got) % k_multiple == 0 or max_k
        np.testing.assert_array_equal(got.reverse_map(np.array([0, 1])),
                                      want.reverse_map(np.array([0, 1])))


def test_npz_round_trip_between_packages(tables, tmp_path):
    """A table the port saves reads back in JAX as the same generator,
    and the other way round; pruning survives the round trip."""
    jv, tv = vocabs()
    tg = LexicalShortlistGenerator(str(tables / "lex.s2t"), tv, tv, 4, 4)
    tg.save_binary(str(tmp_path / "port"))
    jg = JGen(str(tables / "lex.s2t"), jv, jv, 4, 4)
    jg.save_binary(str(tmp_path / "jax.npz"))
    for a, b in ((tmp_path / "port.npz", tmp_path / "jax.npz"),
                 (tmp_path / "jax.npz", tmp_path / "port.npz")):
        got = LexicalShortlistGenerator(str(a), tv, tv, 4, 4, prune=0.25)
        want = JGen(str(b), jv, jv, 4, 4, prune=0.25)
        assert got.table.keys() == want.table.keys()
        for s in want.table:
            np.testing.assert_array_equal(got.table[s], want.table[s])
            np.testing.assert_array_equal(got.probs[s], want.probs[s])
        src = np.arange(2, 12)
        np.testing.assert_array_equal(got.generate(src).indices,
                                      want.generate(src).indices)


def test_parse_shortlist_options_defaults(tables):
    _, tv = vocabs()
    assert parse_shortlist_options([], tv, tv) is None
    g = parse_shortlist_options([str(tables / "lex.s2t")], tv, tv)
    assert (g.first, g.best, g.k_multiple) == (100, 100, 128)
    g = parse_shortlist_options([str(tables / "lex.s2t"), "7", "3", "0.2"],
                                tv, tv)
    assert (g.first, g.best) == (7, 3)
    assert all(len(t) <= 3 for t in g.table.values())


# ---------------------------------------------------------------------------
# output_logits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return tiny_pair(vocab=V, seed=3)


def _states(rows, seed):
    return np.random.RandomState(seed).randn(rows, 16).astype(np.float32)


def test_output_logits_1d_shortlist_matches_jax(pair):
    jm, jp, tm, tp, _ = pair
    x = _states(5, 1)
    sl = np.array([0, 1, 3, 7, 8, 20, 39, 0], np.int32)
    want = np.asarray(JT.output_logits(jm.cfg, jp, jnp.asarray(x),
                                       jnp.asarray(sl)))
    got = T.output_logits(tm.cfg, tp, torch.from_numpy(x),
                          torch.from_numpy(sl).long())
    assert got.shape == (5, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("form", ["gathered", "full"])
def test_output_logits_per_row_shortlist_matches_jax(pair, form,
                                                      monkeypatch):
    """Both per-row forms against the reference's [R, K, d] gather
    einsum; ``per_row_gather_bytes`` picks the form, forced here."""
    jm, jp, tm, tp, _ = pair
    monkeypatch.setattr(T, "per_row_gather_bytes",
                        lambda *a: (0, 1) if form == "gathered" else (1, 0))
    x = _states(4, 2)
    rng = np.random.RandomState(4)
    sl = np.stack([np.sort(rng.choice(V, 8, replace=False))
                   for _ in range(4)]).astype(np.int32)
    sl[:, 0] = 0
    want = np.asarray(JT.output_logits(jm.cfg, jp, jnp.asarray(x),
                                       jnp.asarray(sl)))
    got = T.output_logits(tm.cfg, tp, torch.from_numpy(x),
                          torch.from_numpy(sl).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_per_row_form_is_the_fewer_bytes():
    """transformer-base's serving shape (64 rows, K 1,024, d 512, f32)
    moves fewer bytes through the full product; a narrow table through
    the gather."""
    g, f = T.per_row_gather_bytes(64, 1024, 32000, 512, 4)
    assert f < g
    assert g == 2 * 64 * 1024 * 512 * 4
    g, f = T.per_row_gather_bytes(4, 8, 32000, 512, 4)
    assert g < f


# ---------------------------------------------------------------------------
# the dense search with a shortlist
# ---------------------------------------------------------------------------

def _search_both(pair, beam, shortlist, eos_bias=0.0):
    jm, jp, _, tp, opts = pair
    jp, tp = dict(jp), dict(tp)
    b = np.asarray(jp["decoder_ff_logit_out_b"]).copy()
    b[0, 0] += eos_bias
    jp["decoder_ff_logit_out_b"] = jnp.asarray(b)
    tp["decoder_ff_logit_out_b"] = torch.from_numpy(b)
    o = opts.with_(**{"beam-size": beam, "normalize": 0.6, "n-best": True,
                      "max-length": 12, "max-length-factor": 1.5,
                      "num-devices": 1,
                      "transformer-fused-decode-attention": "off"})
    ids, mask = random_batch(V, 3, 7, seed=5)
    ref = JaxBeamSearch(jm, [jp], None, o, None).search(
        ids, mask, shortlist=JShortlist(shortlist))
    to = TOptions(o.as_dict())
    got = tbs.BeamSearch(create_model(to, V, V), tp, to,
                         torch.device("cpu")).search(
        ids, mask, shortlist=Shortlist(shortlist))
    return ref, got


def _assert_same(ref, got):
    for r, g in zip(ref, got):
        assert [h["tokens"] for h in g] == [h["tokens"] for h in r]
        np.testing.assert_allclose([h["score"] for h in g],
                                   [h["score"] for h in r], atol=TOL,
                                   rtol=0)


SHORTLIST = np.array([0, 1, 2, 5, 7, 9, 11, 13, 17, 20, 23, 29, 0, 0, 0, 0],
                     np.int32)


@pytest.mark.parametrize("beam", [1, 4])
def test_dense_search_with_shortlist_matches_jax(pair, beam):
    ref, got = _search_both(pair, beam, SHORTLIST)
    _assert_same(ref, got)
    allowed = set(SHORTLIST.tolist())
    assert all(set(h["tokens"]) <= allowed for n in got for h in n)


def test_eos_duplicates_tying_at_the_kth_place(pair, monkeypatch):
    """With EOS's bias raised by 1, EOS and its four padding duplicates
    tie at the 4th place of beam 4 (the tie path of ``topk_rows`` runs):
    the port takes the lower coordinates, as lax.top_k does, and gives
    JAX's n-best (three hypotheses that end at once on a duplicate)."""
    ties = []
    plain = tbs.topk_rows

    def counting(flat, k):
        vals = torch.topk(flat, k, dim=-1).values
        kth = vals[:, -1:]
        ties.append(bool((((flat == kth).sum(-1) > (vals == kth).sum(-1))
                          & (kth[:, 0] > tbs.NEG_INF / 2)).any()))
        return plain(flat, k)
    monkeypatch.setattr(tbs, "topk_rows", counting)
    ref, got = _search_both(pair, 4, SHORTLIST, eos_bias=1.0)
    assert any(ties)
    _assert_same(ref, got)
    assert sum(h["tokens"] == [] for n in got for h in n) >= 3


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tables):
    d = tmp_path_factory.mktemp("sl_cli")
    _, jp, _, _, opts = tiny_pair(vocab=V, seed=11)
    save_model(str(d / "model.npz"), {k: np.asarray(v) for k, v in jp.items()},
               opts.as_yaml())
    vocabs()[0].save(str(d / "v.yml"))
    (d / "lex.s2t").write_text((tables / "lex.s2t").read_text())
    return d


@pytest.mark.parametrize("beam", [1, 4])
def test_translate_with_shortlist_matches_jax(model_dir, beam):
    """--shortlist lex.s2t 4 3 through Translate: one shortlist a batch
    from the union of its source words, in both packages; the output
    lines (n-best, scores to six digits aside) are the same."""
    d = model_dir
    argv = ["--models", str(d / "model.npz"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--beam-size", str(beam), "--mini-batch", "3",
            "--shortlist", str(d / "lex.s2t"), "4", "3", "--n-best",
            "--quiet", "--num-devices", "1"]
    rng = np.random.RandomState(8)
    lines = [" ".join(f"w{j}" for j in rng.randint(2, V, n))
             for n in (6, 2, 9, 4, 7)]
    from marian_tpu.common.config_parser import parse_options as jparse
    want = JTranslate(jparse(argv, mode="translation")).run(
        lines=lines, stream=io.StringIO())
    got = Translate(parse_options(argv + ["--cpu-threads", "1"])).run(
        lines=lines, stream=io.StringIO())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        gl, wl = g.split("\n"), w.split("\n")
        assert [l.split(" ||| ")[:2] for l in gl] \
            == [l.split(" ||| ")[:2] for l in wl]
        np.testing.assert_allclose(
            [float(l.split(" ||| ")[2].split()[1]) for l in gl],
            [float(l.split(" ||| ")[2].split()[1]) for l in wl], atol=TOL,
            rtol=0)
