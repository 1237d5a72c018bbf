"""marian_tpu_torch's per-row decode-feature plane (translator/
decode_features.py) in the paged engines against marian_tpu's on the
CPU, at the reference's test size (2+2 layers, dim 32, a 35-word
vocabulary, pages of 4, source cap 8, decode cap 12, beam 2).

- ``FeaturePlane``: options, the shortlist and force-decode refusal, the
  TAB convention, the salted cache key and the row shortlist equal the
  JAX plane's;
- the greedy engine (1 and 3 steps a round) and the beam engine (host
  merge, fused merge at 1 and 3 steps), each with a per-row shortlist
  and with forced trunks: tokens identical to the JAX engines with a
  ``FeaturePlane`` (raw scores within 2e-5), every token inside the
  row's shortlist, forced trunks kept;
- sampling at ``topk 1``: tokens identical to the JAX engines; a fixed
  seed replays, identical requests get distinct lanes, the prefix cache
  is off;
- n-best blocks equal request mode's (the port's dense search through
  the same printer) and the JAX engine's; ``cow=False`` is bit-identical
  to ``cow=True``;
- forced trunks salt the prefix cache (replay, live fork, a different
  trunk misses) and an oversized trunk is fatal;
- streaming partials at engine (greedy append-only, beam best-so-far),
  scheduler (``on_partial``) and TCP level (``#stream:1``);
- the server's boot checks (the reference's decode-surface table): the
  plane's flags pass, alignment, word scores and approximate-knn stay
  refused in iteration mode, an unclassified flag is refused,
  ``--shortlist`` with ``--force-decode`` is refused in both modes, and
  ``--n-best`` turns the prefix cache off and runs the beam engine at
  beam 1.
"""

import asyncio

import numpy as np
import pytest
import torch

from marian_tpu.common import Options as JOptions
from marian_tpu.data.shortlist import LexicalShortlistGenerator as JGen
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.translator.beam_iteration import PagedBeamEngine as JBeam
from marian_tpu.translator.decode_features import FeaturePlane as JPlane
from marian_tpu.translator.iteration import PagedDecodeEngine as JGreedy
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.shortlist import LexicalShortlistGenerator
from marian_tpu_torch.data.vocab import EOS_ID, DefaultVocab
from marian_tpu_torch.serving.scheduler import ContinuousScheduler
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
from marian_tpu_torch.translator.beam_search import BeamConfig, BeamSearch
from marian_tpu_torch.translator.beam_search import beam_search
from marian_tpu_torch.translator.decode_features import FeaturePlane
from marian_tpu_torch.translator.iteration import (FATAL_REASONS,
                                                   PagedDecodeEngine)
from marian_tpu_torch.translator.output_collector import OutputPrinter
from marian_tpu_torch.translator.prefix_cache import PrefixCache
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(2)

WORDS = [" ".join(f"w{i}" for i in range(35))]
TEXTS = ["w3 w4 w5", "w6 w7", "w8 w9 w10 w11", "w2 w3"]
FORCED = ["w3 w4 w5\tw6 w7", "w6 w7\tw2", "w8 w9", "w2 w3\tw30 w31 w4"]
K = 2
ARGS = dict(page_len=4, src_len_cap=8, max_length_cap=12)
BEAM = dict(beam_size=K, normalize=0.6, max_rows=2 * K, **ARGS)
SCORE_TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    ``ServingApp`` built from ``parse_options`` enables the port's perf
    plane (the parser defaults --perf-accounting on), which would change
    what later tests in the process see; disable it again after every
    test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, port params, JAX vocab, port
    vocab) from one seeded JAX init."""
    n = len(DefaultVocab.build(WORDS))
    jm, jp, tm, tp, _ = tiny_pair(vocab=n, seed=4, **{"dim-emb": 32})
    return jm, jp, tm, tp, JVocab.build(WORDS), DefaultVocab.build(WORDS)


@pytest.fixture(scope="module")
def lex(tmp_path_factory, tiny):
    """A lex table (.npz): every source word maps to 6 clustered target
    ids, so a sentence's union is a strict subset of the vocabulary;
    with k_multiple 8 the padded widths stay small."""
    n = len(tiny[5])
    srcs, trgs, probs = [], [], []
    for s in range(2, n):
        for j in range(6):
            srcs.append(s)
            trgs.append(2 + (s * 5 + j * 3) % (n - 2))
            probs.append(1.0 / (j + 1))
    path = tmp_path_factory.mktemp("lex") / "lex.npz"
    np.savez(path, srcs=np.array(srcs, np.int32),
             trgs=np.array(trgs, np.int32),
             probs=np.array(probs, np.float32))
    return str(path)


def planes(tiny, lex, kind):
    """(JAX plane, port plane) of one feature."""
    jv, tv = tiny[4], tiny[5]
    if kind == "shortlist":
        return (JPlane(shortlist_gen=JGen(lex, jv, jv, 4, 6, k_multiple=8),
                       k_static=24),
                FeaturePlane(shortlist_gen=LexicalShortlistGenerator(
                    lex, tv, tv, 4, 6, k_multiple=8), k_static=24))
    if kind == "force":
        return JPlane(force_decode=True), FeaturePlane(force_decode=True)
    if kind == "sample":
        return (JPlane(sampling=("topk", 1, 1.0), seed=9),
                FeaturePlane(sampling=("topk", 1, 1.0), seed=9))
    opts = {"n-best": True, "beam-size": K, "normalize": 0.6}
    return (JPlane.from_options(JOptions(opts), jv, jv),
            FeaturePlane.from_options(TOptions(opts), tv, tv))


def drive(eng, texts, metas=None):
    """Decode ``texts`` through the slot machinery, deferred and
    pool-evicted sentences retried; returns (texts by key, info by key)."""
    outs, infos = {}, {}
    pending = list(enumerate(texts))
    guard = 0
    while pending or not eng.idle():
        joins = []
        while pending and len(joins) < max(1, eng.free_slots()):
            key, text = pending.pop(0)
            joins.append((key, text, metas[key]) if metas else (key, text))
        res = eng.admit_and_step(joins)
        for key, why in res.rejected:
            assert why not in FATAL_REASONS, (key, why)
            pending.insert(0, (key, texts[key]))
        for key in res.pool_evicted:
            pending.insert(0, (key, texts[key]))
        outs.update(dict(res.finished))
        infos.update(res.finished_info)
        guard += 1
        assert guard < 1000, "decode failed to converge"
    assert eng.audit() == []
    return outs, infos


def assert_same_beam(got, want):
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for key, info in want[1].items():
        mine = got[1][key]
        assert mine["tokens"][:mine["length"]] \
            == list(info["tokens"][:info["length"]]), key
        assert abs(mine["score"] - info["score"]) <= SCORE_TOL, key


def texts_of(kind):
    return FORCED if kind == "force" else TEXTS


# ---------------------------------------------------------------------------
# the plane itself
# ---------------------------------------------------------------------------

def test_plane_options_and_refusal_as_jax(tiny, lex):
    jv, tv = tiny[4], tiny[5]
    assert FeaturePlane.from_options(TOptions({"beam-size": 2}), tv,
                                     tv) is None
    opts = {"output-sampling": ["topk", "5", "0.7"], "n-best": True,
            "beam-size": 2}
    p = FeaturePlane.from_options(TOptions(opts), tv, tv)
    q = JPlane.from_options(JOptions(opts), jv, jv)
    assert (p.sampling, p.seed, p.n_best, p.cacheable) \
        == (q.sampling, q.seed, q.n_best, q.cacheable) \
        == (("topk", 5, 0.7), 1234, True, False)
    assert p.describe() == q.describe()
    with pytest.raises(ValueError, match="force-decode"):
        FeaturePlane(shortlist_gen=LexicalShortlistGenerator(lex, tv, tv),
                     force_decode=True)
    with pytest.raises(ValueError, match="OutputPrinter"):
        FeaturePlane(n_best=True)


def test_plane_rows_and_keys_as_jax(tiny, lex):
    jv, tv = tiny[4], tiny[5]
    jp, tp = planes(tiny, lex, "shortlist")
    for ids in ([3, 4, 5, 0], [8, 9, 10, 11, 0], [2, 0]):
        got, want = tp.row_shortlist(ids), jp.row_shortlist(ids)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].shape == (24,)
    jf, tf = JPlane(force_decode=True), FeaturePlane(force_decode=True)
    for line in ("w3 w4\tw5 w6", "w3 w4", "w3 w4\t ", "w3\tw4\tw5"):
        assert tf.split_forced(line, tv) == jf.split_forced(line, jv)
    for forced in ([], [5, 6], [5, 7]):
        assert tf.cache_key((3, 4, 0), forced) \
            == jf.cache_key((3, 4, 0), forced)
    assert tf.cache_key((3, 4, 0), [5, 6]) != (3, 4, 0)
    feat = tf.row_features([3, 0], forced=[5, 6], lane=4, stream=True, sid=2)
    assert (feat.forced_at(1), feat.forced_at(2), feat.lane, feat.sid) \
        == (6, -1, 4, 2)


# ---------------------------------------------------------------------------
# engines against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["shortlist", "force", "sample"])
@pytest.mark.parametrize("steps", [1, 3])
def test_greedy_engine_matches_jax(tiny, lex, kind, steps):
    jm, jp, tm, tp, jv, tv = tiny
    jplane, tplane = planes(tiny, lex, kind)
    texts = texts_of(kind)
    args = dict(max_rows=4, steps_per_round=steps, **ARGS)
    got = drive(PagedDecodeEngine(tm, tp, tv, tv, features=tplane, **args),
                texts)
    want = drive(JGreedy(jm, jp, jv, jv, features=jplane, **args), texts)
    assert got[0] == want[0]
    for i, t in enumerate(texts):
        if kind == "shortlist":
            ids = tv.encode(t, add_eos=True)
            allowed = set(tplane.row_shortlist(ids)[0].tolist())
            assert set(tv.encode(got[0][i], add_eos=False)) <= allowed
        if kind == "force" and "\t" in t:
            assert got[0][i].startswith(t.split("\t")[1])


@pytest.mark.parametrize("kind", ["shortlist", "force"])
@pytest.mark.parametrize("merge,steps", [("host", 1), ("fused", 1),
                                         ("fused", 3)])
def test_beam_engine_matches_jax(tiny, lex, kind, merge, steps):
    jm, jp, tm, tp, jv, tv = tiny
    jplane, tplane = planes(tiny, lex, kind)
    texts = texts_of(kind)
    eng = PagedBeamEngine(tm, tp, tv, tv, features=tplane, merge=merge,
                          steps_per_round=steps, **BEAM)
    assert eng.merge == merge
    got = drive(eng, texts)
    want = drive(JBeam(jm, jp, jv, jv, features=jplane, merge=merge,
                       steps_per_round=steps, **BEAM), texts)
    assert_same_beam(got, want)
    if kind == "force":
        for i, t in enumerate(texts):
            if "\t" in t:
                forced = tv.encode(t.split("\t")[1], add_eos=False)
                assert got[1][i]["tokens"][:len(forced)] == forced


def test_beam_engine_matches_the_dense_shortlisted_search(tiny, lex):
    """The fused engine's best hypothesis is the port's dense search over
    the sentence's own shortlist at its decode cap."""
    _, _, tm, tp, _, tv = tiny
    _, tplane = planes(tiny, lex, "shortlist")
    _, infos = drive(PagedBeamEngine(tm, tp, tv, tv, features=tplane,
                                     steps_per_round=3, **BEAM), TEXTS)
    gen = tplane.shortlist_gen
    for i, t in enumerate(TEXTS):
        ids = tv.encode(t, add_eos=True)
        cfg = BeamConfig(beam_size=K, normalize=0.6,
                         max_length=int(min(12, max(8, round(3 * len(ids))))))
        sl = torch.from_numpy(gen.generate(np.unique(ids)).indices).long()
        res = beam_search(tm, tp, cfg, torch.tensor([ids]),
                          torch.ones((1, len(ids))), shortlist=sl)
        best = BeamSearch._collect(*(x.numpy() for x in res[:4]), cfg)[0][0]
        mine = infos[i]
        toks = mine["tokens"][:mine["length"]]
        assert (toks[:-1] if toks and toks[-1] == EOS_ID else toks) \
            == best["tokens"]
        assert abs(mine["score"] - best["score"]) <= SCORE_TOL


def test_sampled_beam_engine_matches_jax(tiny, lex):
    """Sampling runs on the host merge; at topk 1 every hypothesis is the
    argmax trajectory from score 0, as in the JAX engine."""
    jm, jp, tm, tp, jv, tv = tiny
    jplane, tplane = planes(tiny, lex, "sample")
    eng = PagedBeamEngine(tm, tp, tv, tv, features=tplane, merge="fused",
                          steps_per_round=4, **BEAM)
    assert eng.merge == "host" and eng.steps_per_round == 1
    got = drive(eng, TEXTS)
    assert_same_beam(got, drive(JBeam(jm, jp, jv, jv, features=jplane,
                                      merge="host", **BEAM), TEXTS))


@pytest.mark.parametrize("beam", [False, True])
def test_sampling_replays_with_distinct_lanes(tiny, beam):
    """A fixed seed and join schedule replay the output in fresh engines;
    two identical requests in one engine draw on different lanes."""
    _, _, tm, tp, _, tv = tiny

    def one(seed):
        plane = FeaturePlane(sampling=("topk", 5, 0.8), seed=seed)
        eng = (PagedBeamEngine(tm, tp, tv, tv, features=plane, **BEAM)
               if beam else PagedDecodeEngine(tm, tp, tv, tv,
                                              features=plane, max_rows=4,
                                              **ARGS))
        outs, infos = drive(eng, [TEXTS[0]] * 4)
        return eng, outs, {k: (v["tokens"], np.float32(v["score"]))
                           for k, v in infos.items()}
    eng, a_out, a_info = one(31)
    _, b_out, b_info = one(31)
    assert (a_out, a_info) == (b_out, b_info)
    assert eng._lane_ctr == 4 * (K if beam else 1)
    assert len(set(a_out.values())) > 1
    _, c_out, _ = one(32)
    assert c_out != a_out


@pytest.mark.parametrize("beam", [False, True])
def test_sampling_turns_the_prefix_cache_off(tiny, beam):
    _, _, tm, tp, _, tv = tiny
    plane = FeaturePlane(sampling=("full", 1.0), seed=7)
    cache = PrefixCache(max_entries=8, version="v")
    eng = (PagedBeamEngine(tm, tp, tv, tv, features=plane,
                           prefix_cache=cache, **BEAM) if beam
           else PagedDecodeEngine(tm, tp, tv, tv, features=plane,
                                  prefix_cache=cache, max_rows=4, **ARGS))
    assert eng.prefix is None


# ---------------------------------------------------------------------------
# n-best, cow=False
# ---------------------------------------------------------------------------

def _fields(block):
    return [l.split(" ||| ") for l in block.split("\n")]


@pytest.mark.parametrize("merge,steps", [("host", 1), ("fused", 3)])
def test_nbest_blocks_equal_request_mode_and_jax(tiny, lex, merge, steps):
    jm, jp, tm, tp, jv, tv = tiny
    jplane, tplane = planes(tiny, lex, "nbest")
    outs, infos = drive(PagedBeamEngine(tm, tp, tv, tv, features=tplane,
                                        merge=merge, steps_per_round=steps,
                                        **BEAM), TEXTS)
    jouts, _ = drive(JBeam(jm, jp, jv, jv, features=jplane, merge=merge,
                           steps_per_round=steps, **BEAM), TEXTS)
    printer = OutputPrinter(TOptions({"n-best": True}), tv)
    for i, t in enumerate(TEXTS):
        ids = tv.encode(t, add_eos=True)
        cfg = BeamConfig(beam_size=K, normalize=0.6, n_best=K,
                         max_length=int(min(12, max(8, round(3 * len(ids))))))
        res = beam_search(tm, tp, cfg, torch.tensor([ids]),
                          torch.ones((1, len(ids))))
        dense = printer.line(0, BeamSearch._collect(
            *(x.numpy() for x in res[:4]), cfg)[0])
        assert infos[i]["nbest"] and len(outs[i].split("\n")) == K
        for want in (dense, jouts[i]):
            got_f, want_f = _fields(outs[i]), _fields(want)
            assert [f[:2] for f in got_f] == [f[:2] for f in want_f]
            for g, w in zip(got_f, want_f):
                assert abs(float(g[2].split()[1])
                           - float(w[2].split()[1])) < 1e-4
                assert abs(float(g[3]) - float(w[3])) < 1e-4


def test_nbest_at_beam_one_and_the_sentence_ids(tiny, lex):
    """--n-best at beam 1 runs the beam engine (one hypothesis a block);
    a join's sid numbers its block."""
    _, _, tm, tp, _, tv = tiny
    _, plane = planes(tiny, lex, "nbest")
    eng = PagedBeamEngine(tm, tp, tv, tv, features=plane,
                          **{**BEAM, "beam_size": 1})
    outs, _ = drive(eng, TEXTS[:2], metas=[{"sid": 5}, {"sid": 6}])
    assert outs[0].startswith("5 ||| ") and outs[1].startswith("6 ||| ")
    assert len(outs[0].split("\n")) == 1


def test_cow_off_is_bit_identical(tiny):
    """The replication baseline (every child copies its parent's whole
    history) gives the copy-on-write engine's tokens and scores bit for
    bit, copying more pages; it forces the host merge."""
    _, _, tm, tp, _, tv = tiny
    cow = PagedBeamEngine(tm, tp, tv, tv, merge="host", **BEAM)
    sizing = PagedBeamEngine(tm, tp, tv, tv, cow=False, **BEAM)
    rep = PagedBeamEngine(tm, tp, tv, tv, cow=False,
                          pool_bytes=64 * sizing.page_bytes, **BEAM)
    assert rep.merge == "host" and not rep.cow
    a, b = drive(cow, TEXTS), drive(rep, TEXTS)
    assert a[0] == b[0]
    for key in a[1]:
        assert a[1][key]["tokens"] == b[1][key]["tokens"]
        assert np.float32(a[1][key]["score"]) \
            == np.float32(b[1][key]["score"])
    assert rep.counters["copied_pages"] > cow.counters["copied_pages"]


# ---------------------------------------------------------------------------
# force-decode and the prefix cache
# ---------------------------------------------------------------------------

def test_forced_trunk_salts_the_prefix_cache(tiny):
    """(a) a repeat of a finished forced decode replays; (b) a repeat of
    a live one forks copy-on-write; (c) the same source under another
    trunk misses and decodes fresh."""
    _, _, tm, tp, _, tv = tiny
    eng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4,
                            features=FeaturePlane(force_decode=True),
                            prefix_cache=PrefixCache(max_entries=8,
                                                     version="v"), **ARGS)
    line = "w3 w4 w5\tw6 w7"
    outs, _ = drive(eng, [line])
    res = eng.admit_and_step([(1, line)])
    assert dict(res.finished)[1] == outs[0]
    assert eng.counters["replays"] == 1
    line2 = "w6 w7\tw3 w4"
    eng.admit_and_step([(2, line2)])
    eng.admit_and_step([(3, line2)])
    assert eng.counters["forks"] == 1
    fork_outs, _ = drive(eng, [])
    assert fork_outs[2] == fork_outs[3] and fork_outs[2].startswith("w3 w4")
    hits = eng.counters["prefix_hits"]
    other_outs, _ = drive(eng, ["w3 w4 w5\tw2"])
    assert eng.counters["prefix_hits"] == hits
    assert other_outs[0] != outs[0] and other_outs[0].startswith("w2")


@pytest.mark.parametrize("beam", [False, True])
def test_oversized_forced_trunk_is_fatal(tiny, beam):
    _, _, tm, tp, _, tv = tiny
    plane = FeaturePlane(force_decode=True)
    eng = (PagedBeamEngine(tm, tp, tv, tv, features=plane, **BEAM) if beam
           else PagedDecodeEngine(tm, tp, tv, tv, features=plane,
                                  max_rows=4, **ARGS))
    res = eng.admit_and_step([(0, "w3\t" + " ".join(["w4"] * 6))])
    assert res.rejected == [(0, "too_large")]
    assert "forced target prefix" in res.reject_detail[0]


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam", [False, True])
def test_engine_partials(tiny, beam):
    """A streaming row reports its text so far every round it is still
    decoding (greedy: append-only prefixes of the final text; beam: its
    best hypothesis so far, at growing step counts); other rows never
    do."""
    _, _, tm, tp, _, tv = tiny
    eng = (PagedBeamEngine(tm, tp, tv, tv, **BEAM) if beam
           else PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS))
    seen = {0: [], 1: []}
    final = {}
    res = eng.admit_and_step([(0, TEXTS[2], {"stream": True}),
                              (1, TEXTS[0])])
    guard = 0
    while True:
        for key, text, ntok in res.partials:
            seen[key].append((text, ntok))
        final.update(dict(res.finished))
        if eng.idle():
            break
        res = eng.admit_and_step([])
        guard += 1
        assert guard < 100
    assert not seen[1] and seen[0]
    counts = [n for _, n in seen[0]]
    assert counts == sorted(counts) and len(set(counts)) == len(counts)
    if not beam:
        texts = [t for t, _ in seen[0]] + [final[0]]
        for a, b in zip(texts, texts[1:]):
            assert b.startswith(a), (a, b)


def test_scheduler_fans_partials_out(tiny):
    """submit(on_partial=...) delivers the engine's partials each round
    before the final reply, which streaming leaves unchanged."""
    _, _, tm, tp, _, tv = tiny
    eng = PagedDecodeEngine(tm, tp, tv, tv, max_rows=4, **ARGS)
    sched = ContinuousScheduler(batching_mode="iteration", engine=eng,
                                window_s=0.0)
    got = []

    async def main():
        sched.start()
        streamed = sched.submit([TEXTS[2], TEXTS[1]],
                                on_partial=lambda i, t, n:
                                got.append((i, t, n)))
        plain = sched.submit([TEXTS[2], TEXTS[1]])
        out = await streamed, await plain
        await sched.stop()
        return out
    (streamed, plain) = asyncio.run(main())
    assert streamed == plain and got
    assert {i for i, _, _ in got} <= {0, 1}
    assert sched.counts["partials"] == len(got)
    for i, text, _ in got:
        assert streamed[i].startswith(text)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory, tiny):
    d = tmp_path_factory.mktemp("stream")
    tiny[4].save(str(d / "v.yml"))
    _, jp, _, _, opts = tiny_pair(vocab=len(tiny[5]), seed=4,
                                  **{"dim-emb": 32})
    mio.save_model(str(d / "m.npz"),
                   {k: np.asarray(v) for k, v in jp.items()}, opts.as_yaml())
    return str(d / "m.npz"), str(d / "v.yml")


def _server_options(model_file, *extra):
    path, vocab = model_file
    return parse_options(
        ["--models", path, "--vocabs", vocab, vocab, "--batching-mode",
         "iteration", "--beam-size", "1", "--cpu-threads", "1", "--port",
         "0", "--iteration-rows", "4", "--kv-page-len", "4",
         "--max-length", "12", "--quiet", *extra], mode="server")


async def _frames(port, text):
    """One request over MTPU framing: (partial frames, final frame)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    partials = []
    while True:
        header = await reader.readline()
        assert header.startswith(b"MTPU ")
        frame = (await reader.readexactly(int(header.split()[1]))).decode()
        if not frame.startswith(srv.PARTIAL_PREFIX):
            writer.close()
            return partials, frame
        partials.append(frame)


def _serve(options, client_fn):
    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(srv._serve(options, ready=ready))
        port = await asyncio.wait_for(ready, 60)
        try:
            return await client_fn(port)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    return asyncio.run(main())


def test_tcp_stream_partials_then_the_final_reply(model_file, monkeypatch):
    """#stream:1 over TCP: ``#partial:<idx> <text>`` frames, then the
    final reply, equal to the unstreamed one; greedy partials are
    prefixes of it."""
    monkeypatch.setattr(srv, "HAVE_WS", False)    # the TCP transport
    text = "w3 w4 w5 w6 w7\nw8 w9"

    async def clients(port):
        plain = await _frames(port, text)
        streamed = await _frames(port, "#stream:1\n" + text)
        return plain, streamed
    (no_partials, plain), (partials, final) = _serve(
        _server_options(model_file), clients)
    assert not no_partials and final == plain and partials
    lines = plain.split("\n")
    for f in partials:
        idx, _, body = f[len(srv.PARTIAL_PREFIX):].partition(" ")
        assert lines[int(idx)].startswith(body)


def test_server_nbest_runs_the_beam_engine_without_the_cache(model_file,
                                                             monkeypatch):
    """--n-best at beam 1 builds the beam engine with the plane's printer
    and drops --prefix-cache; the reply is the n-best block."""
    monkeypatch.setattr(srv, "HAVE_WS", False)    # the TCP transport
    app = srv.ServingApp(_server_options(model_file, "--n-best",
                                         "--prefix-cache"))
    eng = app.scheduler.engine
    assert isinstance(eng, PagedBeamEngine) and eng.beam_size == 1
    assert eng.prefix is None and eng.features.n_best

    async def clients(port):
        return await _frames(port, "w3 w4 w5\nw6 w7")
    _, reply = _serve(_server_options(model_file, "--n-best"), clients)
    lines = reply.split("\n")
    assert [l.split(" ||| ")[0] for l in lines] == ["0", "1"]
    assert all(" ||| Score= " in l for l in lines)


# ---------------------------------------------------------------------------
# boot checks
# ---------------------------------------------------------------------------

def _validate(*flags):
    srv.ServingApp._validate_options(parse_options(
        ["--models", "absent.npz", "--vocabs", "a.yml", "b.yml",
         "--cpu-threads", "1", "--batching-mode", "iteration",
         "--beam-size", "2", "--iteration-rows", "8", *flags],
        mode="server"))


@pytest.mark.parametrize("flags", [
    ["--n-best"], ["--output-sampling", "full", "0.8"], ["--force-decode"],
    ["--shortlist", "lex.npz"], ["--n-best", "--output-sampling", "topk",
                                 "10"]])
def test_plane_flags_pass_the_boot_checks(flags):
    _validate(*flags)


@pytest.mark.parametrize("flag,value", [("--alignment", ["soft"]),
                                        ("--word-scores", []),
                                        ("--output-approx-knn",
                                         ["8", "128"])])
def test_unsupported_flags_still_refused(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        _validate(flag, *value)


@pytest.mark.parametrize("mode", ["iteration", "request"])
def test_shortlist_with_force_decode_refused_at_boot(mode):
    with pytest.raises(ValueError, match="full-vocab"):
        srv.ServingApp._validate_options(parse_options(
            ["--models", "absent.npz", "--vocabs", "a.yml", "b.yml",
             "--cpu-threads", "1", "--batching-mode", mode, "--shortlist",
             "lex.npz", "--force-decode"], mode="server"))


def test_unclassified_decode_flag_refused_loudly(monkeypatch):
    """A decode flag with no verdict in ITERATION_DECODE_SURFACE is
    refused as UNCLASSIFIED, never decoded without its feature; every
    shipped flag has a verdict."""
    monkeypatch.setattr(srv.ServingApp, "DECODE_SURFACE_FLAGS",
                        srv.ServingApp.DECODE_SURFACE_FLAGS + ("allow-unk",))
    with pytest.raises(NotImplementedError, match="UNCLASSIFIED"):
        _validate("--allow-unk")
    for flag in srv.ServingApp.DECODE_SURFACE_FLAGS[:-1]:
        assert flag in srv.ServingApp.ITERATION_DECODE_SURFACE
