"""The training slice's data and model flags in the port against the JAX
package, on the CPU:

- ``--tsv`` (one tab-separated file, ``--tsv-fields``) and
  ``--right-left`` (the target reversed, EOS last) batches equal the
  reference's ``Corpus`` + ``BatchGenerator``'s, batch for batch, and a
  TSV line with the wrong column count is refused as the reference
  refuses it;
- ``init_params`` under --transformer-depth-scaling and
  --output-omit-bias: the reference's parameter names and shapes for
  each combination, and each weight inside the reference's uniform bound
  scale x sqrt(6 / (fan_in + fan_out)), scale 1/sqrt(l) for layer l's
  attention and FFN weights under depth scaling (the two packages draw
  from different generators, so only the bound can match), filling
  most of it;
- a --right-left model and an --output-omit-bias model (one seeded JAX
  init each, saved with the port's io, no bias key in the file) decode
  to the JAX decoder's tokens through ``marian_decoder`` (beam 3 n-best
  lists; right-left outputs come back in reading order in both) and,
  in request mode, through the port's server against the JAX server.
"""

import asyncio
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

from marian_tpu.cli import marian_decoder as jax_decoder
from marian_tpu.common import Options
from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.data import BatchGenerator as JBatchGenerator
from marian_tpu.data import Corpus as JCorpus
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu_torch.cli import marian_decoder as torch_decoder
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.batch_generator import BatchGenerator
from marian_tpu_torch.data.corpus import Corpus
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models import transformer as T
from marian_tpu_torch.server import server as srv
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).resolve().parent / "golden" / "data"
PATHS = [str(DATA / "train.src"), str(DATA / "train.trg")]
BATCHING = {"mini-batch": 16, "maxi-batch": 4, "maxi-batch-sort": "trg",
            "shuffle": "data", "seed": 5, "max-length": 24}


def _lines():
    return [l for p in PATHS for l in pathlib.Path(p).read_text()
            .splitlines()]


def _batches(paths, o, n_epochs=2):
    vocab, jvocab = DefaultVocab.build(_lines()), JVocab.build(_lines())
    tc = Corpus(paths, [vocab, vocab], TOptions(o))
    jc = JCorpus(paths, [jvocab, jvocab], Options(o))
    got, ref = [], []
    for _ in range(n_epochs):
        got += list(BatchGenerator(tc, TOptions(o)))
        ref += list(JBatchGenerator(jc, Options(o), prefetch=False))
    return got, ref


def _same(got, ref):
    assert len(got) == len(ref) > 4
    for g, r in zip(got, ref):
        for gs, rs in zip(g.sub, r.sub):
            assert np.array_equal(gs.ids, rs.ids)
            assert np.array_equal(gs.mask, rs.mask)
        assert np.array_equal(g.sentence_ids, r.sentence_ids)


@pytest.mark.parametrize("fields", [0, 2])
def test_tsv_batches_as_the_reference(tmp_path, fields):
    src, trg = (pathlib.Path(p).read_text().splitlines() for p in PATHS)
    tsv = tmp_path / "c.tsv"
    tsv.write_text("".join(f"{a}\t{b}\n" for a, b in zip(src, trg)))
    o = {**BATCHING, "tsv": True, "tsv-fields": fields}
    got, ref = _batches([str(tsv)], o)
    _same(got, ref)
    # the same batches as the two files
    plain, _ = _batches(PATHS, BATCHING)
    _same(got, plain)


def test_tsv_refuses_a_short_line_as_the_reference(tmp_path):
    tsv = tmp_path / "bad.tsv"
    tsv.write_text("a b\tc\nd e\n")
    vocab, jvocab = DefaultVocab.build(["a"]), JVocab.build(["a"])
    o = {**BATCHING, "tsv": True}
    with pytest.raises(ValueError) as ref:
        list(JCorpus([str(tsv)], [jvocab, jvocab], Options(o)))
    with pytest.raises(ValueError) as got:
        list(Corpus([str(tsv)], [vocab, vocab], TOptions(o)))
    assert str(got.value) == str(ref.value)


def test_right_left_batches_as_the_reference():
    o = {**BATCHING, "right-left": True}
    got, ref = _batches(PATHS, o)
    _same(got, ref)
    plain, _ = _batches(PATHS, BATCHING)
    # the same sentences, each target reversed before its EOS
    g, p = got[0], plain[0]
    row = int(np.argmax(g.sentence_ids >= 0))
    n = int(g.trg.mask[row].sum())
    prow = int(np.where(p.sentence_ids == g.sentence_ids[row])[0][0])
    assert list(g.trg.ids[row, :n]) == \
        list(p.trg.ids[prow, :n - 1][::-1]) + [p.trg.ids[prow, n - 1]]


@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("omit", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_init_names_shapes_and_bounds_as_the_reference(depth, omit, tied):
    o = {"type": "transformer", "dim-emb": 32, "transformer-heads": 4,
         "transformer-dim-ffn": 64, "enc-depth": 3, "dec-depth": 3,
         "tied-embeddings-all": tied, "transformer-depth-scaling": depth,
         "output-omit-bias": omit, "precision": ["float32", "float32"]}
    jp = jax_model(Options(o), 50, 50).init(jax.random.key(0))
    cfg = T.config_from_options(TOptions(o), 50, 50)
    tp = T.init_params(cfg, 3)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert ("decoder_ff_logit_out_b" in tp) != omit
    for k, v in tp.items():
        if v.dim() < 2 or v.shape[0] == 1:
            continue                                # biases, norms
        layer = int(k.split("_l")[1].split("_")[0]) if "_l" in k and \
            k.split("_l")[1][:1].isdigit() else 0
        scale = 1.0 / math.sqrt(layer) if depth and layer else 1.0
        bound = scale * math.sqrt(6.0 / (v.shape[0] + v.shape[-1]))
        got = float(v.abs().max())
        ref = float(np.abs(np.asarray(jp[k])).max())
        assert got <= bound and ref <= bound * (1 + 1e-6), k
        assert got > 0.9 * bound and ref > 0.9 * bound, k


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{flag: (model path, vocab path)}: one seeded JAX init each, saved
    with the port's io and read by both packages."""
    d = tmp_path_factory.mktemp("train_data_flags")
    vocab = JVocab.build([f"w{i}" for i in range(2, 40)])
    vocab.save(str(d / "v.yml"))
    out = {}
    for flag in ("right-left", "output-omit-bias"):
        _, jp, _, _, opts = tiny_pair(vocab=len(vocab), seed=6,
                                      **{"dim-emb": 32, flag: True})
        path = str(d / f"{flag}.npz")
        mio.save_model(path, {k: np.asarray(v) for k, v in jp.items()},
                       opts.as_yaml())
        out[flag] = (path, str(d / "v.yml"))
    with np.load(out["output-omit-bias"][0]) as z:
        assert "decoder_ff_logit_out_b" not in z.files
    (d / "in.txt").write_text("w3 w4 w5 w6\nw7 w8\nw9 w10 w11 w12 w13\n")
    return out, str(d / "in.txt")


@pytest.mark.parametrize("flag", ["right-left", "output-omit-bias"])
def test_model_decodes_to_the_jax_tokens(models, flag, capsys):
    (path, vocab), inp = models[0][flag], models[1]
    args = ["--models", path, "--vocabs", vocab, vocab, "--input", inp,
            "--beam-size", "3", "--n-best",
            "--quiet"]
    capsys.readouterr()
    jax_decoder.main(args)
    ref = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    torch_decoder.main(args + ["--cpu-threads", "1"])
    got = [l.split(" ||| ") for l in capsys.readouterr().out.splitlines()]
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    assert len(got) == 9 and sum(len(g[1].split()) for g in got) > 9


async def _request(port: int, text: str) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    header = await reader.readline()
    reply = await reader.readexactly(int(header.split()[1]))
    writer.close()
    return reply.decode("utf-8")


def _serve(serve_fn, options, text):
    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(serve_fn(options, ready=ready))
        port = await asyncio.wait_for(ready, 120)
        try:
            return await _request(port, text)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    return asyncio.run(main())


@pytest.mark.parametrize("flag", ["right-left", "output-omit-bias"])
def test_request_mode_serves_the_jax_replies(models, flag, monkeypatch):
    from marian_tpu.server import server as jsrv
    monkeypatch.setattr(jsrv, "HAVE_WS", False)
    monkeypatch.setattr(srv, "HAVE_WS", False)    # the TCP transport
    (path, vocab), inp = models[0][flag], models[1]
    text = pathlib.Path(inp).read_text().strip()
    argv = ["--models", path, "--vocabs", vocab, vocab, "--beam-size", "3",
            "--mini-batch", "4", "--max-length", "16", "--port", "0",
            "--quiet"]
    want = _serve(jsrv._serve, jparse(argv, mode="server"), text)
    got = _serve(srv._serve, parse_options(argv + ["--cpu-threads", "1"],
                                           mode="server"), text)
    assert got == want and got.count("\n") == 2


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """A ``ServingApp`` built from ``parse_options`` enables the port's
    perf plane (--perf-accounting defaults on); disable it again after
    every test, as the other server test files do."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()
