"""Pretrained and fixed embeddings in the port against the JAX package, on
the CPU:

- ``load_word2vec`` (with and without the 'n dim' header, with and
  without an init table, words outside the vocabulary skipped, a wrong
  width refused) and ``normalize_rows`` (--embedding-normalization)
  equal the reference's, and the trainer's load into a fresh init
  (``train.load_embedding_vectors``) fills the tables the reference's
  naming rule picks (``Wemb`` or ``encoder_Wemb``; ``decoder_Wemb`` or
  the tied ``Wemb``) with the reference's values;
- ``frozen_names`` is the reference's ``_frozen_names`` for each fixed
  side, tied and untied;
- three updates of the golden tiny transformer with
  --embedding-fix-src (tied and untied) and --embedding-fix-trg
  (untied) from one set of parameters on the JAX package's batches: the
  fixed tables are byte-equal to their start, and every other parameter
  is within rtol 1e-4, atol 1e-5 (a hundredth of the rate, 1e-3) of the
  JAX GraphGroup's: Adam's normalised step turns a near-zero gradient's
  rounding difference into a step difference of up to the rate (the
  attention key biases, whose gradient is rounding noise on both sides,
  are left out).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from marian_tpu.common import Options, prng
from marian_tpu.data import BatchGenerator, Corpus
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.layers import embedding_io as jio
from marian_tpu.models.encoder_decoder import (batch_to_arrays as
                                               jax_batch_to_arrays)
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.parallel import mesh as M
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.layers import embedding_io as tio
from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                     create_model)
from marian_tpu_torch.training.graph_group import GraphGroup, frozen_names
from marian_tpu_torch.training.train import load_embedding_vectors

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).resolve().parent / "golden" / "data"
PATHS = [str(DATA / "train.src"), str(DATA / "train.trg")]
GOLDEN = {
    "precision": ["float32", "float32"],
    "learn-rate": 0.001, "lr-warmup": "0", "optimizer": "adam",
    "optimizer-params": [0.9, 0.98, 1e-9], "clip-norm": 1.0,
    "cost-type": "ce-mean-words", "label-smoothing": 0.1,
    "mini-batch": 16, "maxi-batch": 4, "maxi-batch-sort": "src",
    "shuffle": "data", "seed": 1234, "max-length": 24,
    "type": "transformer", "dim-emb": 32, "transformer-heads": 4,
    "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
    "tied-embeddings-all": True, "transformer-ffn-activation": "relu",
}
WORDS = ["the", "a", "house", "<unk>", "not-in-vocab", "x"]


def _lines():
    return [l for p in PATHS for l in pathlib.Path(p).read_text()
            .splitlines()]


def _vec_file(path, header, dim=8, seed=1):
    rng = np.random.RandomState(seed)
    rows = [w + " " + " ".join(f"{v:.6f}" for v in rng.randn(dim))
            for w in WORDS]
    path.write_text((f"{len(WORDS)} {dim}\n" if header else "")
                    + "\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("with_init", [True, False])
def test_load_word2vec_as_the_reference(tmp_path, header, with_init):
    words = ["the", "a", "house", "x", "y"]
    vocab, jvocab = DefaultVocab.build(words), JVocab.build(words)
    path = _vec_file(tmp_path / "v.vec", header)
    init = (np.random.RandomState(2).randn(len(vocab), 8).astype(np.float32)
            if with_init else None)
    got = tio.load_word2vec(path, vocab, 8, init=init)
    ref = jio.load_word2vec(path, jvocab, 8, init=init)
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    with pytest.raises(ValueError, match="dims"):
        tio.load_word2vec(path, vocab, 7)


def test_normalize_rows_as_the_reference():
    t = np.random.RandomState(3).randn(6, 5).astype(np.float32)
    t[2] = 0.0
    assert np.array_equal(tio.normalize_rows(t), jio.normalize_rows(t))


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("norm", [True, False])
def test_trainer_load_fills_the_reference_tables(tmp_path, tied, norm):
    vocab = DefaultVocab.build(_lines())
    jvocab = JVocab.build(_lines())
    src = _vec_file(tmp_path / "s.vec", True, dim=32, seed=4)
    trg = _vec_file(tmp_path / "t.vec", False, dim=32, seed=5)
    o = {**GOLDEN, "tied-embeddings-all": tied,
         "embedding-vectors": [src, trg], "embedding-normalization": norm}
    jm = jax_model(Options(o), jvocab, jvocab)
    init = {k: np.asarray(v) for k, v in jm.init(jax.random.key(0)).items()}
    params = {k: torch.as_tensor(v.copy()) for k, v in init.items()}
    load_embedding_vectors(TOptions(o), params, [vocab, vocab])
    # the reference's rule (marian_tpu/training/train.py, Train.run)
    ref = dict(init)
    for name, path in ((("Wemb" if "Wemb" in ref else "encoder_Wemb"), src),
                       (("decoder_Wemb" if "decoder_Wemb" in ref
                         else "Wemb"), trg)):
        tab = jio.load_word2vec(path, jvocab, 32, init=ref[name])
        ref[name] = jio.normalize_rows(tab) if norm else tab
    assert set(params) == set(ref)
    for k in ref:
        assert np.array_equal(params[k].numpy(), ref[k]), k
    changed = {k for k in ref if not np.array_equal(ref[k], init[k])}
    assert changed == ({"Wemb"} if tied
                       else {"encoder_Wemb", "decoder_Wemb"})


@pytest.mark.parametrize("names", [
    ("Wemb",), ("encoder_Wemb", "decoder_Wemb"), ("Wemb", "decoder_Wemb")])
@pytest.mark.parametrize("fix", [(True, False), (False, True), (True, True)])
def test_frozen_names_as_the_reference(names, fix):
    gg = JGraphGroup.__new__(JGraphGroup)
    gg.params = {n: None for n in names + ("decoder_l1_self_Wq",)}
    gg._fix_src, gg._fix_trg = fix
    assert frozen_names(list(gg.params), *fix) == gg._frozen_names()


@pytest.mark.parametrize("tied,flag", [(True, "embedding-fix-src"),
                                       (False, "embedding-fix-src"),
                                       (False, "embedding-fix-trg")])
def test_fixed_tables_stay_and_the_rest_trains_as_the_reference(tied, flag):
    o = {**GOLDEN, "tied-embeddings-all": tied, flag: True}
    opts = Options(o)
    vocab = JVocab.build(_lines())
    jgg = JGraphGroup(jax_model(opts, vocab, vocab), opts,
                      mesh=M.make_mesh(opts, jax.devices()[:1]))
    key = prng.root_key(1234)
    jgg.initialize(prng.stream(key, prng.STREAM_INIT))
    start = {k: np.asarray(v) for k, v in jgg.export_params().items()}
    tgg = GraphGroup(create_model(TOptions(o), len(vocab), len(vocab)),
                     TOptions(o), torch.device("cpu"))
    tgg.initialize(start)
    fixed = tgg.frozen
    assert fixed == jgg._frozen_names() and fixed
    batches = BatchGenerator(Corpus(PATHS, [vocab, vocab], opts), opts,
                             prefetch=False)
    for step, batch in zip(range(1, 4), batches):
        jgg.update(jax_batch_to_arrays(batch), step,
                   prng.stream(key, prng.STREAM_DROPOUT))
        tgg.update(batch_to_arrays(batch, "cpu"), step)
    got = {k: v.numpy() for k, v in tgg.export_params().items()}
    ref = {k: np.asarray(v) for k, v in jgg.export_params().items()}
    for k in fixed:
        assert np.array_equal(got[k], start[k]), k
    moved = [k for k in got if k not in fixed
             and not np.array_equal(got[k], start[k])]
    assert len(moved) > 10
    for k in got:
        if not k.endswith("_bk"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
