"""Guided alignment in the port against the JAX package, on the CPU:

- ``WordAlignment.parse`` and ``fill_dense`` (Pharaoh lines with and
  without a probability field, points past the matrix) give the
  reference's points and matrices, and the corpus and batch generator
  cut the same [B, Tt, Ts] guided matrices as the reference's
  ``Corpus`` + ``BatchGenerator``, batch for batch;
- ``EncoderDecoder.loss`` with a ``guided`` batch and its gradients
  against ``marian_tpu.models.encoder_decoder.EncoderDecoder.loss`` on a
  2+2 transformer of dim 32 (one seeded JAX init carried across by
  ``convert.params_from_numpy``), for each guided cost (ce, mse, mult),
  alignment layer (last, 1) and --multi-loss-type (sum, mean): the
  total within rtol 2e-5, the guided cost within rtol 2e-5, each
  gradient within 1e-4 of its own largest magnitude (floored at 1% of
  the model's largest, as tests/test_torch_loss.py does: the attention
  key biases' gradient is rounding noise on both sides);
- the guided layer's cross-attention takes the dense path, every other
  attention the packed kernel's plain version under
  --transformer-packed-attention on;
- beside --valid-sets the port's validator reads no training side
  stream, where the reference's fails (ROADMAP §C).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.cli import marian_train as jtrain
from marian_tpu.common import Options
from marian_tpu.data import BatchGenerator as JBatchGenerator
from marian_tpu.data import Corpus as JCorpus
from marian_tpu.data.alignment import WordAlignment as JAlignment
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu_torch.cli import marian_train as ttrain
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.convert import params_from_numpy
from marian_tpu_torch.data.alignment import WordAlignment
from marian_tpu_torch.data.batch_generator import BatchGenerator
from marian_tpu_torch.data.corpus import Corpus
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.ops.kernels import packed_attention as pa

torch.set_num_threads(2)

VOCAB = 29
LINES = ["0-0 1-1 2-2", "0-1 1-0 3-3-0.5 3-2-0.5", "", "5-0 0-9 1-1",
         "0-0-0.25 0-1 2-1-0.75 junk 4"]


def opts(**over):
    base = {"type": "transformer", "dim-emb": 32, "transformer-heads": 4,
            "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
            "transformer-ffn-activation": "relu", "tied-embeddings-all": True,
            "label-smoothing": 0.1, "precision": ["float32", "float32"],
            "max-length": 64, "guided-alignment": "align.txt"}
    base.update(over)
    return base


@pytest.mark.parametrize("line", LINES)
def test_parse_and_fill_dense_as_the_reference(line):
    got, ref = WordAlignment.parse(line), JAlignment.parse(line)
    assert got.points == ref.points and str(got) == str(ref)
    a = np.zeros((4, 3), np.float32)
    b = np.zeros((4, 3), np.float32)
    got.fill_dense(a)
    ref.fill_dense(b)
    assert np.array_equal(a, b)


def test_corpus_batches_carry_the_reference_matrices(tmp_path):
    rng = np.random.RandomState(4)
    src, trg, al = [], [], []
    for _ in range(40):
        n, m = rng.randint(2, 12), rng.randint(2, 12)
        src.append(" ".join(f"s{rng.randint(20)}" for _ in range(n)))
        trg.append(" ".join(f"t{rng.randint(20)}" for _ in range(m)))
        al.append(" ".join(f"{rng.randint(n)}-{j}" for j in range(m)
                           if rng.rand() < 0.8))
    paths = []
    for name, lines in (("c.src", src), ("c.trg", trg), ("a.txt", al)):
        (tmp_path / name).write_text("\n".join(lines) + "\n")
        paths.append(str(tmp_path / name))
    o = {"guided-alignment": paths[2], "mini-batch": 8, "maxi-batch": 3,
         "max-length": 10, "seed": 3, "shuffle": "data"}
    vocab = DefaultVocab.build(src + trg)
    jvocab = JVocab.build(src + trg)
    got = list(BatchGenerator(Corpus(paths[:2], [vocab, vocab],
                                     TOptions(o)), TOptions(o)))
    ref = list(JBatchGenerator(JCorpus(paths[:2], [jvocab, jvocab],
                                       Options(o)), Options(o),
                               prefetch=False))
    assert len(got) == len(ref) > 3
    for g, r in zip(got, ref):
        assert np.array_equal(g.trg.ids, r.trg.ids)
        assert g.guided_alignment.shape == (g.trg.ids.shape[0],
                                            g.trg.ids.shape[1],
                                            g.src.ids.shape[1])
        assert np.array_equal(g.guided_alignment, r.guided_alignment)


def guided_batch(seed, b=4, ts=9, tt=11):
    rng = np.random.RandomState(seed)

    def seq(t):
        ids = rng.randint(2, VOCAB, size=(b, t)).astype(np.int32)
        mask = np.zeros((b, t), np.float32)
        for i in range(b):
            n = rng.randint(3, t + 1)
            ids[i, n - 1] = 0
            ids[i, n:] = 0
            mask[i, :n] = 1.0
        return ids, mask
    src, smask = seq(ts)
    trg, tmask = seq(tt)
    guided = np.zeros((b, tt, ts), np.float32)
    for i in range(b):
        n, m = int(smask[i].sum()), int(tmask[i].sum())
        line = " ".join(f"{rng.randint(n)}-{j}" for j in range(m)
                        if rng.rand() < 0.7)
        JAlignment.parse(line).fill_dense(guided[i])
    return {"src_ids": src, "src_mask": smask, "trg_ids": trg,
            "trg_mask": tmask, "guided": guided}


def to_port(batch):
    return {k: torch.as_tensor(v).long() if k.endswith("_ids")
            else torch.as_tensor(v) for k, v in batch.items()}


def loss_against_jax(o, batch, key=11):
    jm = jax_model(Options(o), VOCAB, VOCAB)
    jp = jm.init(jax.random.key(key))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jaux), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jb, None, train=True), has_aux=True)(jp)
    tm = create_model(TOptions(o), VOCAB, VOCAB)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    total, aux = tm.loss(tp, to_port(batch), None, train=True)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=2e-5)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=2e-5,
                                   err_msg=k)
    floor = 0.01 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    assert set(tp) == set(jgrads)
    for k, p in tp.items():
        ref = np.asarray(jgrads[k])
        scale = max(float(np.abs(ref).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    return aux


@pytest.mark.parametrize("cost", ["ce", "mse", "mult"])
@pytest.mark.parametrize("layer", ["last", "1"])
@pytest.mark.parametrize("multi", ["sum", "mean"])
def test_loss_and_gradients_match_jax(cost, layer, multi):
    o = opts(**{"guided-alignment-cost": cost,
                "transformer-guided-alignment-layer": layer,
                "multi-loss-type": multi, "guided-alignment-weight": 0.3})
    aux = loss_against_jax(o, guided_batch(12))
    assert aux["guided"].item() > 0


def test_batch_without_matrix_adds_nothing():
    batch = guided_batch(5)
    del batch["guided"]
    aux = loss_against_jax(opts(), batch)
    assert "guided" not in aux


def test_only_the_guided_cross_attention_leaves_the_kernel():
    """--transformer-packed-attention on: 2 encoder self, 2 decoder self
    and 1 cross-attention through the packed kernel's plain version; the
    last layer's cross-attention returns weights, so it goes dense."""
    o = opts(**{"transformer-packed-attention": "on"})
    tm = create_model(TOptions(o), VOCAB, VOCAB)
    jm = jax_model(Options(o), VOCAB, VOCAB)
    tp = params_from_numpy({k: np.asarray(v) for k, v in
                            jm.init(jax.random.key(3)).items()}, "cpu")
    calls = []
    real = pa.packed_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    pa.packed_attention_reference = counted
    try:
        tm.loss(tp, to_port(guided_batch(2)), None, train=True)
        n_guided = len(calls)
        batch = guided_batch(2)
        del batch["guided"]
        tm.loss(tp, to_port(batch), None, train=True)
    finally:
        pa.packed_attention_reference = real
    assert n_guided == 5 and len(calls) - n_guided == 6


def test_validation_reads_no_side_stream(tmp_path):
    """--valid-sets beside --guided-alignment: the reference's validator
    reads the training alignments for the dev set and fails on the
    length mismatch (ROADMAP §C); the port's dev corpus reads none, and
    the trainer validates."""
    data = pathlib.Path(__file__).resolve().parent / "golden" / "data"
    src = (data / "train.src").read_text().splitlines()
    trg = (data / "train.trg").read_text().splitlines()
    (tmp_path / "a.txt").write_text("".join(
        " ".join(f"{min(i, len(a.split()) - 1)}-{i}"
                 for i in range(len(b.split()))) + "\n"
        for a, b in zip(src, trg)))
    (tmp_path / "dev.src").write_text("\n".join(src[:4]) + "\n")
    (tmp_path / "dev.trg").write_text("\n".join(trg[:4]) + "\n")
    v = str(tmp_path / "v.yml")
    DefaultVocab.build(src + trg).save(v)

    def argv(model):
        return ["--type", "transformer", "--train-sets",
                str(data / "train.src"), str(data / "train.trg"),
                "--vocabs", v, v, "--model", str(tmp_path / model),
                "--dim-emb", "32", "--transformer-heads", "4",
                "--transformer-dim-ffn", "64", "--enc-depth", "1",
                "--dec-depth", "1", "--tied-embeddings-all",
                "--mini-batch", "16", "--after-batches", "2",
                "--guided-alignment", str(tmp_path / "a.txt"),
                "--valid-sets", str(tmp_path / "dev.src"),
                str(tmp_path / "dev.trg"), "--valid-freq", "1u",
                "--valid-log", str(tmp_path / f"{model}.valid"), "--quiet"]
    with pytest.raises(ValueError, match="Alignment file length mismatch"):
        jtrain.main(argv("jax.npz"))
    ttrain.main(argv("port.npz") + ["--cpu-threads", "1"])
    assert (tmp_path / "port.npz.valid").read_text().count(
        "cross-entropy") == 2
