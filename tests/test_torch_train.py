"""The port's GraphGroup vs the JAX GraphGroup on the golden
``transformer-base`` tiny config (tests/golden/test_golden.py: 2+2
layers, dim 32, Adam, clip-norm 1, label smoothing 0.1, ce-mean-words,
lr 0.05) from identical initial parameters on identical batches (the
JAX corpus and batch generator feed both; the JAX side runs on a
one-device mesh, as the port does).

Per-update mean CE agrees to rtol 1e-5 at update 1, where only f32
summation order separates the two, and to rtol 1e-4 over the rest:
each update feeds the previous one's rounding differences through
Adam, whose normalised step turns a relative gradient difference into
the same relative step difference, so they compound with the update
count. Eight updates keep the file well under a minute on the CPU.
"""

import pathlib

import jax
import numpy as np

from marian_tpu.common import Options, prng
from marian_tpu.data import BatchGenerator, Corpus
from marian_tpu.data.vocab import DefaultVocab
from marian_tpu.models.encoder_decoder import (batch_to_arrays as
                                               jax_batch_to_arrays)
from marian_tpu.models.encoder_decoder import create_model as jax_model
from marian_tpu.parallel import mesh as M
from marian_tpu.training.graph_group import GraphGroup as JGraphGroup
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                     create_model)
from marian_tpu_torch.training.graph_group import GraphGroup

import torch

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).resolve().parent / "golden" / "data"
PATHS = [str(DATA / "train.src"), str(DATA / "train.trg")]
SEED = 1234
N_UPDATES = 8
# tests/golden/test_golden.py :: COMMON + CONFIGS["transformer-base"]
GOLDEN = {
    "precision": ["float32", "float32"],
    "learn-rate": 0.05, "lr-warmup": "0", "optimizer": "adam",
    "optimizer-params": [0.9, 0.98, 1e-9], "clip-norm": 1.0,
    "cost-type": "ce-mean-words", "label-smoothing": 0.1,
    "mini-batch": 16, "maxi-batch": 4, "maxi-batch-sort": "src",
    "shuffle": "data", "seed": SEED, "max-length": 24,
    "exponential-smoothing": 0.0,
    "type": "transformer", "dim-emb": 32, "transformer-heads": 4,
    "transformer-dim-ffn": 64, "enc-depth": 2, "dec-depth": 2,
    "tied-embeddings-all": True, "transformer-ffn-activation": "relu",
}


def test_training_trajectory_matches_jax_graph_group():
    opts = Options(GOLDEN)
    lines = [l for p in PATHS for l in pathlib.Path(p).read_text()
             .splitlines()]
    vocab = DefaultVocab.build(lines)
    corpus = Corpus(PATHS, [vocab, vocab], opts)
    jm = jax_model(opts, vocab, vocab)
    jgg = JGraphGroup(jm, opts, mesh=M.make_mesh(opts, jax.devices()[:1]))
    key = prng.root_key(SEED)
    jgg.initialize(prng.stream(key, prng.STREAM_INIT))
    train_key = prng.stream(key, prng.STREAM_DROPOUT)

    tgg = GraphGroup(create_model(TOptions(GOLDEN), len(vocab), len(vocab)),
                     TOptions(GOLDEN), torch.device("cpu"))
    tgg.initialize({k: np.asarray(v) for k, v in
                    jgg.export_params().items()})

    jl, tl = [], []
    step = 0
    while step < N_UPDATES:
        for batch in BatchGenerator(corpus, opts, prefetch=False):
            step += 1
            jo = jgg.update(jax_batch_to_arrays(batch), step, train_key)
            to = tgg.update(batch_to_arrays(batch, "cpu"), step)
            jl.append(float(jo.loss_sum) / max(float(jo.labels), 1.0))
            tl.append(float(to.loss_sum) / max(float(to.labels), 1.0))
            assert float(to.labels) == float(jo.labels)
            if step >= N_UPDATES:
                break
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
