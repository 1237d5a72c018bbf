"""The port's beam search vs the JAX BeamSearch at tiny size.

JAX decodes with ``--transformer-fused-decode-attention off`` on one
device (its fast CPU path); the port decodes with its default fused
contract, which on the CPU runs the decode kernel's plain version, so the
pending-backpointer logic (caches reordered one step late, on the read)
is what is held against the reference. n-best tokens must be identical
and scores equal within rtol 1e-5 (f32 sums of per-step log-probs; see
test_torch_transformer for where the ulps come from).
"""

import numpy as np
import pytest
import torch

from marian_tpu.translator.beam_search import BeamSearch as JaxBeamSearch
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.translator.beam_search import BeamSearch, topk_rows
from tests.test_torch_transformer import random_batch, tiny_pair

torch.set_num_threads(2)


def _decode_both(beam, normalize, seed, b=3, ts=7, fused="auto"):
    jm, jp, _, tp, opts = tiny_pair(seed=seed)
    o = opts.with_(**{"beam-size": beam, "normalize": normalize,
                      "n-best": True, "max-length": 12,
                      "max-length-factor": 1.5, "num-devices": 1,
                      "transformer-fused-decode-attention": "off"})
    ids, mask = random_batch(23, b, ts, seed=seed + 100)
    ref = JaxBeamSearch(jm, [jp], None, o, None).search(ids, mask)
    to = TOptions(o.as_dict()).with_(
        **{"transformer-fused-decode-attention": fused})
    tm = create_model(to, 23, 23)
    got = BeamSearch(tm, tp, to, torch.device("cpu")).search(ids, mask)
    return ref, got, tm


@pytest.mark.parametrize("beam,normalize,seed", [
    (1, 0.0, 0), (2, 0.6, 1), (6, 0.0, 2), (6, 0.6, 3)])
def test_nbest_matches_jax(beam, normalize, seed):
    ref, got, tm = _decode_both(beam, normalize, seed)
    assert tm.fused_decode_reorder
    assert len(got) == len(ref)
    for r_list, g_list in zip(ref, got):
        assert [h["tokens"] for h in g_list] == [h["tokens"] for h in r_list]
        np.testing.assert_allclose([h["norm_score"] for h in g_list],
                                   [h["norm_score"] for h in r_list],
                                   rtol=1e-5)
        np.testing.assert_allclose([h["score"] for h in g_list],
                                   [h["score"] for h in r_list], rtol=1e-5)


def test_unfused_port_matches_fused_port():
    """Gathering the caches after top-k (unfused) and folding the gather
    into the next step's read (fused) give the same hypotheses."""
    _, fused, _ = _decode_both(6, 0.6, 4, fused="auto")
    _, plain, tm = _decode_both(6, 0.6, 4, fused="off")
    assert not tm.fused_decode_reorder
    for f, p in zip(fused, plain):
        assert [h["tokens"] for h in f] == [h["tokens"] for h in p]
        np.testing.assert_allclose([h["norm_score"] for h in f],
                                   [h["norm_score"] for h in p], rtol=1e-6)


@pytest.mark.parametrize("flat,want", [
    # the 3rd value ties with candidates outside the top 3
    ([[0.5, 1.0, 1.0, 0.2, 1.0, 1.0],
      [3.0, -1e9, -1e9, -1e9, -1e9, 2.0],
      [0.1, 0.3, 0.3, 0.3, 0.0, 0.3]], [[1, 2, 4], [0, 5, 1], [1, 2, 3]]),
    # ties only inside the top 3
    ([[3.0, 1.0, 3.0, 0.0, 2.0, 3.0],
      [0.0, 2.0, 2.0, 1.0, 5.0, 0.5]], [[0, 2, 5], [4, 1, 2]]),
])
def test_topk_ties_go_to_the_lower_index(flat, want):
    flat = torch.tensor(flat)
    vals, idx = topk_rows(flat, 3)
    assert idx.tolist() == want
    ref_order = np.argsort(-flat.numpy(), axis=1, kind="stable")[:, :3]
    assert idx.tolist() == ref_order.tolist()
    assert torch.equal(vals, flat.gather(1, idx))


def test_topk_random_rows_match_stable_sort():
    rng = np.random.RandomState(0)
    flat = rng.randint(0, 5, size=(16, 40)).astype(np.float32)
    _, idx = topk_rows(torch.as_tensor(flat), 6)
    ref = np.argsort(-flat, axis=1, kind="stable")[:, :6]
    assert idx.tolist() == ref.tolist()
