"""bf16 decoding against the JAX package on the CPU, at the tests' tiny
size (tests/test_torch_transformer.py :: tiny_pair) with ``--precision
bfloat16``.

The reference's beam search picks the tokens; both packages then step
through them under teacher forcing (batch rows = sentences, beam 1), and
the f32 logits of every step are held to each other with the
reference's own bf16 tolerance (rtol and atol 2e-2,
tests/test_decode_attention.py). The reference's step runs op by op, so
XLA fuses nothing and rounds where the port rounds; what is left is the
summation order inside the bf16 matrix products, which now and then puts
an f32 sum on the other side of a bf16 rounding boundary: one bf16 step
(2^-8) of one encoder state moves these logits by up to 1.3e-2 of their
largest magnitude (seed 0; seeds 3 and 5 read 0 to a few f32 ulps). The
port's own beam search is run too; how many of its best hypotheses
equal the reference's is printed and asserted only as a floor (the
logits are the gate: a near-tie between two hypotheses may break either
way in bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.translator.beam_search import BeamSearch as JaxBeamSearch
from marian_tpu_torch.common.options import Options as TOptions
from marian_tpu_torch.models import transformer as TT
from marian_tpu_torch.models.encoder_decoder import create_model
from marian_tpu_torch.translator.beam_search import BeamSearch
from tests.test_torch_transformer import random_batch, tiny_pair

torch.set_num_threads(2)

BF16 = {"precision": ["bfloat16", "float32"]}
LOGIT_TOL = 2e-2           # rtol and atol, the reference's bf16 tolerance


def _reference_tokens(jm, jp, opts, ids, mask, beam):
    o = opts.with_(**{"beam-size": beam, "normalize": 0.6, "n-best": False,
                      "max-length": 12, "max-length-factor": 1.5,
                      "num-devices": 1,
                      "transformer-fused-decode-attention": "off"})
    hyps = JaxBeamSearch(jm, [jp], None, o, None).search(ids, mask)
    return [h[0]["tokens"] for h in hyps], o


@pytest.mark.parametrize("seed,beam", [(0, 1), (3, 4), (5, 6)])
def test_bf16_decode_logits_match_jax_under_teacher_forcing(seed, beam):
    jm, jp, _, tp, opts = tiny_pair(seed=seed, **BF16)
    b, ts = 4, 7
    ids, mask = random_batch(23, b, ts, seed=seed + 100)
    ref_tokens, o = _reference_tokens(jm, jp, opts, ids, mask, beam)
    to = TOptions(o.as_dict())
    tm = create_model(to, 23, 23)
    assert tm.cfg.compute_dtype == torch.bfloat16
    cp = TT.cast_params(tp, torch.bfloat16)

    # the port's own beam search on the same sentences
    got = BeamSearch(tm, cp, to, torch.device("cpu")).search(ids, mask)
    same = sum(g[0]["tokens"] == r for g, r in zip(got, ref_tokens))
    print(f"bf16 beam {beam}: {same} of {b} best hypotheses identical")
    assert same >= b // 2

    # teacher forcing on the reference's tokens (EOS = 0 after the end)
    steps = max(len(t) for t in ref_tokens)
    forced = np.zeros((b, steps), np.int32)
    for r, toks in enumerate(ref_tokens):
        forced[r, :len(toks)] = toks
    jmask = jnp.asarray(mask)
    jst = jm.start_state(jp, jm.encode_for_decode(jp, jnp.asarray(ids),
                                                  jmask), jmask, steps)
    tids, tmask = torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask)
    tst = tm.start_state(cp, tm.encode_for_decode(cp, tids, tmask), tmask,
                         steps)
    prev = np.zeros((b, 1), np.int32)
    worst = 0.0
    for t in range(steps):
        jl, jst = jm.step(jp, jst, jnp.asarray(prev), jmask)
        tl, tst = tm.step(cp, tst, torch.as_tensor(prev, dtype=torch.long),
                          tmask)
        ref = np.asarray(jl, np.float32)
        assert tl.dtype == torch.float32
        worst = max(worst, np.abs(tl.numpy() - ref).max())
        np.testing.assert_allclose(tl.numpy(), ref, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {t}")
        prev = forced[:, t:t + 1]
    print(f"bf16 beam {beam}: step logits within {worst:.3g}")
