"""decode_attention's kernel order of work, in plain PyTorch, vs the JAX
kernel and the port's plain version; and the launcher's shape rules.

``decode_attention_tiled_reference`` follows the vector kernel: chunks
of the cache walked in order, key groups with their own online softmax
merged in group order.
It must agree with the JAX kernel (Pallas interpret mode, as
tests/test_decode_attention.py runs it) and with the port's plain
version within 2e-5 (f32; sums in another order), with new caches
EXACTLY equal, at lengths on and around the chunk edges, pos
-1 (every position masked; the insert lands where the reference's
dynamic_update_slice puts it, the last position), 0, L - 1 and past L,
and source rows with repeats.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas.decode_attention import decode_attention as jda
from marian_tpu_torch.ops.kernels import decode_attention as kmod
from marian_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_reference, decode_attention_tiled_reference,
    insert_index, vector_layout, vector_path)

torch.set_num_threads(2)

TOL = 2e-5


def _inputs(seed, r, h, L, dh):
    rng = np.random.RandomState(seed)
    q, kn, vn = (rng.randn(r, h, 1, dh).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(r, h, L, dh).astype(np.float32) for _ in range(2))
    src = rng.randint(0, r, r).astype(np.int32)            # repeats
    return q, kn, vn, ck, cv, src, rng


def _pos(kind, rng, r, L):
    return {"-1": -1, "0": 0, "L-1": L - 1, "past L": L + 3,
            "rows": np.array([-1, 0, L - 1, L + 3] + list(
                rng.randint(-1, L + 2, r - 4)), np.int32)[:r]}[kind]


def _check(got, ref):
    out, nk, nv = got
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref[0], np.float32),
                               rtol=TOL, atol=TOL)
    assert np.array_equal(nk.float().numpy(), np.asarray(ref[1], np.float32))
    assert np.array_equal(nv.float().numpy(), np.asarray(ref[2], np.float32))


def _torch_pos(pos):
    return torch.as_tensor(pos) if isinstance(pos, np.ndarray) else pos


# f32 Dh 8 takes 4 lanes a key: 32 groups, chunks of 128 positions
@pytest.mark.parametrize("L", [1, 127, 128, 129, 255, 256, 257, 300, 640])
@pytest.mark.parametrize("pos_kind", ["-1", "0", "L-1", "past L", "rows"])
def test_tiled_matches_jax_kernel_and_plain(L, pos_kind):
    r, h, dh = 6, 2, 8
    q, kn, vn, ck, cv, src, rng = _inputs(L, r, h, L, dh)
    pos = _pos(pos_kind, rng, r, L)
    ref = jda(*(jnp.asarray(a) for a in (q, kn, vn, ck, cv)),
              jnp.asarray(pos, jnp.int32), src_rows=jnp.asarray(src),
              interpret=True)
    args = [torch.as_tensor(a) for a in (q, kn, vn, ck, cv)]
    got = decode_attention_tiled_reference(*args, _torch_pos(pos),
                                           torch.as_tensor(src))
    _check(got, ref)
    plain = decode_attention_reference(*args, _torch_pos(pos),
                                       torch.as_tensor(src))
    _check(got, [t.numpy() for t in plain])


@pytest.mark.parametrize("dh,L", [(64, 32), (64, 33), (64, 95), (20, 70),
                                  (256, 17)])
def test_tiled_layouts_match_plain(dh, L):
    """The f32 layouts the card runs at other head sizes: Dh 64 (16
    lanes a key, chunks of 32), Dh 20 (8 lanes, 3 idle), Dh 256 (two
    vectors a lane, chunks of 8)."""
    r, h = 5, 3
    q, kn, vn, ck, cv, src, rng = _inputs(dh + L, r, h, L, dh)
    pos = torch.as_tensor(_pos("rows", rng, r, L))
    args = [torch.as_tensor(a) for a in (q, kn, vn, ck, cv)]
    plain = decode_attention_reference(*args, pos, torch.as_tensor(src))
    got = decode_attention_tiled_reference(*args, pos, torch.as_tensor(src),
                                           layout=vector_layout(dh, 4))
    _check(got, [t.numpy() for t in plain])


def test_tiled_bf16_caches_match_jax_kernel_bit_for_bit():
    """bf16 caches keep their dtype, and the new caches equal the JAX
    kernel's bit for bit (a copy and one cast insert)."""
    r, h, L, dh = 6, 2, 150, 16
    q, kn, vn, ck, cv, src, rng = _inputs(4, r, h, L, dh)
    pos = _pos("rows", rng, r, L)
    ck16, cv16 = (jnp.asarray(a, jnp.bfloat16) for a in (ck, cv))
    ref = jda(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), ck16, cv16,
              jnp.asarray(pos), src_rows=jnp.asarray(src), interpret=True)
    tk, tv = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in (ck16, cv16))
    got = decode_attention_tiled_reference(
        torch.as_tensor(q), torch.as_tensor(kn), torch.as_tensor(vn), tk, tv,
        torch.as_tensor(pos), torch.as_tensor(src),
        layout=vector_layout(dh, 2))
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    _check(got, ref)
    plain = decode_attention_reference(
        torch.as_tensor(q), torch.as_tensor(kn), torch.as_tensor(vn), tk, tv,
        torch.as_tensor(pos), torch.as_tensor(src))
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])


@pytest.mark.parametrize("pos,at", [(-1, 9), (-3, 7), (-10, 0), (-25, 0),
                                    (0, 0), (4, 4), (9, 9), (10, 9),
                                    (40, 9)])
def test_insert_index_is_dynamic_update_slices(pos, at):
    import jax
    placed = jax.lax.dynamic_update_slice(jnp.zeros(10), jnp.ones(1),
                                          (pos,))
    assert int(np.argmax(np.asarray(placed))) == at
    assert int(insert_index(torch.tensor([pos]), 10)) == at


@pytest.mark.parametrize("dh,itemsize,aligned,vector", [
    (64, 4, True, True), (20, 4, True, True), (30, 4, True, False),
    (2, 4, True, False), (256, 4, True, True), (64, 2, True, True),
    (20, 2, True, False), (40, 2, True, True), (64, 4, False, False)])
def test_vector_path_rule(dh, itemsize, aligned, vector):
    assert vector_path(dh, itemsize, aligned) is vector


@pytest.mark.parametrize("dh,itemsize,layout", [
    (4, 4, (4, 1, 128)), (16, 4, (4, 1, 128)), (20, 4, (8, 1, 64)),
    (32, 4, (8, 1, 64)), (64, 4, (16, 1, 32)), (128, 4, (32, 1, 16)),
    (132, 4, (32, 2, 8)), (256, 4, (32, 2, 8)), (64, 2, (8, 1, 64)),
    (256, 2, (32, 1, 16))])
def test_vector_layout_rule(dh, itemsize, layout):
    """(lanes a key, vectors a lane, chunk): every lane holds whole
    vectors, a group's lanes cover the row, and a chunk of each cache is
    at most 8 KB."""
    assert vector_layout(dh, itemsize) == layout
    lanes, per_lane, chunk = layout
    nv = dh * itemsize // 16
    assert lanes * per_lane >= nv and (lanes == 4 or lanes * per_lane
                                       < 2 * nv)
    assert chunk * dh * itemsize <= 8192
    assert chunk == (4 // per_lane) * (128 // lanes)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_vector_layouts_are_the_built_ones(itemsize):
    """Every layout the launcher can pass, at each head size up to 256
    that takes the vector kernel, is a (lanes, vectors a lane) pair that
    csrc/decode_attention.cu instantiates."""
    src = (Path(kmod.__file__).parents[2] / "csrc"
           / "decode_attention.cu").read_text()
    built = {(int(g), int(f)) for g, f in
             re.findall(r"^\s*CALL\((\d+), (\d+)\);", src, re.M)}
    assert built
    used = {vector_layout(dh, itemsize)[:2] for dh in range(1, 257)
            if vector_path(dh, itemsize)}
    assert used <= built


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    r, h, L, dh = 4, 2, 40, 16
    q, kn, vn, ck, cv, src, rng = _inputs(3, r, h, L, dh)
    before = kmod.decode_attention.launches
    args = [torch.as_tensor(a) for a in (q, kn, vn, ck, cv)]
    got = kmod.decode_attention(*args, -1, src_rows=torch.as_tensor(src))
    plain = decode_attention_reference(*args, -1, torch.as_tensor(src))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert kmod.decode_attention.launches == before
