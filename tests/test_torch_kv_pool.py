"""marian_tpu_torch paged KV pool vs the JAX reference
(``marian_tpu/ops/pallas/kv_pool.py``) at tiny shapes.

- ``paged_decode_attention`` on the CPU (the insert, then the plain
  version ``paged_decode_attention_reference``) against the JAX kernel in
  interpret mode: outputs within 2e-5 (f32 sums in another order), pools
  after the insert exact. Cases: rows at pos 0, page_len - 1, page_len
  and the last position, an idle row (pos -1), rows that joined at other
  times, a page table permuted over a larger pool.
- The paged plain version equals the port's dense plain version
  ``decode_attention_reference`` BITWISE on the same content (the same op
  chain after the gather), as the reference pins for its own pair.
- One operation sequence replayed on both ``KVPool``s gives the same
  results, errors, claims, refcounts, stats and audits.
- The launcher's route for each shape class: the vector kernel, with 2
  chunk buffers at two blocks an SM and more and 4 below, or the scalar
  kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu.ops.pallas import kv_pool as jkv
from marian_tpu_torch.ops.kernels import kv_pool as tkv
from marian_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_reference)

torch.set_num_threads(2)

R, H, DH, PL, MP = 5, 2, 8, 4, 4


def _case(seed, pos, n_pages=1 + R * MP, permute=False):
    """q, k_new, v_new, random pools (every page, the trash page too) and
    a page table giving each row MP pages of its own."""
    rng = np.random.RandomState(seed)
    q, kn, vn = (rng.randn(R, H, 1, DH).astype(np.float32) for _ in range(3))
    pk, pv = (rng.randn(n_pages, H, PL, DH).astype(np.float32)
              for _ in range(2))
    pages = (rng.permutation(n_pages - 1)[:R * MP] + 1 if permute
             else np.arange(1, 1 + R * MP))
    table = pages.reshape(R, MP).astype(np.int32)
    return q, kn, vn, pk, pv, table, np.asarray(pos, np.int32)


CASES = {
    # pos 0, page_len - 1, page_len, the last position, an idle row
    "boundaries": dict(pos=[0, PL - 1, PL, MP * PL - 1, -1]),
    # rows of different ages: row 1 joined this step, row 3 left
    "mid-decode": dict(pos=[7, 0, 15, -1, 11]),
    "permuted": dict(pos=[5, 12, 0, 9, 3], n_pages=3 * R * MP,
                     permute=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_matches_jax_interpret(name):
    q, kn, vn, pk, pv, table, pos = _case(7, **CASES[name])
    jout, jk, jv = jkv.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(table), jnp.asarray(pos),
        interpret=True)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tkv.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(table), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    # the pools are written in place
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_insert_sends_idle_rows_to_the_trash_page():
    """An idle row (pos < 0) writes zeros to page 0 offset 0 and nothing
    else; an active row past its span writes its own last slot."""
    q, kn, vn, pk, pv, table, pos = _case(3, [-1, MP * PL + 5, 2, -1, 0])
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tkv.pool_insert(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                    torch.from_numpy(table), torch.from_numpy(pos))
    assert torch.equal(tk[0, :, 0], torch.zeros(H, DH))
    assert torch.equal(tk[0, :, 1:], torch.from_numpy(pk[0, :, 1:]))
    assert torch.equal(tk[table[1, MP - 1], :, PL - 1],
                       torch.from_numpy(kn[1, :, 0]))
    assert torch.equal(tv[table[2, 0], :, 2], torch.from_numpy(vn[2, :, 0]))
    changed = (tk != torch.from_numpy(pk)).flatten(1).any(1)
    assert set(torch.nonzero(changed)[:, 0].tolist()) <= {
        0, int(table[1, MP - 1]), int(table[2, 0]), int(table[4, 0])}


@pytest.mark.parametrize("pos", [[7, 0, 15, 3, 11], [0, PL - 1, PL, 9, 1]])
def test_paged_plain_bitwise_equals_dense_plain(pos):
    """The same content as a dense [R, H, MP*PL, Dh] cache: the paged
    plain version's output and live cache positions equal the dense plain
    version's bit for bit."""
    q, kn, vn, pk, pv, table, pos = _case(11, pos)
    t = {k: torch.from_numpy(v) for k, v in dict(
        q=q, kn=kn, vn=vn, table=table, pos=pos).items()}
    dense = [torch.from_numpy(p)[t["table"].long()].transpose(1, 2)
             .reshape(R, H, MP * PL, DH) for p in (pk, pv)]
    ro, rk, rv = decode_attention_reference(t["q"], t["kn"], t["vn"],
                                            *dense, t["pos"])
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tkv.paged_decode_attention(t["q"], t["kn"], t["vn"], tk, tv,
                                     t["table"], t["pos"])
    assert torch.equal(out, ro)
    for r in range(R):
        for j in range(pos[r] + 1):
            page, off = table[r, j // PL], j % PL
            assert torch.equal(tk[page, :, off], rk[r, :, j])
            assert torch.equal(tv[page, :, off], rv[r, :, j])


# one operation sequence for both allocators: (verb, owner, argument); an
# argument that is a callable picks pages from the pool being replayed
REPLAY = [
    ("claim", "a", 3), ("claim", "b", 2), ("claim_extra", "a", 1),
    ("share", "c", lambda p: p.pages_of("a")[:2]),
    ("retable", "c", lambda p: p.pages_of("b")[:1] + p.pages_of("a")[:1]),
    ("claim", "c", 1),                    # owner already holds pages
    ("transfer", "b", "d"), ("transfer", "gone", "e"),
    ("release", "a", None), ("release", "a", None),   # double release
    ("claim", "big", 7),                  # past the table row's cap
    ("claim", "f", 6), ("claim", "g", 6),  # exhaustion: all or nothing
    ("claim_extra", "f", 1), ("claim_extra", "nobody", 1),
    ("share", "h", lambda p: [12]),       # a page never claimed
    ("retable", "c", []), ("release", "d", None), ("release", "b", None),
    ("release", "f", None), ("release", "c", None),
]


def _replay(pool, verb, owner, arg):
    if callable(arg):
        arg = arg(pool)
    try:
        if verb == "release":
            got = pool.release(owner)
        elif verb == "transfer":
            got = pool.transfer(owner, arg)
        else:
            got = getattr(pool, verb)(owner, arg)
    except (ValueError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))
    return ("ok", got)


def test_allocator_replay_matches_jax():
    jpool = jkv.KVPool(13, page_len=4, max_pages_per_row=6)
    tpool = tkv.KVPool(13, page_len=4, max_pages_per_row=6)
    raised = set()
    for verb, owner, arg in REPLAY:
        want = _replay(jpool, verb, owner, arg)
        got = _replay(tpool, verb, owner, arg)
        assert got == want, (verb, owner)
        if want[0] == "raised":
            raised.add(want[1])
        assert tpool.claims() == jpool.claims()
        assert tpool.refcounts() == jpool.refcounts()
        assert tpool.stats() == jpool.stats()
        assert tpool.alias_stats() == jpool.alias_stats()
        assert tpool.audit() == jpool.audit() == []
        assert tpool.free_pages() == jpool.free_pages()
    assert raised == {"ValueError", "PoolExhausted"}
    assert tpool.free_pages() == tpool.usable_pages


def test_bucket_tables_match_jax():
    assert tkv.ROW_BUCKETS == jkv.ROW_BUCKETS
    assert tkv.DEFAULT_PAGE_LEN == jkv.DEFAULT_PAGE_LEN
    for n in (0, 1, 3, 9, 64, 65, 1000):
        assert tkv.bucket_rows(n) == jkv.bucket_rows(n)
        assert tkv.pages_for_tokens(n, 16) == jkv.pages_for_tokens(n, 16)
    keys = ["l1_cross_k", "l1_pool_k", "l2_pool_v", "pos", "page_table",
            "lsh_planes"]
    assert tkv.state_key_groups(keys) == jkv.state_key_groups(keys)


@pytest.mark.parametrize("shape,itemsize,aligned,route", [
    # the serve path: R 64, H 8, Dh 64, pages of 16 (32-position chunks)
    ((64, 8, 64, 16, 8), 4, True, (16, 1, 2)),
    # R 8 at the same widths, and the long shape: under 2 blocks an SM
    ((8, 8, 64, 16, 8), 4, True, (16, 1, 4)),
    ((8, 16, 64, 16, 128), 4, True, (16, 1, 4)),
    # bf16 pools: 64-position chunks
    ((64, 8, 64, 16, 8), 2, True, (8, 1, 2)),
    # pages that tile a chunk, and pages that a chunk tiles
    ((64, 8, 64, 8, 16), 4, True, (16, 1, 2)),
    ((64, 8, 64, 32, 4), 4, True, (16, 1, 2)),
    ((64, 8, 64, 64, 2), 4, True, (16, 1, 2)),
    ((64, 8, 256, 16, 8), 4, True, (32, 2, 2)),
    # the scalar kernel: pages of 5 or 24, Dh 36 in bf16 (no whole
    # 16-byte vectors), unaligned pools, Dh past 256
    ((64, 8, 64, 5, 8), 4, True, (0, 0, 0)),
    ((64, 8, 64, 24, 8), 4, True, (0, 0, 0)),
    ((64, 8, 36, 16, 8), 2, True, (0, 0, 0)),
    ((64, 8, 64, 16, 8), 4, False, (0, 0, 0)),
    ((64, 8, 512, 16, 8), 2, True, (0, 0, 0)),
    # Dh 36 in f32 is 9 whole vectors: the vector kernel, 7 lanes idle
    ((64, 8, 36, 16, 8), 4, True, (16, 1, 2)),
])
def test_paged_route(shape, itemsize, aligned, route):
    r, h, dh, page_len, mp = shape
    assert tkv.paged_route(r, h, dh, itemsize, page_len, mp,
                           aligned) == route
