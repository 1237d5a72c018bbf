"""Fused output projection + label-smoothed cross-entropy, the port of
``marian_tpu/ops/pallas/fused_ce.py``.

For hidden states x [N, E], an output table w [V, E] (the tied embedding
orientation; logits = x . w^T + b), a bias b [V] and labels [N], the
per-token stats triple

    lse = logsumexp_v(logits),  lab = logits[label],  tot = sum_v logits

is the autograd boundary, as the reference's custom VJP ``_stats`` is;
``fused_softmax_xent`` composes Marian's smoothed CE from it in plain
torch. The forward never writes [N, V].

The backward (``fused_ce_bwd``, the reference's ``_bwd_call`` with its
``_dx_kernel`` and ``_dw_kernel``) walks the vocabulary in chunks
[v0, v0 + Vc) in a fixed order (``vocab_chunks``). For each chunk it
recomputes the logits once and forms

    d = g_lse * exp(logits - lse) + g_lab * onehot(label) + g_tot

into one [N, Vc] scratch that every chunk reuses (at most 256 MiB), then
adds d . w_c into dx and writes d^T . x and sum_n d into the chunk's rows
of dw and db. So dx and dw share one logit recompute: three N.V.E
products in all. ``run_chunks`` is that loop; it takes its three
per-chunk operations as arguments, the kernels on the card and
``plain_chunk_ops`` in the CPU tests.

The forward (``fused_ce_stats``, the reference's ``_fwd_call``) forms
the logits in tiles of 128 tokens x 256 vocabulary columns (128 on the
tensor cores), one block each, and reduces each tile to a partial (max,
sum exp(l - max), label logit, sum of l) per token; a second pass adds
the partials up in vocabulary order (``fused_ce_stats_tiled_reference``
is the same algebra in plain torch, at either tile width).

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/fused_ce.cu`` (the forward and its merge; per chunk the d
product, the dx product and the dw/db product) or raise; on a CPU
tensor they run their plain versions (``fused_ce_stats_reference``,
``fused_ce_bwd_reference``), which materialise the logits. The kernels
take x and w in float32 or in bfloat16 (of one type; b stays float32),
any hidden size E, and mask the ragged edges themselves, so the table is
never padded. In bfloat16 they read the operands as bf16 and accumulate
in f32, and, as the reference's backward does, round d to bf16 before
the dx and dw products (``round_d``); dx and dw come out in the
operands' type, lse, lab, tot and db in float32.

The bf16 forward and backward run on the tensor cores where ``tc_path``
allows it (E a multiple of 8, x and w, and dx and dw, 16-byte aligned;
``fwd_route`` names the forward's entry): the forward's tiles are 128
columns wide, and the backward's d scratch is bf16, stored already
rounded (the value both of the reference's products read), so a chunk
is twice as wide, and db is summed from the unrounded d in the d
kernel, per 128-token tile and then across the tiles in order,
compensated (``fused_ce_bwd_tc_reference``, ``tc_chunk_ops``). Other
bf16 shapes take the CUDA-core kernels, which round d as they read it.

``.launches`` on ``fused_ce_stats`` counts its float32 calls on the card,
``.launches_bf16`` its bfloat16 ones on the CUDA-core kernel and
``.launches_bf16_tc`` those on the tensor-core kernel; on ``fused_ce_dx``
and ``fused_ce_dw`` they count the card's backward calls that computed
dx and dw on the CUDA-core kernels (f32, bf16), whichever entry point
made them, and ``.launches_bf16_tc`` those on the tensor-core kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from . import _build

_SMS = 132                            # H100 SXM streaming multiprocessors
SCRATCH_BYTES = 256 * 2 ** 20         # the backward's [N, Vc] d scratch
CHUNK_ALIGN = 128                     # csrc/fused_ce.cu kGM, mma_tiles kBM
_TILE_COLS = 256                      # csrc/fused_ce.cu kGN
TC_TILE = 128                         # csrc/mma_tiles.cuh kBM = kBN
TC_SLOTS = 2 * _SMS                   # mma_tiles.cuh kBlocksPerSM an SM
# csrc/mma_tiles.cuh kSmemBytes: 4 stages of two [128][32 + 8] bf16 tiles
TC_SMEM_BYTES = 4 * 2 * TC_TILE * (32 + 8) * 2
_STATS_INIT = -1e30                   # csrc/fused_ce.cu kStatsInit


def k_splits(tiles: int, depth: int, slots: int = _SMS) -> int:
    """Slices of a backward product's reduction of ``depth`` for
    ``tiles`` output tiles: the count in 1..4 whose blocks leave the
    fewest of the card's ``slots`` block slots (one a streaming
    multiprocessor for the CUDA-core kernels, two for the tensor-core
    ones) idle in the last wave, the fewest slices on a tie, each slice
    at least 256 deep. The slices' partial sums are added in order by a
    second pass."""
    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)
    most = max(1, min(4, depth // 256))
    return max(range(1, most + 1), key=lambda s: (fill(s), -s))


def chunk_splits(n: int, e: int, width: int, tc: bool = False
                 ) -> Tuple[int, int]:
    """``k_splits`` of one vocabulary chunk's dx product (n x e outputs,
    reduction over the chunk) and dw product (width x e outputs,
    reduction over the tokens), for output tiles 128 rows high: 256 wide
    and one block an SM on the CUDA cores, 128 wide and two on the
    tensor cores (``tc``)."""
    e_tiles = -(-e // (TC_TILE if tc else _TILE_COLS))
    slots = TC_SLOTS if tc else _SMS
    return (k_splits(e_tiles * -(-n // CHUNK_ALIGN), width, slots),
            k_splits(e_tiles * -(-width // CHUNK_ALIGN), n, slots))


def vocab_chunks(n: int, v: int, chunk: Optional[int] = None,
                 elem: int = 4) -> List[Tuple[int, int]]:
    """(v0, width) of the backward's vocabulary chunks, in order: they
    cover [0, v) once. The width is ``chunk`` when given (tests force a
    narrow one), else the largest multiple of 128 whose d scratch of
    n x width values of ``elem`` bytes (4: f32; 2: the tensor-core path's
    bf16) fits SCRATCH_BYTES (at least 128); the last chunk takes what is
    left."""
    if chunk is None:
        fit = SCRATCH_BYTES // (elem * max(n, 1))
        chunk = max(CHUNK_ALIGN, fit // CHUNK_ALIGN * CHUNK_ALIGN)
    if chunk < 1:
        raise ValueError(f"vocab_chunks: chunk {chunk} < 1")
    return [(v0, min(chunk, v - v0)) for v0 in range(0, v, chunk)]


def fwd_tiles(v: int, cols: int = _TILE_COLS) -> List[Tuple[int, int]]:
    """(v0, width) of the forward's vocabulary tiles, in the order the
    merge adds their partials: ``cols`` columns each (256 on the CUDA
    cores, TC_TILE on the tensor cores), the last one ragged."""
    return vocab_chunks(0, v, cols)


def fwd_part_shape(n: int, v: int, cols: int = _TILE_COLS
                   ) -> Tuple[int, int, int]:
    """The forward's partial buffer [4, tiles, N] f32: (max, sum-exp,
    label logit, sum) per vocabulary tile of ``cols`` columns and token."""
    return 4, -(-v // cols), n


def run_chunks(chunks, make_d: Callable, add_dx: Optional[Callable] = None,
               put_dw: Optional[Callable] = None) -> None:
    """The backward's loop over vocabulary chunks, in order: per chunk,
    d = make_d(v0, width) once, then add_dx(d, v0, width, first) (first:
    store, later chunks: add) and put_dw(d, v0, width) from that d."""
    for i, (v0, width) in enumerate(chunks):
        d = make_d(v0, width)
        if add_dx is not None:
            add_dx(d, v0, width, i == 0)
        if put_dw is not None:
            put_dw(d, v0, width)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _logits(x, w, b):
    """f32 logits: a product of two bf16 values is exact in f32, so this
    is the kernels' arithmetic for either operand type."""
    return torch.matmul(x.float(), w.float().t()) + b.float()


def round_d(d, dtype):
    """d as the backward's products read it: rounded to the operand
    dtype (the reference's ``d.astype(w.dtype)`` / ``d.astype(x.dtype)``;
    a no-op in float32), in f32."""
    return d.to(dtype).float()


def fused_ce_stats_reference(x, w, b, labels):
    """(lse, lab, tot), each [N] f32, from materialised logits."""
    logits = _logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse, lab, logits.sum(dim=-1)


def fused_ce_stats_tiled_reference(x, w, b, labels, cols: int = _TILE_COLS):
    """(lse, lab, tot) as the forward kernels form them: per vocabulary
    tile of ``cols`` columns (``fwd_tiles``: 256 on the CUDA cores,
    TC_TILE on the tensor cores), each token's partial (tile max m, sum
    exp(l - m), label logit or 0, sum of l), then the tiles merged in
    vocabulary order with the merge pass's algebra."""
    labels = labels.long()
    m = torch.full((x.shape[0],), _STATS_INIT, dtype=torch.float32,
                   device=x.device)
    s, lab, tot = torch.zeros_like(m), torch.zeros_like(m), torch.zeros_like(m)
    for v0, width in fwd_tiles(w.shape[0], cols):
        logits = _logits(x, w[v0:v0 + width], b[v0:v0 + width])
        mt = logits.max(dim=1).values
        st = torch.exp(logits - mt[:, None]).sum(dim=1)
        hit = (labels >= v0) & (labels < v0 + width)
        at = logits.gather(1, (labels - v0).clamp(0, width - 1)[:, None])
        mn = torch.maximum(m, mt)
        s = s * torch.exp(m - mn) + st * torch.exp(mt - mn)
        m = mn
        lab = lab + torch.where(hit, at[:, 0], 0.0)
        tot = tot + logits.sum(dim=1)
    return m + torch.log(torch.where(s == 0, 1.0, s)), lab, tot


def dlogits_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """[N, V] d logits = g_lse * exp(logits - lse) + g_lab * onehot +
    g_tot, from materialised logits."""
    logits = _logits(x, w, b)
    d = g_lse[:, None] * torch.exp(logits - lse[:, None]) + g_tot[:, None]
    return d.scatter_add(1, labels.long()[:, None], g_lab[:, None].float())


def fused_ce_bwd_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """(dx, dw, db) for the stats' cotangents: d . w with d rounded to
    w's dtype, d^T . x with d rounded to x's dtype, sum_n d unrounded;
    dx and dw in the operands' dtypes, db in b's."""
    d = dlogits_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot)
    dx = torch.matmul(round_d(d, w.dtype), w.float())
    dw = torch.matmul(round_d(d, x.dtype).t(), x.float())
    return dx.to(x.dtype), dw.to(w.dtype), d.sum(dim=0).to(b.dtype)


def tile_sums(d, rows: int = TC_TILE):
    """sum_n d as the tensor-core backward takes it: each tile of
    ``rows`` tokens summed on its own, then the tiles added in order,
    compensated (Kahan: ``lost`` carries the low bits each add drops)."""
    parts = [d[t:t + rows].sum(dim=0) for t in range(0, d.shape[0], rows)]
    out, lost = parts[0].clone(), torch.zeros_like(parts[0])
    for p in parts[1:]:
        y = p - lost
        u = out + y
        lost = (u - out) - y
        out = u
    return out


def fused_ce_bwd_tc_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """(dx, dw, db) in the tensor-core backward's order of work: d
    rounded once to x's dtype and stored, dx and dw from that stored d
    (in f32 sums), db from the unrounded d by ``tile_sums``."""
    d = dlogits_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot)
    stored = d.to(x.dtype)
    dx = torch.matmul(stored.float(), w.float())
    dw = torch.matmul(stored.float().t(), x.float())
    return dx.to(x.dtype), dw.to(w.dtype), tile_sums(d).to(b.dtype)


def plain_chunk_ops(x, w, b, labels, lse, g_lse, g_lab, g_tot, dx, dw, db):
    """``run_chunks``'s three operations in plain torch, writing into dx
    [N, E] (float32: the running sum over the chunks), dw [V, E] and db
    [V] (any of them None when not asked for): the loop the card runs,
    with the kernels' arithmetic per chunk."""
    labels = labels.long()
    rows = torch.arange(x.shape[0], device=x.device)

    def make_d(v0, width):
        logits = _logits(x, w[v0:v0 + width], b[v0:v0 + width])
        d = g_lse[:, None] * torch.exp(logits - lse[:, None]) + g_tot[:, None]
        hit = (labels >= v0) & (labels < v0 + width)
        d[rows[hit], labels[hit] - v0] += g_lab[hit]
        return d

    def add_dx(d, v0, width, first):
        part = round_d(d, w.dtype) @ w[v0:v0 + width].float()
        if first:
            dx.copy_(part)
        else:
            dx.add_(part)

    def put_dw(d, v0, width):
        dw[v0:v0 + width] = (round_d(d, x.dtype).t() @ x.float()).to(
            dw.dtype)
        db[v0:v0 + width] = d.sum(dim=0)

    return make_d, add_dx, put_dw


def tc_chunk_ops(x, w, b, labels, lse, g_lse, g_lab, g_tot, dx, dw, db):
    """``run_chunks``'s three operations as the tensor-core kernels order
    them: make_d stores d rounded once to the operands' dtype and, with
    db, sums the unrounded d into db[v0 : v0 + width] by ``tile_sums``;
    add_dx and put_dw read the stored d. dx is the f32 running sum, dw
    in the operands' dtype; db None when dw is not asked for."""
    make, add_dx, _ = plain_chunk_ops(x, w, b, labels, lse, g_lse, g_lab,
                                      g_tot, dx, dw, db)

    def make_d(v0, width):
        d = make(v0, width)
        if db is not None:
            db[v0:v0 + width] = tile_sums(d)
        return d.to(x.dtype)

    def put_dw(d, v0, width):
        dw[v0:v0 + width] = (d.float().t() @ x.float()).to(dw.dtype)

    return make_d, add_dx, put_dw


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fn(name: str, n_ptr: int, n_int: int, bf16: bool = False):
    """C entry ``name`` of the library for the operands' type."""
    fn = getattr(_build.load(_build.typed("fused_ce", bf16)), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _operands(name, x, w, b, labels):
    """The kernels' operands, contiguous, labels int32; raises on what
    they do not take: x and w of one type in ``KERNEL_DTYPES``, b
    float32, all on x's device."""
    n, e = x.shape
    v = w.shape[0]
    for what, t, want in (("x", x, x.dtype), ("w", w, x.dtype),
                          ("b", b, torch.float32)):
        if (t.dtype != want or t.dtype not in KERNEL_DTYPES
                or t.device != x.device):
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}; "
                            f"the kernels take x and w of one type, "
                            f"float32 or bfloat16, and b float32, on "
                            f"{x.device}")
    if w.shape[1] != e or b.numel() != v or labels.numel() != n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, labels {tuple(labels.shape)}")
    return (x.contiguous(), w.contiguous(), b.reshape(-1).contiguous(),
            labels.to(device=x.device, dtype=torch.int32).contiguous())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(fn, bf16: bool, tc: bool = False) -> None:
    if tc:
        fn.launches_bf16_tc += 1
    elif bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def fwd_route(x, w) -> Tuple[str, int]:
    """The forward's C entry for the operands x, w and its vocabulary
    tile width: ``fused_ce_fwd_tc`` (tensor cores, TC_TILE columns) where
    ``tc_path`` allows it, else ``fused_ce_fwd`` (CUDA cores, 256)."""
    if tc_path(x.shape[1], x.dtype, _aligned(x, w)):
        return "fused_ce_fwd_tc", TC_TILE
    return "fused_ce_fwd", _TILE_COLS


def fused_ce_stats(x, w, b, labels):
    """(lse, lab, tot) [N] f32: the forward kernel (``fwd_route``) and
    its merge on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return fused_ce_stats_reference(x, w, b, labels)
    x, w, b, labels = _operands("fused_ce_stats", x, w, b, labels)
    n, e = x.shape
    v = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    entry, cols = fwd_route(x, w)
    tc = cols == TC_TILE
    out = torch.empty((3, n), dtype=torch.float32, device=x.device)
    part = torch.empty(fwd_part_shape(n, v, cols), dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            part.data_ptr())
    if tc:
        err = _fn(entry, 8, 3, True)(*ptrs, n, v, e, _stream(x))
    else:
        err = _fn(entry, 8, 5, bf16)(
            *ptrs, n, v, e, int(e % 4 == 0 and _aligned(x, w)), int(bf16),
            _stream(x))
    _build.check(err, entry)
    _count(fused_ce_stats, bf16, tc)
    return out[0], out[1], out[2]


def _bwd_operands(x, grads):
    return [g.to(device=x.device, dtype=torch.float32).contiguous()
            for g in grads]


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def tc_path(e: int, dtype: torch.dtype, aligned: bool) -> bool:
    """Whether the backward takes the tensor-core kernels: bf16 operands,
    E a multiple of 8 (rows of whole 16-byte vectors) and x, w, dx, dw
    16-byte aligned (``aligned``). Every other bf16 call takes the
    CUDA-core kernels; float32 never takes this path."""
    return dtype == torch.bfloat16 and e % 8 == 0 and aligned


def fused_ce_bwd(x, w, b, labels, lse, g_lse, g_lab, g_tot, need_dx=True,
                 need_dw=True, chunk=None):
    """(dx [N, E], dw [V, E], db [V]) for the stats' cotangents, each
    None when not asked for: on a CUDA tensor the chunk loop over the
    kernels (``chunk`` forces a narrower vocabulary chunk), on a CPU
    tensor the plain version."""
    if not x.is_cuda:
        dx, dw, db = fused_ce_bwd_reference(x, w, b, labels, lse, g_lse,
                                            g_lab, g_tot)
        return (dx if need_dx else None, dw if need_dw else None,
                db if need_dw else None)
    x, w, b, labels = _operands("fused_ce_bwd", x, w, b, labels)
    n, e = x.shape
    v = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    lse, g_lse, g_lab, g_tot = _bwd_operands(x, (lse, g_lse, g_lab, g_tot))
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    db = (torch.empty((v,), dtype=torch.float32, device=x.device)
          if need_dw else None)
    outs = [t for t in (x, w, dx, dw) if t is not None]
    if tc_path(e, x.dtype, _aligned(*outs)):
        return _bwd_tc(x, w, b, labels, lse, g_lse, g_lab, g_tot, dx, dw, db,
                       chunk)
    ops = (_fn("fused_ce_bwd_dlogit", 9, 7, bf16),
           _fn("fused_ce_bwd_dx", 5, 10, bf16),
           _fn("fused_ce_bwd_dw", 5, 8, bf16))
    chunks = vocab_chunks(n, v, chunk)
    # dx's running sum over the chunks: dx itself in float32, an f32
    # buffer that the last chunk turns into the bf16 dx otherwise
    dxf = dx
    if need_dx and bf16 and len(chunks) > 1:
        dxf = torch.empty((n, e), dtype=torch.float32, device=x.device)
    ldd = -(-chunks[0][1] // CHUNK_ALIGN) * CHUNK_ALIGN
    d = torch.empty((n, ldd), dtype=torch.float32, device=x.device)
    # scratch for the reduction slices, reused by every chunk's products
    splits = {width: chunk_splits(n, e, width) for _, width in chunks}
    sizes = [1]
    for width, (sx, sw) in splits.items():
        if need_dx and sx > 1:
            sizes.append(sx * n * e)
        if need_dw and sw > 1:
            sizes.append(sw * width * (e + 1))
    part = torch.empty(max(sizes), dtype=torch.float32, device=x.device)
    vec = int(e % 4 == 0 and _aligned(*outs))
    stream = _stream(x)

    last_v0 = chunks[-1][0]

    def make_d(v0, width):
        _build.check(ops[0](
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g_lse.data_ptr(), g_lab.data_ptr(),
            g_tot.data_ptr(), d.data_ptr(), n, e, v0, width, ldd, vec,
            int(bf16), stream), "fused_ce_bwd_dlogit")
        return d

    def add_dx(d, v0, width, first):
        _build.check(ops[1](
            d.data_ptr(), w.data_ptr(), dxf.data_ptr(), dx.data_ptr(),
            part.data_ptr(), n, e, v0, width, ldd, int(not first),
            int(v0 == last_v0), vec, splits[width][0], int(bf16), stream),
            "fused_ce_bwd_dx")

    def put_dw(d, v0, width):
        _build.check(ops[2](
            d.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), n, e, v0, width, ldd, vec, splits[width][1],
            int(bf16), stream), "fused_ce_bwd_dw")

    run_chunks(chunks, make_d, add_dx if need_dx else None,
               put_dw if need_dw else None)
    if need_dx:
        _count(fused_ce_dx, bf16)
    if need_dw:
        _count(fused_ce_dw, bf16)
    return dx, dw, db


def _bwd_tc(x, w, b, labels, lse, g_lse, g_lab, g_tot, dx, dw, db, chunk):
    """``fused_ce_bwd``'s chunk loop on the tensor-core kernels (bf16,
    ``tc_path``): a bf16 d scratch, stored rounded, with db taken in the
    d kernel's epilogue."""
    n, e = x.shape
    v = w.shape[0]
    ops = (_fn("fused_ce_bwd_tc_dlogit", 11, 5, True),
           _fn("fused_ce_bwd_tc_dx", 5, 8, True),
           _fn("fused_ce_bwd_tc_dw", 4, 6, True))
    chunks = vocab_chunks(n, v, chunk, elem=2)
    dxf = dx
    if dx is not None and len(chunks) > 1:
        dxf = torch.empty((n, e), dtype=torch.float32, device=x.device)
    ldd = -(-chunks[0][1] // CHUNK_ALIGN) * CHUNK_ALIGN
    d = torch.empty((n, ldd), dtype=torch.bfloat16, device=x.device)
    splits = {width: chunk_splits(n, e, width, tc=True)
              for _, width in chunks}
    # scratch of the db tile sums and of the reduction slices, reused by
    # every chunk's launches in turn
    sizes = [1]
    for width, (sx, sw) in splits.items():
        if dx is not None and sx > 1:
            sizes.append(sx * n * e)
        if dw is not None:
            sizes.append(-(-n // TC_TILE) * width)
            if sw > 1:
                sizes.append(sw * width * e)
    part = torch.empty(max(sizes), dtype=torch.float32, device=x.device)
    stream = _stream(x)
    last_v0 = chunks[-1][0]

    def make_d(v0, width):
        _build.check(ops[0](
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g_lse.data_ptr(), g_lab.data_ptr(),
            g_tot.data_ptr(), d.data_ptr(),
            None if db is None else db.data_ptr(), part.data_ptr(), n, e, v0,
            width, ldd, stream), "fused_ce_bwd_tc_dlogit")
        return d

    def add_dx(d, v0, width, first):
        _build.check(ops[1](
            d.data_ptr(), w.data_ptr(), dxf.data_ptr(), dx.data_ptr(),
            part.data_ptr(), n, e, v0, width, ldd, int(not first),
            int(v0 == last_v0), splits[width][0], stream),
            "fused_ce_bwd_tc_dx")

    def put_dw(d, v0, width):
        _build.check(ops[2](
            d.data_ptr(), x.data_ptr(), dw.data_ptr(), part.data_ptr(), n, e,
            v0, width, ldd, splits[width][1], stream), "fused_ce_bwd_tc_dw")

    run_chunks(chunks, make_d, None if dx is None else add_dx,
               None if dw is None else put_dw)
    if dx is not None:
        _count(fused_ce_dx, True, tc=True)
    if dw is not None:
        _count(fused_ce_dw, True, tc=True)
    return dx, dw, db


def fused_ce_dx(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """dx [N, E] = d . w alone (the logits recomputed chunk by chunk)."""
    return fused_ce_bwd(x, w, b, labels, lse, g_lse, g_lab, g_tot,
                        need_dw=False)[0]


def fused_ce_dw(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """(dw [V, E] = d^T . x, db [V] = sum_n d) alone."""
    return fused_ce_bwd(x, w, b, labels, lse, g_lse, g_lab, g_tot,
                        need_dx=False)[1:]


for _wrapper in (fused_ce_stats, fused_ce_dx, fused_ce_dw):
    _wrapper.launches = 0
    _wrapper.launches_bf16 = 0
    _wrapper.launches_bf16_tc = 0


class _FusedCEStats(torch.autograd.Function):
    """The stats triple with the kernels' backward (the reference's
    ``_stats`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        lse, lab, tot = fused_ce_stats(x, w, b, labels)
        ctx.save_for_backward(x, w, b, labels, lse)
        return lse, lab, tot

    @staticmethod
    def backward(ctx, g_lse, g_lab, g_tot):
        x, w, b, labels, lse = ctx.saved_tensors
        grads = [torch.zeros_like(lse) if g is None else g
                 for g in (g_lse, g_lab, g_tot)]
        # one call: the logits are recomputed once for dx and dw
        dx, dw, db = fused_ce_bwd(
            x, w, b, labels, lse, *grads,
            need_dx=ctx.needs_input_grad[0],
            need_dw=ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        if db is not None:
            db = db.reshape(b.shape).to(b.dtype)
        return dx, dw, db, None


def fused_softmax_xent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token label-smoothed CE of logits = x . w^T + b, [N] f32:
        ce = (1-eps) * (lse - lab) + eps * (lse - tot / V)
    (the reference's algebra, ``fused_ce.py :: fused_softmax_xent``).
    The gradient runs through ``fused_ce_bwd``, as the reference's
    custom VJP does: the backward's kernels on the card, its plain
    version (with the same rounding of d) on the CPU. The bias enters
    in f32 whatever its dtype, as the reference casts it (a bf16 bias
    from the compute-dtype parameters is widened exactly)."""
    v = w.shape[0]
    lse, lab, tot = _FusedCEStats.apply(x, w, b.float(), labels)
    eps = float(label_smoothing)
    nll = lse - lab
    if eps > 0.0:
        return (1.0 - eps) * nll + eps * (lse - tot / float(v))
    return nll
