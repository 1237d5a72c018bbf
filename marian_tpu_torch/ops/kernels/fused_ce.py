"""Fused output projection + label-smoothed cross-entropy, the port of
``marian_tpu/ops/pallas/fused_ce.py``.

For hidden states x [N, E], an output table w [V, E] (the tied embedding
orientation; logits = x . w^T + b), a bias b [V] and labels [N], the
per-token stats triple

    lse = logsumexp_v(logits),  lab = logits[label],  tot = sum_v logits

is the autograd boundary, as the reference's custom VJP ``_stats`` is;
``fused_softmax_xent`` composes Marian's smoothed CE from it in plain
torch. The backward forms ``d logits = g_lse * softmax + g_lab * onehot +
g_tot`` tile by tile and never writes [N, V].

On a CUDA tensor the three wrappers launch the hand-written kernels of
``csrc/fused_ce.cu`` (forward, dx, dw/db) or raise; on a CPU tensor they
run their plain versions (``fused_ce_stats_reference``,
``fused_ce_bwd_reference``), which materialise the logits. The kernels
take float32 and any hidden size E, and mask the ragged vocabulary edge
themselves, so the table is never padded. ``.launches`` on each wrapper
counts its calls on the card; the forward's call (and dx's, when its
vocabulary is sliced) is its kernel plus the fixed-order merge of the
slices' partial results.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_SMEM_FLOATS = 232448 // 4            # a Hopper block's shared-memory ceiling
_TILE, _BK = 64, 32                   # csrc/fused_ce.cu kTM = kTN = kEC, kBK
_BWD_FIXED = 2 * _BK * (_TILE + 1) + 2 * _TILE * (_TILE + 1)
_SMS = 132                            # H100 SXM streaming multiprocessors


def accumulator_width(e: int) -> int:
    """Columns of the [64, width] f32 accumulator a dx / dw block keeps
    in shared memory: all of E rounded up to 64 when that fits (up to
    704), else E split into equal 64-aligned ranges, one per z-block of
    the grid (each range recomputes the logits)."""
    cap = (_SMEM_FLOATS - _BWD_FIXED) // _TILE // _TILE * _TILE
    ranges = -(-e // cap)
    return -(-e // (ranges * _TILE)) * _TILE


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _logits(x, w, b):
    return torch.matmul(x.float(), w.float().t()) + b.float()


def fused_ce_stats_reference(x, w, b, labels):
    """(lse, lab, tot), each [N] f32, from materialised logits."""
    logits = _logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse, lab, logits.sum(dim=-1)


def dlogits_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """[N, V] d logits = g_lse * exp(logits - lse) + g_lab * onehot +
    g_tot, from materialised logits."""
    logits = _logits(x, w, b)
    d = g_lse[:, None] * torch.exp(logits - lse[:, None]) + g_tot[:, None]
    return d.scatter_add(1, labels.long()[:, None], g_lab[:, None].float())


def fused_ce_bwd_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """(dx, dw, db) for the stats' cotangents: d . w, d^T . x, sum_n d."""
    d = dlogits_reference(x, w, b, labels, lse, g_lse, g_lab, g_tot)
    dx = torch.matmul(d, w.float())
    dw = torch.matmul(d.t(), x.float())
    return dx.to(x.dtype), dw.to(w.dtype), d.sum(dim=0).to(b.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load("fused_ce"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _operands(name, x, w, b, labels):
    n, e = x.shape
    v = w.shape[0]
    for what, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}; "
                            f"the kernels take float32 on {x.device}")
    if w.shape[1] != e or b.numel() != v or labels.numel() != n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, labels {tuple(labels.shape)}")
    return (x.contiguous(), w.contiguous(), b.reshape(-1).contiguous(),
            labels.to(device=x.device, dtype=torch.int32).contiguous())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _splits(row_tiles: int, vocab_tiles: int, per_sm: int) -> int:
    """Vocabulary slices that give every SM at least ``per_sm`` blocks
    (each slice walks whole vocabulary tiles)."""
    return max(1, min(vocab_tiles, -(-per_sm * _SMS // row_tiles)))


def fused_ce_stats(x, w, b, labels):
    """(lse, lab, tot) [N] f32: the forward kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not x.is_cuda:
        return fused_ce_stats_reference(x, w, b, labels)
    x, w, b, labels = _operands("fused_ce_stats", x, w, b, labels)
    n, e = x.shape
    v = w.shape[0]
    splits = _splits(-(-n // _TILE), -(-v // _TILE), 2)
    out = torch.empty((3, n), dtype=torch.float32, device=x.device)
    part = torch.empty((4, splits, n), dtype=torch.float32, device=x.device)
    err = _fn("fused_ce_fwd", 8, 4)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        part.data_ptr(), n, v, e, splits, _stream(x))
    _build.check(err, "fused_ce_fwd")
    fused_ce_stats.launches += 1
    return out[0], out[1], out[2]


def _bwd_operands(x, grads):
    return [g.to(device=x.device, dtype=torch.float32).contiguous()
            for g in grads]


def fused_ce_dx(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """dx [N, E] = d . w (logits recomputed tile by tile)."""
    if not x.is_cuda:
        return fused_ce_bwd_reference(x, w, b, labels, lse, g_lse, g_lab,
                                      g_tot)[0]
    x, w, b, labels = _operands("fused_ce_dx", x, w, b, labels)
    n, e = x.shape
    lse, g_lse, g_lab, g_tot = _bwd_operands(x, (lse, g_lse, g_lab, g_tot))
    v = w.shape[0]
    # one block per SM at a time (shared memory): at least two blocks per
    # SM keep the last wave from idling much of the card
    splits = _splits(-(-n // _TILE), -(-v // _TILE), 2)
    dx = torch.empty_like(x)
    part = torch.empty((splits, n, e) if splits > 1 else (1,),
                       dtype=torch.float32, device=x.device)
    err = _fn("fused_ce_dx", 10, 5)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g_lse.data_ptr(), g_lab.data_ptr(), g_tot.data_ptr(),
        dx.data_ptr(), part.data_ptr(), n, v, e, splits,
        accumulator_width(e), _stream(x))
    _build.check(err, "fused_ce_dx")
    fused_ce_dx.launches += 1
    return dx


def fused_ce_dw(x, w, b, labels, lse, g_lse, g_lab, g_tot):
    """(dw [V, E] = d^T . x, db [V] = sum_n d)."""
    if not x.is_cuda:
        _, dw, db = fused_ce_bwd_reference(x, w, b, labels, lse, g_lse,
                                           g_lab, g_tot)
        return dw, db
    x, w, b, labels = _operands("fused_ce_dw", x, w, b, labels)
    n, e = x.shape
    lse, g_lse, g_lab, g_tot = _bwd_operands(x, (lse, g_lse, g_lab, g_tot))
    dw = torch.empty_like(w)
    db = torch.empty((w.shape[0],), dtype=torch.float32, device=x.device)
    err = _fn("fused_ce_dw", 10, 4)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g_lse.data_ptr(), g_lab.data_ptr(), g_tot.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, w.shape[0], e, accumulator_width(e),
        _stream(x))
    _build.check(err, "fused_ce_dw")
    fused_ce_dw.launches += 1
    return dw, db


fused_ce_stats.launches = 0
fused_ce_dx.launches = 0
fused_ce_dw.launches = 0


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
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = fused_ce_dx(x, w, b, labels, lse, *grads)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = fused_ce_dw(x, w, b, labels, lse, *grads)
            db = db.reshape(b.shape).to(b.dtype)
        return dx, dw, db, None


def fused_softmax_xent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token label-smoothed CE of logits = x . w^T + b, [N] f32:
        ce = (1-eps) * (lse - lab) + eps * (lse - tot / V)
    (the reference's algebra, ``fused_ce.py :: fused_softmax_xent``).
    On the card the gradient runs through the dx / dw kernels; on the CPU
    it is autograd through the plain forward."""
    v = w.shape[0]
    if x.is_cuda:
        lse, lab, tot = _FusedCEStats.apply(x, w, b, labels)
    else:
        lse, lab, tot = fused_ce_stats_reference(x, w, b, labels)
    eps = float(label_smoothing)
    nll = lse - lab
    if eps > 0.0:
        return (1.0 - eps) * nll + eps * (lse - tot / float(v))
    return nll
