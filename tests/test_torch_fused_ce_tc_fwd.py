"""The fused CE's bf16 forward in the tensor-core kernel's order of work
(``fused_ce_stats_tiled_reference`` at 128-column vocabulary tiles) and
its routing rule (``fwd_route``), on the CPU, against the JAX kernel.

The tensor-core forward reduces each 128-token x 128-column logit tile
to a per-token partial (tile max, sum exp(l - max), label logit, sum of
l) and merges the tiles in vocabulary order, as the CUDA-core forward
does at 256 columns. The JAX side is the reference's public entry in
interpret mode on bf16 x and w (``_jax`` of tests/test_torch_fused_ce.py:
it pads V and N and reaches ``_fwd_call``). Tolerance: 1e-5 of each
output's largest magnitude (f32 sums over V in another order), as
``test_tiled_stats_match_plain_and_jax_kernel`` holds the 256-column
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marian_tpu_torch.ops.kernels import fused_ce as fce
from tests.test_torch_fused_ce import _close_to_scale, _jax
from tests.test_torch_package_rules import _CudaTyped

torch.set_num_threads(2)


def _bf16_inputs(seed, n, v, e):
    """x and w rounded to bf16 (numpy bf16 arrays for JAX, bf16 tensors
    of the same values for the port), f32 b, and labels whose first lie
    on the 128-column tile edges 0, 127, 128, 255 and V - 1."""
    rng = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rng.randn(n, e).astype(np.float32),
                               dtype=jnp.bfloat16))
    w = np.asarray(jnp.asarray((rng.randn(v, e) * 0.3).astype(np.float32),
                               dtype=jnp.bfloat16))
    b = rng.randn(v).astype(np.float32)
    labels = rng.randint(0, v, size=n).astype(np.int32)
    edges = [c for c in (0, 127, 128, 255, v - 1) if c < v]
    labels[:len(edges)] = edges
    tx, tw = (torch.tensor(a.astype(np.float32)).bfloat16() for a in (x, w))
    return x, w, b, labels, tx, tw


@pytest.mark.parametrize("v", [200, 256, 257, 3001])
def test_tc_tiled_stats_match_plain_and_jax_kernel(v):
    """At 128-column tiles on bf16 operands: ragged V (under two tiles,
    two whole tiles, one column in the last, 3,001), N 133 (not a
    multiple of the 128-token tile), labels on the tile edges; against
    ``fused_ce_stats_reference`` and the reference kernel's CE at eps 0
    (lse - lab) and 0.1 (tot too)."""
    n, e = 133, 24
    x, w, b, labels, tx, tw = _bf16_inputs(v + 1, n, v, e)
    assert x.dtype == jnp.bfloat16 and tx.dtype == torch.bfloat16
    tb, tl = torch.tensor(b), torch.as_tensor(labels)
    lse, lab, tot = fce.fused_ce_stats_tiled_reference(tx, tw, tb, tl,
                                                       fce.TC_TILE)
    for got, plain in zip((lse, lab, tot),
                          fce.fused_ce_stats_reference(tx, tw, tb, tl)):
        _close_to_scale(got.numpy(), plain.numpy())
    for eps in (0.0, 0.1):
        ce = (1.0 - eps) * (lse - lab) + eps * (lse - tot / float(v))
        _close_to_scale(ce.numpy(), _jax(x, w, b, labels, eps))


@pytest.mark.parametrize("e,dtype,offset,entry", [
    (512, torch.bfloat16, 0, ("fused_ce_fwd_tc", 128)),
    (1024, torch.bfloat16, 0, ("fused_ce_fwd_tc", 128)),
    (48, torch.bfloat16, 0, ("fused_ce_fwd_tc", 128)),
    (50, torch.bfloat16, 0, ("fused_ce_fwd", 256)),
    (512, torch.bfloat16, 1, ("fused_ce_fwd", 256)),
    (512, torch.float32, 0, ("fused_ce_fwd", 256)),
    (1024, torch.float32, 0, ("fused_ce_fwd", 256))])
def test_fwd_route_follows_tc_path(e, dtype, offset, entry):
    """The forward takes the backward's rule: bf16 with E % 8 == 0 and x,
    w 16-byte aligned takes the tensor-core entry and 128-column tiles;
    E 50, an x that is a view one element into its storage (contiguous,
    not aligned) and float32 take the CUDA-core entry and 256."""
    x = torch.zeros(4 * e + offset, dtype=dtype)[offset:].view(4, e)
    w = torch.zeros(8, e, dtype=dtype)
    assert x.is_contiguous()
    assert fce._aligned(x, w) == (offset == 0)
    assert fce.fwd_route(x, w) == entry
    assert (entry[1] == fce.TC_TILE) == fce.tc_path(e, dtype,
                                                   fce._aligned(x, w))


def test_fwd_counters_exist_per_path():
    """``fused_ce_stats`` counts its card calls per path: f32, bf16 on the
    CUDA cores, bf16 on the tensor cores; a CPU call (the plain version)
    moves none of them."""
    before = (fce.fused_ce_stats.launches, fce.fused_ce_stats.launches_bf16,
              fce.fused_ce_stats.launches_bf16_tc)
    _, _, b, labels, tx, tw = _bf16_inputs(6, 9, 40, 16)
    fce.fused_ce_stats(tx, tw, torch.tensor(b), torch.as_tensor(labels))
    assert (fce.fused_ce_stats.launches, fce.fused_ce_stats.launches_bf16,
            fce.fused_ce_stats.launches_bf16_tc) == before


@pytest.mark.parametrize("e,dtype,offset,path", [
    (512, torch.bfloat16, 0, "launches_bf16_tc"),
    (50, torch.bfloat16, 0, "launches_bf16"),
    (512, torch.bfloat16, 1, "launches_bf16"),
    (512, torch.float32, 0, "launches")])
def test_fused_ce_stats_launches_the_routed_entry(monkeypatch, e, dtype,
                                                  offset, path):
    """``fused_ce_stats`` on (stand-in) CUDA tensors calls the entry
    ``fwd_route`` names with that entry's arguments, once, and counts the
    launch on that path's counter alone: the tensor-core entry (N, V, E,
    the stream) for aligned bf16 at E % 8 == 0, the CUDA-core one (N, V,
    E, vec, the type flag, the stream) otherwise."""
    calls = []

    def fn(name, n_ptr, n_int, bf16=False):
        def launch(*args):
            calls.append((name, n_ptr, n_int, bf16, args))
            return 0
        return launch
    monkeypatch.setattr(fce, "_fn", fn)
    monkeypatch.setattr(fce, "_stream", lambda t: 0)
    for attr in ("launches", "launches_bf16", "launches_bf16_tc"):
        monkeypatch.setattr(fce.fused_ce_stats, attr, 0)
    n, v = 5, 300
    x = torch.zeros(n * e + offset, dtype=dtype)[offset:].view(n, e)
    x = x.as_subclass(_CudaTyped)
    w = torch.zeros(v, e, dtype=dtype).as_subclass(_CudaTyped)
    b = torch.zeros(v).as_subclass(_CudaTyped)
    fce.fused_ce_stats(x, w, b, torch.zeros(n, dtype=torch.long))
    (name, n_ptr, n_int, bf16, args), = calls
    bf = dtype == torch.bfloat16
    if path == "launches_bf16_tc":
        assert (name, n_ptr, n_int) == ("fused_ce_fwd_tc", 8, 3)
        assert args[8:] == (n, v, e, 0)
    else:
        assert (name, n_ptr, n_int, bf16) == ("fused_ce_fwd", 8, 5, bf)
        assert args[8:] == (n, v, e, int(e % 4 == 0 and offset == 0),
                            int(bf), 0)
    assert {a: getattr(fce.fused_ce_stats, a) for a in (
        "launches", "launches_bf16", "launches_bf16_tc")} == {
        a: int(a == path) for a in ("launches", "launches_bf16",
                                    "launches_bf16_tc")}


def test_ptxas_usage_names_the_tensor_core_forward():
    """The build's ``-Xptxas -v`` lines name each kernel by the
    identifier its length prefix covers, whatever digits the source's
    hash puts before it, so the build line shows ``fce_tc_fwd_kernel``'s
    registers and spills."""
    from marian_tpu_torch.ops.kernels import _build
    mangled = ("_ZN40_GLOBAL__N__935e5b86_11_fused_ce_cu_935e5b86"
               "17fce_tc_fwd_kernelEPK13__nv_bfloat16S2_PKfPKiiiiiiiPf")
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\n"
           f"ptxas info    : Function properties for {mangled}\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n"
           f"ptxas info    : Used 128 registers, used 1 barriers\n")
    assert _build.ptxas_usage(log) == [
        "fce_tc_fwd_kernel: Used 128 registers, used 1 barriers; 0 bytes "
        "stack frame, 0 bytes spill stores, 0 bytes spill loads"]
    assert _build.kernel_name("_ZN12_GLOBAL__N_f6277116fce_tc_dx_kernelEv"
                              ) == "fce_tc_dx_kernel"
    assert _build.kernel_name("fce_fwd_combine_kernel") == \
        "fce_fwd_combine_kernel"
