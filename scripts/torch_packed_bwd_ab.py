#!/usr/bin/env python3
"""The packed attention backward of two checkouts, side by side on one
card, in bf16.

Builds ``marian_tpu_torch/csrc/packed_attention.cu`` of this checkout
and, with --parent, of another checkout (for example the parent commit
unpacked with ``git archive``) for bf16 operands (``-DKERNEL_DTYPE=1``)
with ``nvcc -Xptxas -v``, and prints each packed kernel's registers,
shared memory and spills. At the bf16 base update's shapes (B 192, H 8,
T 64, Dh 64, every key live: self, causal, and cross 64 x 48) it holds
each build's dq, dk and dv against the plain backward (max |err| and the
margin of the one-spacing gate, chip_smoke.close_bf16; strict for a
tensor-core build) and times them in turns (parent, change, then back;
CUDA events behind a device sleep): the kernel alone, and with delta =
rowsum(dO * out) (taken in plain torch before a kernel that reads delta,
as the wrapper does; a tensor-core kernel that reads out takes it
itself), beside the bound (bf16 bytes of q, k, v, dO, out, the key mask
and the three gradients at 3.35 TB/s, or operations at the bf16 peak,
the larger) and SDPA's backward on the same operands. A build takes its
tensor-core entry (``packed_attention_bwd_tc``) where it has one, as the
wrapper does at these shapes.

--sass compares the machine code of every kernel of both libraries
(float32 and bfloat16) with the parent's (``cuobjdump -sass``). --profile
runs ``scripts/torch_train_profile.py --precision bfloat16`` (the base
update) in the parent and this checkout in turns (parent, change,
change, parent). Run from the root of a checkout on the machine with the
card:

    python3 scripts/torch_packed_bwd_ab.py [--parent DIR] [--rounds 2]
        [--sass] [--profile]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "packed_bwd_ab"
# (name, B, H, Tq, Tk, causal): the bf16 base update's attentions
SHAPES = (("self", 192, 8, 64, 64, False),
          ("causal", 192, 8, 64, 64, True),
          ("cross", 192, 8, 64, 48, False))
DH = 64


def _source(tree) -> Path:
    return (Path(tree).resolve() / "marian_tpu_torch" / "csrc"
            / "packed_attention.cu")


def build(jobs, flags) -> dict:
    """nvcc of each (tag, tree, kernel dtype)'s packed_attention.cu with
    -Xptxas -v, all started together; prints the bf16 builds' packed
    kernels' resource lines and returns {(tag, dtype): library path}."""
    from marian_tpu_torch.ops.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, tree, dtype in jobs:
        lib = OUT / f"libpacked_{tag}_{dtype}.so"
        procs.append((tag, dtype, lib, subprocess.Popen(
            [_build._nvcc(), *flags, f"-DKERNEL_DTYPE={dtype}", "-Xptxas",
             "-v", "-o", str(lib), str(_source(tree))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, dtype, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} ({dtype}):\n{log}")
        for line in _build.ptxas_usage(log):
            if dtype == 1 and line.startswith("packed_"):
                print(f"ptxas [{tag}, bf16] {line}")
        libs[(tag, dtype)] = lib
    return libs


def backward_entry(lib: ctypes.CDLL):
    """fn(q, k, v, kvm, do, out, delta, dq, dk, dv, b, h, tq, tk, causal)
    of a bf16 library: its tensor-core entry where it has one (which reads
    out), else the one-tile entry ``packed_attention_bwd`` (delta; type
    flag 1, no scratch); with delta None the call takes it first."""
    tc = hasattr(lib, "packed_attention_bwd_tc")
    f = getattr(lib, "packed_attention_bwd_tc" if tc
                else "packed_attention_bwd")
    f.argtypes = [ctypes.c_void_p] * (9 if tc else 10) + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * (
            1 if tc else 2) + [ctypes.c_void_p]
    f.restype = ctypes.c_int

    def run(q, k, v, kvm, do, out, delta, dq, dk, dv, b, h, tq, tk,
            causal):
        if not tc and delta is None:
            delta = (do.float() * out.float()).sum(dim=-1)
        ptrs = [t.data_ptr() for t in (q, k, v, kvm, do, out if tc else delta,
                                       dq, dk, dv)]
        tail = [b, h, tq, tk, DH, DH ** -0.5, int(causal)]
        err = (f(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
               if tc else
               f(*ptrs, None, *tail, 1,
                 torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{f.__name__}: CUDA error {err}")
    run.symbol = "packed_attention_bwd_tc" if tc else "packed_attention_bwd"
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns over the builds, there and back")
    ap.add_argument("--sass", action="store_true",
                    help="compare every kernel's SASS with the parent's")
    ap.add_argument("--profile", action="store_true",
                    help="the bf16 base training profile in turns")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_packed_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import torch_flash_bwd_ab as flab
    import torch_fused_ce_fwd_ab as fab
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    resolve_device("cuda")
    cs.phase_card()
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    jobs = [(tag, tree, 1) for tag, tree in trees]
    if args.sass:
        jobs += [(tag, tree, 0) for tag, tree in trees]
    paths = build(jobs, list(_build.NVCC_FLAGS))
    if args.sass:
        for d in (0, 1):
            print(f"sass, {'bf16' if d else 'f32'} library:")
            fab.compare_sass({tag: paths[(tag, d)] for tag, _ in trees})
    builds = {tag: backward_entry(ctypes.CDLL(str(paths[(tag, 1)])))
              for tag, _ in trees}
    for tag, fn in builds.items():
        print(f"entry [{tag}]: {fn.symbol}")
    order = [t for t in ("parent", "change") if t in builds]
    order = order + order[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    dev, bf = torch.device("cuda"), torch.bfloat16
    for name, b, h, tq, tk, causal in SHAPES:
        q, do = (torch.randn(b, h, tq, DH, generator=gen).to(dev, bf)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tk, DH, generator=gen).to(dev, bf)
                for _ in range(2))
        kvm = torch.ones(b, tk, device=dev)
        out = pa.packed_attention(q, k, v, kvm, causal=causal)
        delta = (do.float() * out.float()).sum(dim=-1)
        ref = pa.packed_attention_bwd_reference(q, k, v, kvm, do, out,
                                                causal)
        shape = (b, h, tq, tk, causal)
        grads = {}
        for tag, fn in builds.items():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            fn(q, k, v, kvm, do, out, delta, dq, dk, dv, *shape)
            again = [torch.empty_like(t) for t in (q, k, v)]
            fn(q, k, v, kvm, do, out, None, *again, *shape)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                          again))
            strict = tag == "change" and fn.symbol.endswith("_tc")
            errs = ", ".join(
                f"{n} {flab.gate(cs, g, r, True, f'{name} {n} [{tag}]', strict)}"
                for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref))
            print(f"packed bwd [{name}] bf16 {tag}: max |err| against the "
                  f"plain version: {errs}; two calls bit-identical: {same}")
            cs.check(same or not strict,
                     f"packed bwd [{name}] [{tag}]: two calls differ")
            grads[tag] = (dq, dk, dv)
        ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
        mask = kvm.bool()[:, None, None, :]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, **({"is_causal": True} if causal
                           else {"attn_mask": mask}))
        lib_ms = cs.time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True))
        times = {(tag, part): [] for tag in builds
                 for part in ("kernel", "with delta")}
        for _ in range(args.rounds):
            for tag in order:
                fn, g = builds[tag], grads[tag]
                for part, d in (("kernel", delta), ("with delta", None)):
                    times[tag, part].append(cs.time_ms(lambda: fn(
                        q, k, v, kvm, do, out, d, *g, *shape)))
        pairs = b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                         else tq * tk)
        bound_ms, bound_by = cs.bound(
            (4 * tq + 4 * tk) * b * h * DH * 2 + b * tk * 4,
            10 * pairs * DH, cs.BF16_FLOPS)
        for (tag, part), ms in times.items():
            print(f"packed bwd [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH} "
                  f"causal={causal} bf16 {tag} {part}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)} (best {min(ms):.4f}; "
                  f"bound {bound_ms:.4f} ms, {bound_by}; library (sdpa "
                  f"backward on bf16) {lib_ms:.4f} ms, "
                  f"{min(ms) / lib_ms:.2f}x)")
        del q, k, v, do, kvm, out, delta, ref, grads, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    if args.profile:
        prof = [("parent", args.parent)] if args.parent is not None else []
        flab.profile_turns(prof + [("change", ROOT), ("change", ROOT)] + prof,
                           "bfloat16", doc=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
