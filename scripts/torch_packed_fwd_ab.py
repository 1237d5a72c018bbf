#!/usr/bin/env python3
"""The packed attention forward of two checkouts, side by side on one
card, in bf16.

Builds ``marian_tpu_torch/csrc/packed_attention.cu`` of this checkout
and, with --parent, of another checkout (for example the parent commit
unpacked with ``git archive``) and of each --variant tree (an edited
copy; only its ``marian_tpu_torch/csrc`` is read) for bf16 operands
with ``nvcc -Xptxas -v`` (``torch_packed_bwd_ab.build``, which prints
each packed kernel's registers, shared memory and spills). At the
shapes the bf16 paths give the forward (the base update's B 192, H 8,
T 64: self, causal and cross 64 x 48; the decode encoder's B 64, T 32;
B 48, T 256, four key tiles; Dh 64, every key live) it holds each
build's out against the plain version (max |err|, the margin of the
one-spacing gate, chip_smoke.close_bf16, and the share of out values
that round to another bf16 value; strict for a tensor-core build, which
must also give the same bits twice) and times them in turns (parent,
change, variants, then back; CUDA events behind a device sleep), beside
the bound (bf16 bytes of q, k, v, out and the key mask at 3.35 TB/s, or
operations at the bf16 peak, the larger) and SDPA on the same operands.
A build takes its tensor-core entry (``packed_attention_fwd_tc``) where
it has one, as the wrapper does, else ``packed_attention`` with the
wrapper's query tile.

--sass compares the machine code of every kernel of both libraries
(float32 and bfloat16) with the parent's (``cuobjdump -sass``).
--profile runs ``scripts/torch_train_profile.py --precision bfloat16``
(the base update) in the parent and this checkout in turns (parent,
change, change, parent). --parity runs ``scripts/torch_train_parity.py
--precision bfloat16 --seed 17 19`` in this checkout and prints the
sound port's earlier rows of PERF.md's readings table beside its lines.
Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_packed_fwd_ab.py [--parent DIR]
        [--variant NAME=DIR ...] [--rounds 2] [--sass] [--profile]
        [--parity]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (name, B, H, Tq, Tk, causal): the bf16 paths' packed forwards
SHAPES = (("self", 192, 8, 64, 64, False),
          ("causal", 192, 8, 64, 64, True),
          ("cross", 192, 8, 64, 48, False),
          ("decode encoder", 64, 8, 32, 32, False),
          ("T 256", 48, 8, 256, 256, False))
DH = 64


def forward_entry(lib: ctypes.CDLL):
    """fn(q, k, v, kvm, out, b, h, tq, tk, causal) of a bf16 library: its
    tensor-core entry where it has one, else ``packed_attention`` (type
    flag 1) with the wrapper's query tile."""
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    tc = hasattr(lib, "packed_attention_fwd_tc")
    f = getattr(lib, "packed_attention_fwd_tc" if tc else "packed_attention")
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * (2 if tc else 3) + [
            ctypes.c_void_p]
    f.restype = ctypes.c_int

    def run(q, k, v, kvm, out, b, h, tq, tk, causal):
        ptrs = [t.data_ptr() for t in (q, k, v, kvm, out)]
        tail = [b, h, tq, tk, DH, DH ** -0.5, int(causal)]
        tile = [pa.fwd_query_tile(DH, tq)]
        err = f(*ptrs, *tail, *([] if tc else [1]), *tile,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{f.__name__}: CUDA error {err}")
    run.symbol = f.__name__
    return run


def parity() -> None:
    """The bf16 card-vs-CPU readings of this checkout, then the sound
    port's earlier rows of PERF.md's readings table."""
    run = subprocess.run(
        [sys.executable, "scripts/torch_train_parity.py", "--precision",
         "bfloat16", "--seed", "17", "19"],
        cwd=ROOT, capture_output=True, text=True)
    for line in run.stdout.splitlines():
        print(f"parity {line}")
    if run.returncode != 0:
        raise RuntimeError(f"torch_train_parity failed:\n"
                           f"{run.stderr[-3000:]}")
    perf = ROOT / "PERF.md"
    rows = [line for line in perf.read_text().splitlines()
            if line.startswith("| sound")] if perf.exists() else []
    for row in rows or ["not found"]:
        print(f"parity earlier (PERF.md): {row}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a further tree (an edited copy) to time")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns over the builds, there and back")
    ap.add_argument("--sass", action="store_true",
                    help="compare every kernel's SASS with the parent's")
    ap.add_argument("--profile", action="store_true",
                    help="the bf16 base training profile in turns")
    ap.add_argument("--parity", action="store_true",
                    help="the bf16 card-vs-CPU readings, seeds 17 and 19")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_packed_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import torch_flash_bwd_ab as flab
    import torch_fused_ce_fwd_ab as fab
    import torch_packed_bwd_ab as pbab
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    resolve_device("cuda")
    cs.phase_card()
    pbab.OUT = ROOT / "build" / "packed_fwd_ab"
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    jobs = [(tag, tree, 1) for tag, tree in trees]
    if args.sass:
        jobs += [(tag, tree, 0) for tag, tree in trees]
    paths = pbab.build(jobs, list(_build.NVCC_FLAGS))
    if args.sass:
        for d in (0, 1):
            print(f"sass, {'bf16' if d else 'f32'} library:")
            fab.compare_sass({tag: paths[(tag, d)] for tag, _ in trees})
    builds = {tag: forward_entry(ctypes.CDLL(str(paths[(tag, 1)])))
              for tag, _ in trees}
    for tag, fn in builds.items():
        print(f"entry [{tag}]: {fn.symbol}")
    order = [t for t in ("parent", "change") if t in builds]
    order += [t for t in builds if t not in order]
    order = order + order[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    dev, bf = torch.device("cuda"), torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, b, h, tq, tk, causal in SHAPES:
        q = torch.randn(b, h, tq, DH, generator=gen).to(dev, bf)
        k, v = (torch.randn(b, h, tk, DH, generator=gen).to(dev, bf)
                for _ in range(2))
        kvm = torch.ones(b, tk, device=dev)
        ref = pa.packed_attention_reference(q, k, v, kvm, causal=causal)
        shape = (b, h, tq, tk, causal)
        outs = {}
        for tag, fn in builds.items():
            out, again = torch.empty_like(q), torch.empty_like(q)
            fn(q, k, v, kvm, out, *shape)
            fn(q, k, v, kvm, again, *shape)
            torch.cuda.synchronize()
            same = torch.equal(out, again)
            strict = tag == "change" and fn.symbol.endswith("_tc")
            err = flab.gate(cs, out, ref, True, f"{name} [{tag}]", strict)
            moved = float((out != ref).float().mean())
            print(f"packed fwd [{name}] bf16 {tag}: max |err| against the "
                  f"plain version {err}; {100 * moved:.3f}% of the out "
                  f"values rounded otherwise; two calls bit-identical: "
                  f"{same}")
            cs.check(same or not strict,
                     f"packed fwd [{name}] [{tag}]: two calls differ")
            outs[tag] = out
        mask = kvm.bool()[:, None, None, :]
        lib_ms = cs.time_ms(lambda: sdpa(
            q, k, v, **({"is_causal": True} if causal
                        else {"attn_mask": mask})))
        times = {tag: [] for tag in builds}
        for _ in range(args.rounds):
            for tag in order:
                times[tag].append(cs.time_ms(lambda: builds[tag](
                    q, k, v, kvm, outs[tag], *shape)))
        pairs = b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                         else tq * tk)
        bound_ms, bound_by = cs.bound(
            (2 * tq + 2 * tk) * b * h * DH * 2 + b * tk * 4,
            4 * pairs * DH, cs.BF16_FLOPS)
        for tag, ms in times.items():
            print(f"packed fwd [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH} "
                  f"causal={causal} bf16 {tag}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)} (best {min(ms):.4f}; "
                  f"bound {bound_ms:.4f} ms, {bound_by}, "
                  f"{100 * bound_ms / min(ms):.1f}% of it; library (sdpa "
                  f"on bf16) {lib_ms:.4f} ms, {min(ms) / lib_ms:.2f}x)")
        del q, k, v, kvm, ref, outs
        torch.cuda.empty_cache()
    if args.profile:
        prof = [("parent", args.parent)] if args.parent is not None else []
        flab.profile_turns(prof + [("change", ROOT), ("change", ROOT)] + prof,
                           "bfloat16", doc=False)
    if args.parity:
        parity()
    return 0


if __name__ == "__main__":
    sys.exit(main())
