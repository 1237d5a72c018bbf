#!/usr/bin/env python3
"""The flash attention kernels (forward, dq, dkv) of two checkouts, side
by side on one card.

Builds ``marian_tpu_torch/csrc/flash_attention.cu`` of this checkout
and, with --parent, of another checkout (for example the parent commit
unpacked with ``git archive``) for the operand type of --dtype
(``-DKERNEL_DTYPE``) with ``nvcc -Xptxas -v``, and prints each flash
kernel's registers, shared memory and spills. With --design NAME it also
builds edited copies of this checkout's source (DESIGNS: the bf16
tensor-core kernels with P and dS rounded to bf16 once, or with the
tensor cores summing straight into the accumulators; the forward at Dh
64 two blocks an SM, with 64- or 32-key tiles). Then, at the
doc-level training shapes (transformer-big: B 8, H 16, Dh 64, every key
live), it holds each build's forward, dq and dkv against the plain
versions (max |err|, and in bf16 the margin of the one-spacing gate,
chip_smoke.close_bf16) and times them and the joint backward (delta + dq
+ dkv) in turns (parent, change, any variant, then back in reverse
order; CUDA events behind a device sleep). A bf16 build takes its
tensor-core entries (``flash_attention_fwd_tc``, ``_dq_tc``,
``_dkv_tc``) where it has them, as the wrapper does for aligned operands
at Dh 64.

--sass compares the machine code of every kernel of both libraries
(float32 and bfloat16) with the parent's (``cuobjdump -sass``). --profile
runs ``scripts/torch_train_profile.py --doc --precision <dtype>`` in the
parent and this checkout in turns (parent, change, change, parent).
Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_flash_bwd_ab.py [--parent DIR] [--dtype bfloat16]
        [--variant NAME=DIR ...] [--design NAME ...] [--rounds 2] [--sass]
        [--profile]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_bwd_ab"
# (name, B, H, Tq, Tk, causal): the doc update's attentions at the 2,048
# bucket and the encoder's at the 1,024 bucket
SHAPES = (("encoder self", 8, 16, 2048, 2048, False),
          ("decoder causal", 8, 16, 2048, 2048, True),
          ("cross", 8, 16, 2048, 1536, False),
          ("encoder self, 1,024 bucket", 8, 16, 1024, 1024, False))
DH = 64
# edited copies of this checkout's flash_attention.cu: (text, replacement)
_TWO_BLOCKS = ("kFwdBlocks = DH <= 32 ? 2 : 1;",
               "kFwdBlocks = DH <= 64 ? 2 : 1;")
DESIGNS = {
    "single_rounded": [("constexpr bool kTcSplit = true;",
                        "constexpr bool kTcSplit = false;")],
    "one_level": [("constexpr bool kTcTwoLevel = true;",
                   "constexpr bool kTcTwoLevel = false;")],
    # the forward at Dh 64 two blocks an SM (128 registers: it spills),
    # and so with 32-key tiles
    "fwd_two_blocks": [_TWO_BLOCKS],
    "fwd_keys32": [_TWO_BLOCKS, ("static constexpr int kKeys = 64;",
                                 "static constexpr int kKeys = 32;")],
}
PARTS = ("fwd", "dq", "dkv", "joint")
# operations each part needs, in units of B.H.(live pairs).Dh
WORK = {"fwd": 4, "dq": 6, "dkv": 8, "joint": 10}


def _source(tree) -> Path:
    return (Path(tree).resolve() / "marian_tpu_torch" / "csrc"
            / "flash_attention.cu")


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def design_trees(names) -> list:
    """(tag, tree) of edited copies of this checkout's csrc/, one per
    DESIGNS name (each edit made in the source or header that holds
    it)."""
    trees = []
    for name in names:
        tree = OUT / f"design_{name}"
        csrc = tree / "marian_tpu_torch" / "csrc"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_source(ROOT).parent, csrc)
        for old, new in DESIGNS[name]:
            files = [f for f in ("flash_attention.cu", "attention_mma.cuh")
                     if old in (csrc / f).read_text()]
            if not files:
                raise SystemExit(f"torch_flash_bwd_ab: {old!r} is not in "
                                 f"the flash sources")
            text = (csrc / files[0]).read_text()
            (csrc / files[0]).write_text(text.replace(old, new))
        trees.append((name, tree))
    return trees


def build(jobs, flags) -> dict:
    """nvcc of each (tag, tree, kernel dtype)'s flash_attention.cu with
    -Xptxas -v, all started together; prints the flash kernels' resource
    lines of the --dtype builds and returns {(tag, dtype): library path}."""
    from marian_tpu_torch.ops.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, tree, dtype in jobs:
        lib = OUT / f"libflash_{tag}_{dtype}.so"
        procs.append((tag, dtype, lib, subprocess.Popen(
            [_nvcc(), *flags, f"-DKERNEL_DTYPE={dtype}", "-Xptxas", "-v",
             "-o", str(lib), str(_source(tree))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, dtype, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} ({dtype}):\n{log}")
        for line in _build.ptxas_usage(log):
            if line.startswith("flash_"):
                print(f"ptxas [{tag}, {'bf16' if dtype else 'f32'}] {line}")
        libs[(tag, dtype)] = lib
    return libs


def entry_points(lib: ctypes.CDLL, bf16: bool) -> dict:
    """{part: fn(operands, outs, b, h, tq, tk, causal)} of one library:
    the tensor-core forward, dq and dkv where a bf16 library has them."""
    def fn(symbol, n_ptr, flag):
        f = getattr(lib, symbol)
        f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int] + [ctypes.c_int] * (
                flag is not None) + [ctypes.c_void_p]
        f.restype = ctypes.c_int

        def run(ops, outs, b, h, tq, tk, causal):
            s = torch.cuda.current_stream().cuda_stream
            args = [t.data_ptr() for t in (*ops, *outs)] + [
                b, h, tq, tk, DH, DH ** -0.5, int(causal)]
            err = f(*args, *([] if flag is None else [flag]), s)
            if err:
                raise RuntimeError(f"{symbol}: CUDA error {err}")
        run.symbol = symbol
        return run
    flag = int(bf16)
    tc = bf16 and hasattr(lib, "flash_attention_fwd_tc")
    dq_tc = bf16 and hasattr(lib, "flash_attention_dq_tc")
    return {"fwd": (fn("flash_attention_fwd_tc", 6, None) if tc
                    else fn("flash_attention_fwd", 6, flag)),
            "dq": (fn("flash_attention_dq_tc", 8, None) if dq_tc
                   else fn("flash_attention_dq", 8, flag)),
            "dkv": (fn("flash_attention_dkv_tc", 9, None) if tc
                    else fn("flash_attention_dkv", 9, flag))}


def gate(cs, got, ref, bf16: bool, what: str, strict: bool) -> str:
    """max |got - ref| and, in bf16, how far past one bf16 spacing it
    goes over the REL_TOL x scale allowance (chip_smoke.close_bf16's
    gate; <= 1 passes). ``strict``: fail past the gate."""
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    scale = max(float(r.abs().max()), 1.0)
    if bf16:
        over = float(((g - r).abs() - cs.BF16_SPACING * r.abs()).max())
        margin = over / (cs.REL_TOL * scale)
        if strict:
            cs.close_bf16(got, ref, what)
        return f"{err:.3g} (gate {margin:.3g})"
    if strict:
        cs.close_to_scale(got, ref, what)
    return f"{err:.3g} (of scale {err / scale:.3g})"


def profile_turns(trees, precision: str, doc: bool = True) -> None:
    """scripts/torch_train_profile.py (--doc, 2 updates; else the base
    update, 3) in each (tag, tree) in order; prints each run's update and
    class lines and the card's clock, power and temperature before and
    after it."""
    import torch_fused_ce_fwd_ab as fab
    what = "doc" if doc else "base"
    for tag, tree in trees:
        before = fab.card_state()
        run = subprocess.run(
            [sys.executable, "scripts/torch_train_profile.py",
             *(["--doc"] if doc else []), "--precision", precision,
             "--updates", "2" if doc else "3", "--top", "0"],
            cwd=tree, capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"profile [{tag}] failed:\n"
                               f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
        print(f"profile {what} {precision} [{tag}] card before: {before}; "
              f"after: {fab.card_state()}")
        for line in run.stdout.splitlines():
            if line.startswith("update:") or line.lstrip().startswith(
                    "class"):
                print(f"profile {what} {precision} [{tag}] {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a further checkout (an edited copy) to time")
    ap.add_argument("--design", action="append", default=[],
                    choices=sorted(DESIGNS),
                    help="an edited copy of this checkout's source to time")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns over the builds, there and back")
    ap.add_argument("--sass", action="store_true",
                    help="compare every kernel's SASS with the parent's")
    ap.add_argument("--profile", action="store_true",
                    help="the doc-level training profile in turns")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    import torch_fused_ce_fwd_ab as fab
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    resolve_device("cuda")
    cs.phase_card()
    bf16 = args.dtype == "bfloat16"
    dt = int(bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    trees += design_trees(args.design)
    jobs = [(tag, tree, dt) for tag, tree in trees]
    if args.sass:
        jobs += [(tag, tree, 1 - dt) for tag, tree in trees
                 if tag in ("change", "parent")]
    paths = build(jobs, list(_build.NVCC_FLAGS))
    if args.sass:
        for d in (0, 1):
            print(f"sass, {'bf16' if d else 'f32'} library:")
            fab.compare_sass({tag: paths[(tag, d)]
                              for tag in ("change", "parent")
                              if (tag, d) in paths})
    builds = {tag: entry_points(ctypes.CDLL(str(paths[(tag, dt)])), bf16)
              for tag, _ in trees}
    for tag, fns in builds.items():
        print(f"entries [{tag}]: " + ", ".join(
            f"{p} {fn.symbol}" for p, fn in fns.items()))
    turns = ["parent"] * (args.parent is not None) + [
        t for t in builds if t != "parent"]
    order = turns + turns[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    for name, b, h, tq, tk, causal in SHAPES:
        q, k, v, do, kvm = cs.flash_inputs(gen, b, h, tq, tk, DH, dtype,
                                           live_rows=b)
        kvm.fill_(1.0)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, kvm, causal)
        # every build's backward reads the plain forward's out and lse
        delta = (do.float() * ref.float()).sum(dim=-1)
        ops = (q, k, v, kvm, do, ref_lse, delta)
        rdq, rdk, rdv = fa.flash_attention_bwd_reference(
            q, k, v, kvm, do, ref, ref_lse, causal)
        shape = (b, h, tq, tk, causal)
        outs = {}
        for tag, fns in builds.items():
            out, lse = torch.empty_like(q), torch.empty_like(ref_lse)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            fns["fwd"]((q, k, v, kvm), (out, lse), *shape)
            fns["dq"](ops, (dq,), *shape)
            fns["dkv"](ops, (dk, dv), *shape)
            torch.cuda.synchronize()
            strict = tag in ("change", "parent") and bf16
            errs = {"out": gate(cs, out, ref, bf16, f"{name} out [{tag}]",
                                strict and tag == "change"),
                    "lse": f"{float((lse - ref_lse).abs().max()):.3g}",
                    "dq": gate(cs, dq, rdq, bf16, f"{name} dq [{tag}]",
                               strict and tag == "change"
                               and fns["dq"].symbol.endswith("_tc")),
                    "dk": gate(cs, dk, rdk, bf16, f"{name} dk [{tag}]",
                               strict and tag == "change"),
                    "dv": gate(cs, dv, rdv, bf16, f"{name} dv [{tag}]",
                               strict and tag == "change")}
            print(f"flash [{name}] {args.dtype} {tag}: max |err| against "
                  f"the plain versions: " + ", ".join(
                      f"{p} {e}" for p, e in errs.items()))
            outs[tag] = (out, lse, dq, dk, dv)
        # pairs of (query, key) the data needs: all, or the causal
        # triangle (keys at or before the query)
        pairs = (b * h * sum(min(i + 1, tk) for i in range(tq)) if causal
                 else b * h * tq * tk)
        times = {tag: {p: [] for p in PARTS} for tag in builds}
        for _ in range(args.rounds):
            for tag in order:
                fns = builds[tag]
                out, lse, dq, dk, dv = outs[tag]

                def joint():
                    d = (do.float() * ref.float()).sum(dim=-1)
                    o = (q, k, v, kvm, do, ref_lse, d)
                    fns["dq"](o, (dq,), *shape)
                    fns["dkv"](o, (dk, dv), *shape)
                runs = {"fwd": lambda: fns["fwd"]((q, k, v, kvm),
                                                  (out, lse), *shape),
                        "dq": lambda: fns["dq"](ops, (dq,), *shape),
                        "dkv": lambda: fns["dkv"](ops, (dk, dv), *shape),
                        "joint": joint}
                for part in PARTS:
                    times[tag][part].append(cs.time_ms(runs[part], 10))
        peak = cs.BF16_FLOPS if bf16 else cs.F32_FLOPS
        for tag in builds:
            for part in PARTS:
                ms = times[tag][part]
                flops = WORK[part] * pairs * DH
                print(f"flash [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH} "
                      f"causal={causal} {args.dtype} {tag} {part}: ms "
                      f"{' '.join(f'{t:.4f}' for t in ms)} (best "
                      f"{min(ms):.4f}; {flops / min(ms) / 1e9:.2f} TFLOP/s; "
                      f"bound {flops / peak * 1e3:.4f} ms, operations)")
        del q, k, v, do, kvm, ref, ref_lse, delta, ops, rdq, rdk, rdv, outs
        torch.cuda.empty_cache()
    if args.profile:
        prof = [("parent", args.parent)] if args.parent is not None else []
        profile_turns(prof + [("change", ROOT), ("change", ROOT)] + prof,
                      args.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
