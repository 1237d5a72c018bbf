#!/usr/bin/env python3
"""The flash attention backward kernels (dq, dkv) of two checkouts, side
by side on one card.

Builds ``marian_tpu_torch/csrc/flash_attention.cu`` of this checkout and,
with --parent, of another checkout (for example the parent commit
unpacked with ``git archive``) with ``nvcc -Xptxas -v``, and prints each
backward kernel's registers, shared memory and spills. Then, at the
doc-level training shapes (transformer-big: B 8, H 16, Dh 64, f32, every
key live), it times dq, dkv and the joint backward (delta + dq + dkv) of
each build in turns (parent, change, any --variant, then back in reverse
order; CUDA events behind a device sleep) and holds every other build's
gradients against this checkout's.
Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_flash_bwd_ab.py [--parent DIR]
        [--variant NAME=DIR ...] [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import re
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


def build(trees, flags) -> dict:
    """nvcc of each (tag, tree)'s flash_attention.cu with -Xptxas -v, all
    started together; prints the dq/dkv kernels' resource lines and
    returns {tag: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, tree in trees:
        lib = OUT / f"libflash_{tag}.so"
        src = Path(tree).resolve() / "marian_tpu_torch" / "csrc" / \
            "flash_attention.cu"
        jobs.append((tag, lib, src, subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, lib, src, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry and re.search(r"flash_d(q|kv)_kernel", entry) and (
                    "registers" in line or "spill" in line):
                kind = "dq" if "flash_dq_kernel" in entry else "dkv"
                print(f"ptxas [{tag}] flash_{kind}_kernel "
                      f"{_instance(entry)}: "
                      f"{line.split('ptxas info    :')[-1].strip()}")
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def _instance(entry: str) -> str:
    """dtype and head size of a mangled kernel instance."""
    dtype = "bf16" if "nv_bfloat16" in entry else "f32"
    dh = re.findall(r"Li(\d+)E", entry)
    return f"{dtype} Dh {dh[0] if dh else '?'}"


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def entry_points(lib: ctypes.CDLL):
    def fn(symbol, n_ptr):
        f = getattr(lib, symbol)
        f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        return f
    return fn("flash_attention_dq", 8), fn("flash_attention_dkv", 9)


def backward(fns, ops, grads, shape, joint_out=None):
    """One launch of dq and of dkv (``grads`` = dq, dk, dv); with
    joint_out = (do, out) also delta first, as flash_attention_bwd does."""
    dq_fn, dkv_fn = fns
    b, h, tq, tk, causal = shape
    q, k, v, kvm, do, lse, delta = ops
    if joint_out is not None:
        delta = (joint_out[0] * joint_out[1]).sum(dim=-1)
    s = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, kvm, do, lse, delta)]
    scale = DH ** -0.5
    for err in (dq_fn(*ptrs, grads[0].data_ptr(), b, h, tq, tk, DH, scale,
                      int(causal), 0, s),
                dkv_fn(*ptrs, grads[1].data_ptr(), grads[2].data_ptr(), b, h,
                       tq, tk, DH, scale, int(causal), 0, s)):
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a further checkout (an edited copy) to time")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns over the builds, there and back")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    resolve_device("cuda")
    cs.phase_card()
    flags = list(_build.NVCC_FLAGS)
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    builds = {tag: entry_points(lib)
              for tag, lib in build(trees, flags).items()}
    turns = ["parent"] * (args.parent is not None) + [
        t for t in builds if t != "parent"]
    order = turns + turns[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    for name, b, h, tq, tk, causal in SHAPES:
        q, k, v, do, kvm = cs.flash_inputs(gen, b, h, tq, tk, DH,
                                           live_rows=b)
        kvm.fill_(1.0)
        out, lse = fa.flash_attention_fwd(q, k, v, kvm, causal)
        ops = (q, k, v, kvm, do, lse, (do * out).sum(dim=-1))
        shape = (b, h, tq, tk, causal)
        grads = {}
        for tag, fns in builds.items():
            grads[tag] = tuple(torch.empty_like(t) for t in (q, k, v))
            backward(fns, ops, grads[tag], shape)
        torch.cuda.synchronize()
        for tag in grads:
            for i, part in enumerate(("dq", "dk", "dv")):
                if tag != "change":
                    cs.close_to_scale(grads[tag][i], grads["change"][i],
                                      f"{name} {part}: {tag} against change")
        # pairs of (query, key) the data needs: all, or the causal
        # triangle (keys at or before the query)
        pairs = (b * h * sum(min(i + 1, tk) for i in range(tq)) if causal
                 else b * h * tq * tk)
        flops = {"dq": 6 * pairs * DH, "dkv": 8 * pairs * DH,
                 "joint": 10 * pairs * DH}
        times = {tag: {"dq": [], "dkv": [], "joint": []} for tag in builds}
        for _ in range(args.rounds):
            for tag in order:
                fns, g = builds[tag], grads[tag]
                dq_fn, dkv_fn = fns
                times[tag]["dq"].append(cs.time_ms(
                    lambda: backward((dq_fn, _noop), ops, g, shape), 10))
                times[tag]["dkv"].append(cs.time_ms(
                    lambda: backward((_noop, dkv_fn), ops, g, shape), 10))
                times[tag]["joint"].append(cs.time_ms(
                    lambda: backward(fns, ops, g, shape, (do, out)), 10))
        for tag in builds:
            for part in ("dq", "dkv", "joint"):
                ms = times[tag][part]
                bound_ms = flops[part] / cs.F32_FLOPS * 1e3
                print(f"flash bwd [{name}] B={b} H={h} Tq={tq} Tk={tk} "
                      f"Dh={DH} causal={causal} {tag} {part}: ms "
                      f"{' '.join(f'{t:.4f}' for t in ms)} (best "
                      f"{min(ms):.4f}; {flops[part] / min(ms) / 1e9:.2f} "
                      f"TFLOP/s; bound {bound_ms:.4f} ms, operations)")
        del q, k, v, do, kvm, out, lse, ops, grads
        torch.cuda.empty_cache()
    return 0


def _noop(*args):
    return 0


if __name__ == "__main__":
    sys.exit(main())
