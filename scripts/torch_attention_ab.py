#!/usr/bin/env python3
"""The packed attention backward and the flash attention forward of two
checkouts, side by side on one card.

Builds ``marian_tpu_torch/csrc/packed_attention.cu`` and
``flash_attention.cu`` of this checkout and, with --parent, of another
checkout (for example the parent commit unpacked with ``git archive``),
and of any --variant tree (an edited copy), with ``nvcc -Xptxas -v``,
all at once, and prints the registers, shared memory and spills of the
packed backward's kernels (``packed_attention_bwd_kernel`` and, from
this tree on, ``packed_attention_bwd_tiled_kernel``) and of
``flash_fwd_kernel``. Then it times
each build in turns (parent, change, variants, then back in reverse
order; CUDA events behind a device sleep), with the card's SM clock,
power and temperature before and after each shape, and holds every
build's outputs against this checkout's:

- the packed backward (one kernel launch, delta computed once outside)
  at base training's shapes, B 192, H 8, Dh 64, f32: self T 64, causal
  T 64 and cross 64 x 48;
- the flash forward (out and lse) at the doc-level training shapes,
  transformer-big: B 8, H 16, Dh 64, f32, every key live: encoder self
  T 2,048, decoder causal, cross with Tk 1,536, encoder self at the
  1,024 bucket.

With --profile it then runs ``scripts/torch_train_profile.py`` (base
with --updates 3, then --doc with --updates 2) in the parent and in this
checkout in turns: parent, change, change, parent. Run from the root of
a checkout on the machine with the card:

    python3 scripts/torch_attention_ab.py [--parent DIR]
        [--variant NAME=DIR ...] [--rounds 2] [--profile]
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
OUT = ROOT / "build" / "attention_ab"
DH = 64
# (name, B, H, Tq, Tk, causal): the base update's packed attentions
PACKED_SHAPES = (("self", 192, 8, 64, 64, False),
                 ("causal", 192, 8, 64, 64, True),
                 ("cross", 192, 8, 64, 48, False))
# the doc update's attentions at the 2,048 bucket and the encoder's at
# the 1,024 bucket (scripts/torch_flash_bwd_ab.py's shapes)
FLASH_SHAPES = (("encoder self", 8, 16, 2048, 2048, False),
                ("decoder causal", 8, 16, 2048, 2048, True),
                ("cross", 8, 16, 2048, 1536, False),
                ("encoder self, 1,024 bucket", 8, 16, 1024, 1024, False))
KERNELS = ("packed_attention_bwd_tiled_kernel", "packed_attention_bwd_kernel",
           "flash_fwd_kernel")


def _source(tree, name: str) -> Path:
    return Path(tree).resolve() / "marian_tpu_torch" / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def build(trees, flags) -> dict:
    """nvcc of each (tag, tree)'s two sources with -Xptxas -v, all
    started together; prints the two kernels' resource lines and returns
    {(tag, source name): library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, tree in trees:
        for name in ("packed_attention", "flash_attention"):
            lib = OUT / f"lib{name}_{tag}.so"
            jobs.append((tag, name, lib, subprocess.Popen(
                [_nvcc(), *flags, "-Xptxas", "-v", "-o", str(lib),
                 str(_source(tree, name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            kernel = next((k for k in KERNELS if k in (entry or "")), None)
            if kernel and ("registers" in line or "spill" in line):
                dtype = "bf16" if "nv_bfloat16" in entry else "f32"
                dh = re.findall(r"Li(\d+)E", entry)
                print(f"ptxas [{tag}] {kernel} {dtype} Dh "
                      f"{dh[0] if dh else 'any'}: "
                      f"{line.split('ptxas info    :')[-1].strip()}")
        libs[tag, name] = ctypes.CDLL(str(lib))
    return libs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"torch_attention_ab: FAILED: {msg}")


def card_state() -> str:
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _fn(lib, symbol: str, n_ptr: int):
    f = getattr(lib, symbol)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def packed_backward(lib, tree):
    """fn(q, k, v, kvm, do, delta, causal) -> (dq, dk, dv) through the
    library's packed_attention_bwd; a parent without the dq scratch
    argument is called without it."""
    scratch = re.search(r"void\* dq_sum", _source(
        tree, "packed_attention").read_text()) is not None
    f = _fn(lib, "packed_attention_bwd", 10 if scratch else 9)

    def run(q, k, v, kvm, do, delta, causal):
        b, h, tq, dh = q.shape
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        extra = (None,) if scratch else ()
        err = f(*(t.data_ptr() for t in (q, k, v, kvm, do, delta)),
                *(g.data_ptr() for g in grads), *extra, b, h, tq,
                k.shape[2], dh, dh ** -0.5, int(causal), 0,
                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"packed_attention_bwd launch: CUDA error {err}")
        return grads
    return run


def flash_forward(lib):
    """fn(q, k, v, kvm, causal) -> (out, lse) through the library's
    flash_attention_fwd."""
    f = _fn(lib, "flash_attention_fwd", 6)

    def run(q, k, v, kvm, causal):
        b, h, tq, dh = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, tq), device=q.device)
        err = f(*(t.data_ptr() for t in (q, k, v, kvm, out, lse)), b, h,
                tq, k.shape[2], dh, dh ** -0.5, int(causal), 0,
                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"flash_attention_fwd launch: CUDA error {err}")
        return out, lse
    return run


def live_pairs(b, h, tq, tk, causal) -> int:
    """(query, key) pairs the data needs: all, or the causal triangle."""
    return b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                    else tq * tk)


def compare(cs, name, runs, call, order):
    """Every build's outputs against this checkout's, two calls of each
    bit-identical; then each build's times over ``order``."""
    ref = call(runs["change"])
    for tag, run in runs.items():
        one, two = call(run), call(run)
        check(all(torch.equal(a, b) for a, b in zip(one, two)),
              f"{name} [{tag}]: two calls differ")
        for i, (a, r) in enumerate(zip(one, ref)):
            cs.close_to_scale(a, r, f"{name} [{tag}] output {i} against "
                              f"change")
    del ref, one, two
    times = {tag: [] for tag in runs}
    print(f"card before [{name}]: {card_state()}")
    for tag in order:
        times[tag].append(cs.time_ms(lambda: call(runs[tag]), 10))
    print(f"card after [{name}]: {card_state()}")
    return times


def report(label, times, flops):
    for tag, ms in times.items():
        best = min(ms)
        print(f"{label} {tag}: ms {' '.join(f'{t:.4f}' for t in ms)} "
              f"(best {best:.4f}; {flops / best / 1e9:.2f} TFLOP/s; bound "
              f"{flops / 67e12 * 1e3:.4f} ms, operations)")


def profile_turns(trees) -> None:
    """scripts/torch_train_profile.py, base then --doc, in each tree in
    the given order; prints each run's update and class lines, and the
    card's clock, power and temperature before and after it."""
    for doc, updates in ((False, 3), (True, 2)):
        for tag, tree in trees:
            before = card_state()
            cmd = [sys.executable, "scripts/torch_train_profile.py",
                   "--updates", str(updates), "--top", "0"]
            cmd += ["--doc"] if doc else []
            run = subprocess.run(cmd, cwd=tree, capture_output=True,
                                 text=True)
            what = "doc" if doc else "base"
            if run.returncode != 0:
                raise RuntimeError(f"profile {what} [{tag}] failed:\n"
                                   f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
            print(f"profile {what} [{tag}] card before: {before}; after: "
                  f"{card_state()}")
            for line in run.stdout.splitlines():
                if line.startswith("update:") or line.lstrip().startswith(
                        "class"):
                    print(f"profile {what} [{tag}] {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a further tree (an edited copy) to time")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns over the builds, there and back")
    ap.add_argument("--profile", action="store_true",
                    help="also profile base and doc updates in turns")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels.packed_attention import (
        packed_attention)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card()
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    libs = build(trees, list(_build.NVCC_FLAGS))
    packed = {tag: packed_backward(libs[tag, "packed_attention"], tree)
              for tag, tree in trees}
    flash = {tag: flash_forward(libs[tag, "flash_attention"])
             for tag, _ in trees}
    turns = ["parent"] * (args.parent is not None) + [
        tag for tag, _ in trees if tag != "parent"]
    order = (turns + turns[::-1]) * args.rounds
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    for name, b, h, tq, tk, causal in PACKED_SHAPES:
        q, do = (torch.randn(b, h, tq, DH, generator=gen).to(dev)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tk, DH, generator=gen).to(dev)
                for _ in range(2))
        lens = torch.randint(1, tk + 1, (b,), generator=gen)
        lens[0] = tk
        kvm = (torch.arange(tk)[None, :] < lens[:, None]).float().to(dev)
        out = packed_attention(q, k, v, kvm, causal=causal)
        delta = (do * out).sum(dim=-1)
        times = compare(cs, f"packed bwd {name}", packed,
                        lambda run: run(q, k, v, kvm, do, delta, causal),
                        order)
        report(f"packed bwd [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH}",
               times, 10 * live_pairs(b, h, tq, tk, causal) * DH)
    for name, b, h, tq, tk, causal in FLASH_SHAPES:
        q, k, v, _, kvm = cs.flash_inputs(gen, b, h, tq, tk, DH,
                                          live_rows=b)
        kvm.fill_(1.0)
        times = compare(cs, f"flash fwd {name}", flash,
                        lambda run: run(q, k, v, kvm, causal), order)
        report(f"flash fwd [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH}",
               times, 4 * live_pairs(b, h, tq, tk, causal) * DH)
        del q, k, v, kvm
        torch.cuda.empty_cache()
    if args.profile:
        pair = [t for t in trees if t[0] in ("parent", "change")][::-1]
        profile_turns(pair + pair[::-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
