#!/usr/bin/env python3
"""The fused CE forward of two checkouts, side by side on one card.

Builds ``marian_tpu_torch/csrc/fused_ce.cu`` of this checkout and, with
--parent, of another checkout (for example the parent commit unpacked
with ``git archive``), and of any --variant tree (an edited copy: only
its ``marian_tpu_torch/csrc/fused_ce.cu`` is read), with ``nvcc -Xptxas
-v``, and prints the fused CE kernels' registers, shared memory and
spills. Then, at the training shapes (base: N 12,288, E 512; doc-level:
N 16,384 = 8 rows x 2,048, E 1,024; V 32,000, f32), it times the forward
(kernel + merge) and the joint backward (``fused_ce_bwd``: dx, dw, db)
of each build in turns (parent, change, variants, then back in reverse
order; CUDA events behind a device sleep), holds every build's outputs
against this checkout's and checks that two calls of each build are
bit-identical. A checkout whose forward still takes a vocabulary split
count (the 64 x 64 kernel) is called with the split count its wrapper
chose. With --profile it then runs ``scripts/torch_train_profile.py``
(base with --updates 3, then --doc with --updates 2) in the parent and
in this checkout in turns: parent, change, change, parent.
Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_fused_ce_fwd_ab.py [--parent DIR]
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
OUT = ROOT / "build" / "fused_ce_fwd_ab"
VOCAB = 32000
# (name, N, E): base training and the doc-level training's 2,048 bucket
SHAPES = (("base", 12288, 512), ("doc", 8 * 2048, 1024))
SMS = 132
# untraced and traced updates of each profile run: (base, doc)
PROFILE_UPDATES = (3, 2)


def _source(tree) -> Path:
    return Path(tree).resolve() / "marian_tpu_torch" / "csrc" / "fused_ce.cu"


def build(trees, flags) -> dict:
    """nvcc of each (tag, tree)'s fused_ce.cu with -Xptxas -v, all
    started together; prints the fce_* kernels' resource lines and
    returns {tag: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, tree in trees:
        lib = OUT / f"libfused_ce_{tag}.so"
        jobs.append((tag, lib, _source(tree), subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-o", str(lib),
             str(_source(tree))],
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
            kernel = re.search(r"\d(fce_[a-z_]+?_kernel)", entry or "")
            if kernel and ("registers" in line or "spill" in line):
                print(f"ptxas [{tag}] {kernel.group(1)}: "
                      f"{line.split('ptxas info    :')[-1].strip()}")
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"torch_fused_ce_fwd_ab: FAILED: {msg}")


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def entry(lib):
    """The wrapper's ``_fn`` for one library: fn(name, n_ptr, n_int)."""
    def fn(name, n_ptr, n_int):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        return f
    return fn


def forward(lib, takes_splits: bool):
    """fn(x, w, b, labels) -> [3, N] (lse, lab, tot) through the
    library's fused_ce_fwd, scratch allocated as its wrapper does."""
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    f = entry(lib)("fused_ce_fwd", 8, 4)

    def run(x, w, b, labels):
        n, e = x.shape
        v = w.shape[0]
        out = torch.empty((3, n), device=x.device)
        if takes_splits:
            # the 64 x 64 kernel's wrapper: at least 2 blocks an SM
            rows, cols = -(-n // 64), -(-v // 64)
            splits = max(1, min(cols, -(-2 * SMS // rows)))
            part = torch.empty((4, splits, n), device=x.device)
            last = splits
        else:
            part = torch.empty(fce.fwd_part_shape(n, v), device=x.device)
            last = int(e % 4 == 0)
        err = f(*(t.data_ptr() for t in (x, w, b, labels, out[0], out[1],
                                         out[2], part)), n, v, e, last,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def backward(lib):
    """fn(x, w, b, labels, lse, g_lse, g_lab, g_tot) -> (dx, dw, db): this
    checkout's ``fused_ce_bwd`` with its kernels taken from the library
    (the backward's C entry points are the same in every build)."""
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    fn = entry(lib)

    def run(*args):
        saved, fce._fn = fce._fn, fn
        try:
            return fce.fused_ce_bwd(*args)
        finally:
            fce._fn = saved
    return run


def card_state() -> str:
    """The card's SM clock, power draw and temperature now (a card that
    clocks down between turns shows here)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def profile_turns(trees) -> None:
    """scripts/torch_train_profile.py, base then --doc, in each tree in
    the given order; prints each run's update and class lines, and the
    card's clock, power and temperature before and after it."""
    for doc, updates in zip((False, True), PROFILE_UPDATES):
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
        print("torch_fused_ce_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card()
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    libs = build(trees, list(_build.NVCC_FLAGS))
    runs = {tag: (forward(libs[tag], re.search(
        r"fused_ce_fwd\([^)]*int splits", _source(tree).read_text())
        is not None), backward(libs[tag])) for tag, tree in trees}
    turns = ["parent"] * (args.parent is not None) + [
        tag for tag in runs if tag != "parent"]
    order = turns + turns[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    for name, n, e in SHAPES:
        x = torch.randn(n, e, generator=gen).to(dev)
        w = (torch.randn(VOCAB, e, generator=gen) * e ** -0.5).to(dev)
        b = torch.randn(VOCAB, generator=gen).to(dev)
        labels = torch.randint(0, VOCAB, (n,), generator=gen).to(
            dev, torch.int32)
        g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
        lse = runs["change"][0](x, w, b, labels)[0]
        ops = {"fwd": lambda run: run[0](x, w, b, labels),
               "bwd": lambda run: run[1](x, w, b, labels, lse, *g)}
        for part, call in ops.items():
            ref = call(runs["change"])
            for tag, run in runs.items():
                one, two = call(run), call(run)
                check(all(torch.equal(p, q) for p, q in zip(one, two)),
                      f"{name} {part} [{tag}]: two calls differ")
                for i, (a, r) in enumerate(zip(one, ref)):
                    cs.close_to_scale(a, r, f"{name} {part} [{tag}] output "
                                      f"{i} against change")
            del ref, one, two
        torch.cuda.empty_cache()
        flops = {"fwd": 2 * n * VOCAB * e, "bwd": 6 * n * VOCAB * e}
        times = {(tag, part): [] for tag in runs for part in ops}
        print(f"card before the {name} timings: {card_state()}")
        for _ in range(args.rounds):
            for tag in order:
                for part, call in ops.items():
                    times[tag, part].append(cs.time_ms(
                        lambda: call(runs[tag]), 5))
        print(f"card after the {name} timings: {card_state()}")
        for (tag, part), ms in times.items():
            bound_ms = flops[part] / cs.F32_FLOPS * 1e3
            print(f"fused_ce_{part} [{name}] N={n} V={VOCAB} E={e} {tag}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)} (best {min(ms):.4f}; "
                  f"{flops[part] / min(ms) / 1e9:.2f} TFLOP/s; bound "
                  f"{bound_ms:.4f} ms, operations)")
        del x, w, b, labels, g, lse
        torch.cuda.empty_cache()
    if args.profile:
        pair = [t for t in trees if t[0] in ("parent", "change")][::-1]
        profile_turns(pair + pair[::-1])
    return 0

if __name__ == "__main__":
    sys.exit(main())
