#!/usr/bin/env python3
"""The fused CE forward of two checkouts, side by side on one card.

Builds ``marian_tpu_torch/csrc/fused_ce.cu`` of this checkout and, with
--parent, of another checkout (for example the parent commit unpacked
with ``git archive``), and of any --variant tree (an edited copy: only
its ``marian_tpu_torch/csrc/fused_ce.cu`` is read), with ``nvcc -Xptxas
-v``, and prints the fused CE kernels' registers, shared memory and
spills. Then, at the training shapes (base: N 12,288, E 512; doc-level:
N 16,384 = 8 rows x 2,048, E 1,024; V 32,000, f32), it times the forward
(kernel + merge) and the joint backward (``fused_ce_bwd``: dx, dw, db;
not for a build whose entry points predate the operand-type flag, nor in
bf16 for one without the tensor-core backward) of
each build in turns (parent, change, variants, then back in reverse
order; CUDA events behind a device sleep), holds every build's outputs
against this checkout's and checks that two calls of each build are
bit-identical. A checkout whose forward still takes a vocabulary split
count (the 64 x 64 kernel) is called with the split count its wrapper
chose. With --profile it then runs ``scripts/torch_train_profile.py``
(base with --updates 3, then --doc with --updates 2) in the parent and
in this checkout in turns: parent, change, change, parent. With
``--dtype bfloat16`` the operands x and w are bf16 (b f32) and only the
builds whose entry points take the operand-type flag are timed; a build
with the tensor-core forward (``fused_ce_fwd_tc``) is timed through it,
as its wrapper routes these shapes, an older one through
``fused_ce_fwd``. With --fwd-group G (repeatable) it also builds edited
copies of this checkout's ``csrc/`` under ``build/fused_ce_fwd_ab/``
whose tensor-core forward walks its blocks in groups of G token tiles
(``kFwdGroup``) and times them as variants ``group_G``. With --sass it
first compares each kernel's machine code (``cuobjdump -sass``, the
addresses left out) in every other build with this checkout's, and
prints which kernels are identical, which differ and which one build
has alone. With
--bwd-turns N each checkout's own ``fused_ce_bwd`` (its wrapper and its
library, whatever its entry points) is timed at both shapes in a process
of its own, in the order parent, change, change, parent, N times, on the
same seeded inputs. Run from the root of a checkout on the machine with
the card:

    python3 scripts/torch_fused_ce_fwd_ab.py [--parent DIR]
        [--variant NAME=DIR ...] [--rounds 2] [--profile]
        [--dtype float32|bfloat16] [--bwd-turns N] [--fwd-group G ...]
        [--sass]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
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
    from marian_tpu_torch.ops.kernels import _build
    libs = {}
    for tag, lib, src, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        for line in _build.ptxas_usage(log):
            if line.startswith("fce_"):
                print(f"ptxas [{tag}] {line}")
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def sass(lib) -> dict:
    """{kernel: its SASS instructions} of a built library, by the mangled
    name with the source's anonymous-namespace tag left out, each
    instruction without its address and encoding."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent
                                            / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs = {}
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = block.split("\n", 1)
        name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "",
                      name.strip())
        funcs[name] = [re.sub(r"/\*[^*]*\*/", "", line).strip()
                       for line in body.splitlines()
                       if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return funcs


def compare_sass(libs) -> None:
    """Each build's kernels against this checkout's (``sass``)."""
    from marian_tpu_torch.ops.kernels import _build
    mine = sass(libs["change"])
    for tag, lib in libs.items():
        if tag == "change":
            continue
        theirs = sass(lib)
        same = sorted(k for k in mine if theirs.get(k) == mine[k])
        differ = sorted(k for k in mine if k in theirs and theirs[k]
                        != mine[k])
        names = (lambda keys: ", ".join(
            f"{_build.kernel_name(k)} ({len(mine.get(k) or theirs[k])} "
            f"instructions)" for k in keys) or "none")
        print(f"sass [{tag} vs change]: identical: {names(same)}; "
              f"differ: {names(differ)}; change alone: "
              f"{names(sorted(set(mine) - set(theirs)))}; {tag} alone: "
              f"{names(sorted(set(theirs) - set(mine)))}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"torch_fused_ce_fwd_ab: FAILED: {msg}")


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def entry(lib):
    """The wrapper's ``_fn`` for one library: fn(name, n_ptr, n_int,
    bf16), ``bf16`` ignored (the library is of one type)."""
    def fn(name, n_ptr, n_int, bf16=False):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        return f
    return fn


def group_variants(groups) -> list:
    """(tag, tree) of edited copies of this checkout's csrc/, one for each
    G in ``groups``, whose tensor-core forward's kFwdGroup is G."""
    trees = []
    for g in groups:
        tree = OUT / f"group_{g}"
        csrc = tree / "marian_tpu_torch" / "csrc"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_source(ROOT).parent, csrc)
        text = (csrc / "fused_ce.cu").read_text()
        new = re.sub(r"constexpr int kFwdGroup = \d+;",
                     f"constexpr int kFwdGroup = {g};", text)
        check(new != text or f"kFwdGroup = {g};" in text,
              "kFwdGroup is not in fused_ce.cu")
        (csrc / "fused_ce.cu").write_text(new)
        trees.append((f"group_{g}", tree))
    return trees


def forward(lib, takes_splits: bool, takes_dtype: bool, tc: bool = False):
    """fn(x, w, b, labels) -> [3, N] (lse, lab, tot) through the
    library's fused_ce_fwd, or with ``tc`` its fused_ce_fwd_tc (the
    tensor-core forward, 128-column tiles), scratch allocated as its
    wrapper does (``takes_dtype``: its entry points take the
    operand-type flag)."""
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    f = (entry(lib)("fused_ce_fwd_tc", 8, 3) if tc
         else entry(lib)("fused_ce_fwd", 8, 4 + takes_dtype))

    def run(x, w, b, labels):
        n, e = x.shape
        v = w.shape[0]
        out = torch.empty((3, n), device=x.device)
        if tc:
            part = torch.empty(fce.fwd_part_shape(n, v, fce.TC_TILE),
                               device=x.device)
            err = f(*(t.data_ptr() for t in (x, w, b, labels, out[0],
                                             out[1], out[2], part)), n, v, e,
                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
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
                *(int(x.dtype == torch.bfloat16),) * takes_dtype,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def backward(lib, takes_dtype: bool, dtype):
    """fn(x, w, b, labels, lse, g_lse, g_lab, g_tot) -> (dx, dw, db): this
    checkout's ``fused_ce_bwd`` with its kernels taken from the library;
    None for a library whose backward entry points predate the
    operand-type flag, or, in bf16, the tensor-core ones (other
    signatures: its forward alone is timed here, its own backward by
    --bwd-turns)."""
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    fn = entry(lib)
    if not takes_dtype or (dtype == torch.bfloat16
                           and not hasattr(lib, "fused_ce_bwd_tc_dx")):
        return None

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


def own_backward(tree: Path, seed: int, dtype) -> None:
    """In this process: ``tree``'s own fused_ce_bwd at both shapes,
    timed, one line each."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    for name, n, e in SHAPES:
        x = torch.randn(n, e, generator=gen).to(dev, dtype)
        w = (torch.randn(VOCAB, e, generator=gen) * e ** -0.5).to(dev, dtype)
        b = torch.randn(VOCAB, generator=gen).to(dev)
        labels = torch.randint(0, VOCAB, (n,), generator=gen).to(dev)
        g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
        lse = fce.fused_ce_stats_reference(x, w, b, labels)[0]
        ms = cs.time_ms(lambda: fce.fused_ce_bwd(x, w, b, labels, lse, *g),
                        5)
        print(f"own backward [{name}]: {ms:.4f} ms")
        del x, w, b, labels, g, lse
        torch.cuda.empty_cache()


def backward_turns(trees, turns: int, seed: int, dtype: str) -> None:
    """--bwd-turns: ``own_backward`` of each (tag, tree) in a process of
    its own, parent then change then back, ``turns`` times; prints each
    time and each side's median."""
    order = trees + trees[::-1]
    got = {}
    for _ in range(turns):
        for tag, tree in order:
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--own-backward", str(Path(tree).resolve()), "--dtype",
                 dtype], cwd=tree, capture_output=True, text=True)
            found = re.findall(r"own backward \[(\w+)\]: ([\d.]+) ms",
                               run.stdout)
            if run.returncode != 0 or len(found) != len(SHAPES):
                raise RuntimeError(f"own backward [{tag}] failed:\n"
                                   f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
            for shape, ms in found:
                got.setdefault((tag, shape), []).append(float(ms))
                print(f"fused_ce_bwd own [{shape}] {dtype} {tag}: {ms} ms "
                      f"(card: {card_state()})")
    for (tag, shape), ms in got.items():
        print(f"fused_ce_bwd own [{shape}] {dtype} {tag}: median "
              f"{statistics.median(ms):.4f} ms over {len(ms)} processes")


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
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--bwd-turns", type=int, default=0, metavar="N",
                    help="time each checkout's own fused_ce_bwd in "
                    "processes of its own, N rounds of turns")
    ap.add_argument("--fwd-group", type=int, action="append", default=[],
                    metavar="G", help="also time this checkout's "
                    "tensor-core forward with kFwdGroup G (repeatable)")
    ap.add_argument("--sass", action="store_true",
                    help="compare the builds' machine code, kernel by "
                    "kernel, with this checkout's")
    ap.add_argument("--own-backward", type=Path, default=None,
                    help=argparse.SUPPRESS)      # one such process
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("torch_fused_ce_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.own_backward is not None:
        own_backward(args.own_backward, args.seed, dtype)
        return 0
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
    trees += group_variants(args.fwd_group)
    # the library of the operands' type (a checkout from before the
    # one-type libraries ignores the define)
    libs = build(trees, list(_build.NVCC_FLAGS)
                 + [f"-DKERNEL_DTYPE={int(dtype == torch.bfloat16)}"])
    if args.sass:
        compare_sass({tag: OUT / f"libfused_ce_{tag}.so" for tag, _ in trees})
    runs = {}
    for tag, tree in trees:
        src = _source(tree).read_text()
        takes_dtype = re.search(r"fused_ce_fwd\([^)]*int bf16", src) \
            is not None
        if dtype != torch.float32 and not takes_dtype:
            print(f"[{tag}] takes float32 operands only: not timed")
            continue
        tc = dtype == torch.bfloat16 and hasattr(libs[tag], "fused_ce_fwd_tc")
        print(f"[{tag}] forward through "
              f"{'fused_ce_fwd_tc' if tc else 'fused_ce_fwd'}")
        runs[tag] = (forward(libs[tag], re.search(
            r"fused_ce_fwd\([^)]*int splits", src) is not None, takes_dtype,
            tc), backward(libs[tag], takes_dtype, dtype))
    turns = ["parent"] * ("parent" in runs) + [
        tag for tag in runs if tag != "parent"]
    order = turns + turns[::-1]
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    for name, n, e in SHAPES:
        x = torch.randn(n, e, generator=gen).to(dev, dtype)
        w = (torch.randn(VOCAB, e, generator=gen) * e ** -0.5).to(dev, dtype)
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
                if run[part == "bwd"] is None:
                    continue
                one, two = call(run), call(run)
                check(all(torch.equal(p, q) for p, q in zip(one, two)),
                      f"{name} {part} [{tag}]: two calls differ")
                for i, (a, r) in enumerate(zip(one, ref)):
                    close = (cs.close_bf16 if r.dtype == torch.bfloat16
                             else cs.close_to_scale)
                    close(a, r, f"{name} {part} [{tag}] output {i} "
                          f"against change")
            del ref, one, two
        torch.cuda.empty_cache()
        flops = {"fwd": 2 * n * VOCAB * e, "bwd": 6 * n * VOCAB * e}
        times = {(tag, part): [] for tag in runs for part in ops
                 if runs[tag][part == "bwd"] is not None}
        print(f"card before the {name} timings: {card_state()}")
        for _ in range(args.rounds):
            for tag in order:
                for part, call in ops.items():
                    if (tag, part) not in times:
                        continue
                    times[tag, part].append(cs.time_ms(
                        lambda: call(runs[tag]), 5))
        print(f"card after the {name} timings: {card_state()}")
        # operations at the card's peak for the operands' type
        peak = cs.BF16_FLOPS if dtype == torch.bfloat16 else cs.F32_FLOPS
        for (tag, part), ms in times.items():
            bound_ms = flops[part] / peak * 1e3
            print(f"fused_ce_{part} [{name}] N={n} V={VOCAB} E={e} "
                  f"{args.dtype} {tag}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)} (best {min(ms):.4f}; "
                  f"{flops[part] / min(ms) / 1e9:.2f} TFLOP/s; operation "
                  f"bound {bound_ms:.4f} ms at {peak / 1e12:.0f} TFLOP/s)")
        del x, w, b, labels, g, lse
        torch.cuda.empty_cache()
    pair = [t for t in trees if t[0] in ("parent", "change")][::-1]
    if args.bwd_turns and args.parent is not None:
        backward_turns(pair, args.bwd_turns, args.seed, args.dtype)
    if args.profile:
        profile_turns(pair + pair[::-1])
    return 0

if __name__ == "__main__":
    sys.exit(main())
