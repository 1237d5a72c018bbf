#!/usr/bin/env python3
"""decode_attention, the paged decode read and the packed attention
forward of two checkouts, side by side on one card.

Builds ``marian_tpu_torch/csrc/decode_attention.cu``,
``paged_decode_attention.cu`` and ``packed_attention.cu`` of this
checkout and, with --parent, of another checkout (for example the parent
commit unpacked with ``git archive``), and of any --variant tree (an
edited copy), with ``nvcc -Xptxas -v``, all at once, and prints the
registers, shared memory and spills of the f32 kernels of the three
functions (``decode_attention_kernel``, and from this tree on
``decode_attention_scalar_kernel``; ``paged_decode_attention_kernel``,
and from this tree on ``paged_decode_attention_scalar_kernel``; the
forward's ``packed_attention_kernel``, from this tree on
``packed_attention_fwd_kernel`` and ``packed_attention_generic_kernel``).
Then it times each build in turns (parent, change, variants, then back
in reverse order; CUDA events behind a device sleep), with the card's SM
clock, power and temperature before and after each shape, holds every
build's outputs against this checkout's (new caches equal, contexts
within 1e-5 of scale) and two calls of each build bit-identical:

- decode_attention, f32 caches, Dh 64, beam rows from 6 candidates, pos
  at the cache's end: base decode (R 384, H 8, L 64), doc decode (R 48,
  H 16, L 1,024), the doc decode halfway (pos 511), and base decode of
  8 sentences at a cache of 128 (R 48, H 8, L 128), the fewest (row,
  head) pairs the batcher sends;
- the paged decode read, Dh 64, pools and table as ``chip_smoke.py``'s
  ``paged_case`` makes them (positions over [-1, span - 1], the first
  rows pinned at -1, 0, 15, 16 and the span's end): the serve path's
  R 64, H 8, pages of 16, MP 8 in f32 and in bf16 (q and pools), R 8 at
  the same widths (a serve round of 8 sentences) and the long shape
  R 8, H 16, MP 128 (2,048 positions). This checkout runs its launcher's
  route, and beside it (as ``change-2``, ``change-4``) the vector kernel
  forced to 2 and to 4 chunk buffers. Each build is timed warm (the
  calls back to back, the pools in L2 where they fit) and cold (a
  128 MB write before each call evicts them, as the serve step's other
  layers do);
- the packed forward, f32, Dh 64, every key live: the decode encoder's
  B 64, H 8, T 32, and base training's B 192, H 8: self T 64, causal
  T 64, cross 64 x 48.

Each time stands beside its bound (bytes at 3.35 TB/s or flops at 67
TFLOP/s, the larger) and, for the packed forward and the paged read,
the library's time on the same inputs (SDPA; for the paged read the
``pool[page_table]`` gather, then SDPA). With --profile it then runs
``scripts/torch_decode_profile.py --doc`` and
``scripts/torch_train_profile.py`` (base, --updates 3) in the parent and
in this checkout in turns: parent, change, change, parent; with
--serve-profile, ``scripts/torch_serve_profile.py`` the same way. Run
from the root of a checkout on the machine with the card:

    python3 scripts/torch_attention_ab.py [--parent DIR]
        [--variant NAME=DIR ...] [--rounds 2] [--profile]
        [--serve-profile] [--only paged]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_ab"
DH = 64
BEAM = 6
# (name, R, H, L, pos): the decode steps' cached self-attention
DECODE_SHAPES = (("base decode", 384, 8, 64, 63),
                 ("doc decode", 48, 16, 1024, 1023),
                 ("doc decode, halfway", 48, 16, 1024, 511),
                 ("base decode, 8 sentences", 48, 8, 128, 127))
# (name, B, H, Tq, Tk, causal): the decode encoder, the base update's
PACKED_SHAPES = (("decode encoder", 64, 8, 32, 32, False),
                 ("training self", 192, 8, 64, 64, False),
                 ("training causal", 192, 8, 64, 64, True),
                 ("training cross", 192, 8, 64, 48, False))
# (name, R, H, page, MP, pins, dtype): the serve step's paged read
PAGED_PINS = [-1, 0, 15, 16]
PAGED_SHAPES = (("serve", 64, 8, 16, 8, PAGED_PINS + [127], torch.float32),
                ("serve, 8 rows", 8, 8, 16, 8, PAGED_PINS + [127],
                 torch.float32),
                ("long", 8, 16, 16, 128, PAGED_PINS + [2047],
                 torch.float32),
                ("serve, bf16", 64, 8, 16, 8, PAGED_PINS + [127],
                 torch.bfloat16))
SOURCES = ("decode_attention", "paged_decode_attention", "packed_attention")
# the paged names first: a kernel takes the first name it contains
KERNELS = ("paged_decode_attention_scalar_kernel",
           "paged_decode_attention_kernel",
           "decode_attention_scalar_kernel", "decode_attention_kernel",
           "packed_attention_fwd_kernel", "packed_attention_generic_kernel",
           "packed_attention_kernel")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _source(tree, name: str) -> Path:
    return Path(tree).resolve() / "marian_tpu_torch" / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from marian_tpu_torch.ops.kernels import _build
    return _build._nvcc()


def build(trees, flags) -> dict:
    """nvcc of each (tag, tree)'s two sources with -Xptxas -v, all
    started together; prints the f32 kernels' resource lines and returns
    {(tag, source name): library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, tree in trees:
        for name in SOURCES:
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
            if not kernel or "nv_bfloat16" in entry:
                continue
            if "registers" in line or "spill" in line:
                args = re.findall(r"Li(\d+)E", entry)
                print(f"ptxas [{tag}] {kernel} f32 "
                      f"{'<' + ','.join(args) + '>' if args else ''}: "
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


def decode_call(lib, tree):
    """fn(q, kn, vn, ck, cv, pos, src) -> (out, new_k, new_v) through the
    library's decode_attention: a tree whose entry takes the layout (the
    vector kernel) gets this checkout's layout rule, a former one its own
    signature."""
    laid = "int per_lane" in _source(tree, "decode_attention").read_text()
    f = lib.decode_attention
    f.restype = ctypes.c_int
    if laid:
        from marian_tpu_torch.ops.kernels import decode_attention as da
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def run(q, kn, vn, ck, cv, pos, src):
        r, h, L, dh = ck.shape
        out, nk, nv = (torch.empty_like(t) for t in (q, ck, cv))
        ptrs = [t.data_ptr() for t in (q, kn, vn, ck, cv, pos, src, out, nk,
                                       nv)]
        stream = torch.cuda.current_stream().cuda_stream
        if laid:
            lanes, per_lane, _ = da.vector_layout(dh, 4)
            err = f(*ptrs, r, h, L, dh, dh ** -0.5, 0, 0, lanes, per_lane,
                    stream)
        else:
            err = f(*ptrs, r, h, L, dh, dh ** -0.5, 0, 0, stream)
        check(err == 0, f"decode_attention launch: CUDA error {err}")
        return out, nk, nv
    return run


def paged_call(lib, tree, stages=None):
    """fn(q, pk, pv, table, pos) -> out through the library's
    paged_decode_attention: a tree whose entry takes the route gets this
    checkout's ``paged_route`` (the vector kernel with ``stages`` chunk
    buffers where given), a former one its own signature."""
    routed = "int stages" in _source(tree, "paged_decode_attention") \
        .read_text()
    f = lib.paged_decode_attention
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * (5 if routed else 2) + [
        ctypes.c_void_p]

    def run(q, pk, pv, table, pos):
        from marian_tpu_torch.ops.kernels import kv_pool as kv
        r, h, _, dh = q.shape
        page_len, mp = pk.shape[2], table.shape[1]
        out = torch.empty_like(q)
        route = ()
        if routed:
            route = kv.paged_route(r, h, dh, pk.element_size(), page_len, mp,
                                   sms=kv._sms(torch.cuda.current_device()))
            if stages:
                check(route[0] > 0, "a forced stage count needs the vector "
                      "kernel's route")
                route = route[:2] + (stages,)
        err = f(*(t.data_ptr() for t in (q, pk, pv, table, pos, out)), r, h,
                page_len, dh, mp, dh ** -0.5, _DTYPE_CODES[q.dtype],
                _DTYPE_CODES[pk.dtype], *route,
                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"paged_decode_attention launch: CUDA error {err}")
        return out
    return run


def cold_ms(fn, iters: int = 20) -> float:
    """Device time of one call with a cold L2: a 128 MB write before each
    call, events around the call alone."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def packed_call(lib, tree):
    """fn(q, k, v, kvm, causal) -> out through the library's
    packed_attention: a tree whose entry takes the query tile gets this
    checkout's rule for it, a former one its own signature."""
    tiled = "int tile" in _source(tree, "packed_attention").read_text()
    f = lib.packed_attention
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * (3 if tiled else 2) + [
        ctypes.c_void_p]

    def run(q, k, v, kvm, causal):
        from marian_tpu_torch.ops.kernels.packed_attention import (
            fwd_query_tile)
        b, h, tq, dh = q.shape
        out = torch.empty_like(q)
        route = (fwd_query_tile(dh, tq),) if tiled else ()
        err = f(*(t.data_ptr() for t in (q, k, v, kvm, out)), b, h, tq,
                k.shape[2], dh, dh ** -0.5, int(causal), 0, *route,
                torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"packed_attention launch: CUDA error {err}")
        return out
    return run


def compare(cs, name, runs, call, order, exact=(), timer=None, rel=None):
    """Every build's outputs against this checkout's (those at ``exact``
    positions equal, the rest within ``rel`` of scale, 1e-5 unless
    given), two calls of each bit-identical; then each build's times over
    ``order`` (``timer``, ``chip_smoke.time_ms`` by default)."""
    ref = call(runs["change"])
    ref = ref if isinstance(ref, tuple) else (ref,)
    for tag, run in runs.items():
        one, two = call(run), call(run)
        one = one if isinstance(one, tuple) else (one,)
        two = two if isinstance(two, tuple) else (two,)
        check(all(torch.equal(a, b) for a, b in zip(one, two)),
              f"{name} [{tag}]: two calls differ")
        for i, (a, r) in enumerate(zip(one, ref)):
            if i in exact:
                check(torch.equal(a, r), f"{name} [{tag}] output {i} differs "
                      f"from the change's")
            else:
                cs.close_to_scale(a, r, f"{name} [{tag}] output {i} against "
                                  f"change", rel or cs.REL_TOL)
    del ref, one, two
    times = {tag: [] for tag in runs}
    timer = timer or cs.time_ms
    print(f"card before [{name}]: {card_state()}")
    for tag in order:
        times[tag].append(timer(lambda: call(runs[tag]), 20))
    print(f"card after [{name}]: {card_state()}")
    return times


def report(label, times, bound_ms, bound_by, extra=""):
    for tag, ms in times.items():
        best = min(ms)
        print(f"{label} {tag}: ms {' '.join(f'{t:.4f}' for t in ms)} "
              f"(best {best:.4f}; {100 * bound_ms / best:.1f}% of the bound "
              f"{bound_ms:.4f} ms, {bound_by}{extra})")


def serve_profile_turns(trees) -> None:
    """scripts/torch_serve_profile.py in each tree in the given order;
    prints each run's lines and the card's clock, power and temperature
    around it."""
    for tag, tree in trees:
        before = card_state()
        run = subprocess.run([sys.executable, "scripts/torch_serve_profile.py",
                              "--top", "8"], cwd=tree, capture_output=True,
                             text=True)
        if run.returncode != 0:
            raise RuntimeError(f"serve profile [{tag}] failed:\n"
                               f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
        print(f"profile serve [{tag}] card before: {before}; after: "
              f"{card_state()}")
        for line in run.stdout.splitlines():
            print(f"profile serve [{tag}] {line.rstrip()}")


def paged_turns(cs, libs, trees, turns, args, gen) -> None:
    """The paged read of every build at PAGED_SHAPES, warm and cold, in
    turns, beside its bound and the library's time."""
    paged = {tag: paged_call(libs[tag, "paged_decode_attention"], tree)
             for tag, tree in trees}
    for stages in (2, 4):
        paged[f"change-{stages}"] = paged_call(
            libs["change", "paged_decode_attention"], ROOT, stages)
    tags = turns + ["change-2", "change-4"]
    order = (tags + tags[::-1]) * args.rounds
    for name, r, h, pl, mp, pins, dtype in PAGED_SHAPES:
        q, _, _, pk, pv, table, pos = cs.paged_case(gen, r, h, DH, pl, mp,
                                                    pins, dtype)
        call = lambda run: run(q, pk, pv, table, pos)  # noqa: E731
        bound_ms, by, mb = cs.paged_bound(q, pk, table, pos)
        tl = table.long()
        live = (torch.arange(mp * pl, device=q.device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]

        def library():
            gk = pk[tl].transpose(1, 2).reshape(r, h, mp * pl, DH)
            gv = pv[tl].transpose(1, 2).reshape(r, h, mp * pl, DH)
            return torch.nn.functional.scaled_dot_product_attention(
                q, gk, gv, attn_mask=live)
        what = (f"paged [{name}] R={r} H={h} page {pl} MP={mp} Dh={DH} "
                f"{str(dtype)[6:]}")
        for temp, timer in (("warm", cs.time_ms), ("cold", cold_ms)):
            times = compare(cs, f"{what} {temp}", paged, call, order,
                            timer=timer, rel=(cs.BF16_REL_TOL
                                              if dtype == torch.bfloat16
                                              else None))
            report(f"{what} {temp}", times, bound_ms, by,
                   f", {mb:.2f} MB; library {timer(library, 20):.4f} ms")
        del q, pk, pv, table, pos


def profile_turns(trees) -> None:
    """scripts/torch_decode_profile.py --doc, then
    scripts/torch_train_profile.py (base) in each tree in the given
    order; prints each run's summary lines (the train profile's class
    lines too) and the card's clock, power and temperature around it.
    This checkout's decode profile is copied into the other trees first
    (an older one has no --doc)."""
    script = ROOT / "scripts" / "torch_decode_profile.py"
    for _, tree in trees:
        dst = Path(tree).resolve() / "scripts" / script.name
        if dst != script:
            shutil.copy(script, dst)
    runs = (("doc decode", ["scripts/torch_decode_profile.py", "--doc",
                            "--top", "12"]),
            ("base update", ["scripts/torch_train_profile.py", "--updates",
                             "3", "--top", "0"]))
    for what, cmd in runs:
        for tag, tree in trees:
            before = card_state()
            run = subprocess.run([sys.executable, *cmd], cwd=tree,
                                 capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"profile {what} [{tag}] failed:\n"
                                   f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
            print(f"profile {what} [{tag}] card before: {before}; after: "
                  f"{card_state()}")
            for line in run.stdout.splitlines():
                print(f"profile {what} [{tag}] {line.rstrip()}")


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
                    help="also profile doc decode and the base update in "
                    "turns")
    ap.add_argument("--serve-profile", action="store_true",
                    help="also profile the serve rounds in turns")
    ap.add_argument("--only", choices=("paged",), default=None,
                    help="time the paged read alone")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import _build
    resolve_device("cuda")
    cs.phase_card()
    trees = [("change", ROOT)]
    trees += [("parent", args.parent)] if args.parent is not None else []
    trees += [tuple(v.split("=", 1)) for v in args.variant]
    libs = build(trees, list(_build.NVCC_FLAGS))
    decode = {tag: decode_call(libs[tag, "decode_attention"], tree)
              for tag, tree in trees}
    packed = {tag: packed_call(libs[tag, "packed_attention"], tree)
              for tag, tree in trees}
    turns = ["parent"] * (args.parent is not None) + [
        tag for tag, _ in trees if tag != "parent"]
    order = (turns + turns[::-1]) * args.rounds
    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    paged_turns(cs, libs, trees, turns, args, gen)
    alone = args.only == "paged"
    for name, r, h, L, p in () if alone else DECODE_SHAPES:
        q, kn, vn = (torch.randn(r, h, 1, DH, generator=gen).to(dev)
                     for _ in range(3))
        ck, cv = (torch.randn(r, h, L, DH, generator=gen).to(dev)
                  for _ in range(2))
        rows = r // BEAM
        src = (torch.arange(rows)[:, None] * BEAM + torch.randint(
            0, BEAM, (rows, BEAM), generator=gen)).reshape(-1).to(
            dev, torch.int32)
        pos = torch.full((r,), p, dtype=torch.int32, device=dev)
        times = compare(cs, f"decode {name}", decode,
                        lambda run: run(q, kn, vn, ck, cv, pos, src), order,
                        exact=(1, 2))
        tile = h * L * DH * 4
        uniq = int(torch.unique(src).numel())
        nbytes = 2 * uniq * tile + 2 * r * tile + 4 * r * h * DH * 4 + 8 * r
        bound_ms, by = cs.bound(nbytes, 4 * r * h * (min(p, L - 1) + 1) * DH)
        report(f"decode [{name}] R={r} H={h} L={L} Dh={DH} pos={p}", times,
               bound_ms, by, f", {nbytes / 1e6:.1f} MB")
        del q, kn, vn, ck, cv
    for name, b, h, tq, tk, causal in () if alone else PACKED_SHAPES:
        q = torch.randn(b, h, tq, DH, generator=gen).to(dev)
        k, v = (torch.randn(b, h, tk, DH, generator=gen).to(dev)
                for _ in range(2))
        kvm = torch.ones(b, tk, device=dev)
        times = compare(cs, f"packed fwd {name}", packed,
                        lambda run: run(q, k, v, kvm, causal), order)
        mask = (torch.ones(tq, tk, device=dev).tril().bool() if causal
                else kvm.bool()[:, None, None, :])
        sdpa = cs.time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask))
        pairs = b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                         else tq * tk)
        bound_ms, by = cs.bound((2 * tq + 2 * tk) * b * h * DH * 4 + b * tk * 4,
                                4 * pairs * DH)
        report(f"packed fwd [{name}] B={b} H={h} Tq={tq} Tk={tk} Dh={DH}",
               times, bound_ms, by, f"; sdpa {sdpa:.4f} ms")
        del q, k, v, kvm
    pair = [t for t in trees if t[0] in ("parent", "change")][::-1]
    if args.serve_profile:
        serve_profile_turns(pair + pair[::-1])
    if args.profile:
        profile_turns(pair + pair[::-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
