#!/usr/bin/env python3
"""Checks of the fused CE's bf16 backward on the tensor cores, on the card.

For seeded inputs at the base (N 12,288, E 512) and doc (N 16,384, E
1,024) training shapes, V 32,000, bf16 x and w:

- d rounding: how many d values each bf16 backward path rounds to
  another bf16 value than the plain version's d (``plain_chunk_ops``'
  make_d) rounds to, over every vocabulary chunk: the tensor-core d
  kernel's stored bf16 scratch, and the CUDA-core d kernel's f32 scratch
  rounded as its products round it;
- margins: each path's dx and dw against ``fused_ce_bwd_reference``
  under ``chip_smoke.py``'s gate (one bf16 spacing of the plain value
  plus REL_TOL of the largest), as the largest excess over that spacing
  in units of REL_TOL x scale: over 1 fails the gate.

With --variants it also builds edited copies of ``csrc/`` under
``build/tc_check/`` (``one_block``: one block an SM instead of two;
``one_level``: each k-step's products added into the accumulators on the
tensor cores, not from 0 and then by f32 adds) and prints their margins
and their joint backward's time, in turns with this tree's (CUDA events
behind a device sleep). Run from the root of a checkout on the machine
with the card:

    python3 scripts/torch_fused_ce_tc_check.py [--seeds 3] [--variants]
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
OUT = ROOT / "build" / "tc_check"
VOCAB = 32000
SHAPES = (("base", 12288, 512), ("doc", 16384, 1024))
# csrc/mma_tiles.cuh as the variants edit it: (file, text, replacement)
VARIANTS = {
    "one_block": [("mma_tiles.cuh", "constexpr int kBlocksPerSM = 2;",
                   "constexpr int kBlocksPerSM = 1;")],
    "one_level": [("mma_tiles.cuh", """        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(step, a[0], b[0][j][0], b[0][j][1]);
        mma_bf16(step, a[1], b[1][j][0], b[1][j][1]);
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] += step[h];""",
                   """        mma_bf16(acc[i][j], a[0], b[0][j][0], b[0][j][1]);
        mma_bf16(acc[i][j], a[1], b[1][j][0], b[1][j][1]);""")],
}


def build_variants() -> dict:
    """{name: library} of each variant's bf16 fused CE, built together;
    prints its tensor-core kernels' ptxas lines."""
    from marian_tpu_torch.ops.kernels import _build
    jobs = {}
    for name, edits in VARIANTS.items():
        src = OUT / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        for file, old, new in edits:
            text = (src / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to edit is not "
                                 f"once in {file}")
            (src / file).write_text(text.replace(old, new))
        lib = src / "libfused_ce_bf16.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DKERNEL_DTYPE=1",
             "-Xptxas", "-v", "-o", str(lib), str(src / "fused_ce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        for line in _build.ptxas_usage(log):
            if line.startswith("fce_tc_"):
                print(f"ptxas [{name}] {line}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def inputs(gen, n, e, dev):
    x = torch.randn(n, e, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(VOCAB, e, generator=gen) * e ** -0.5).to(
        dev, torch.bfloat16)
    b = torch.randn(VOCAB, generator=gen).to(dev)
    labels = torch.randint(0, VOCAB, (n,), generator=gen).to(dev)
    g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
    return x, w, b, labels, g


def rounding_differences(fce, x, w, b, labels, lse, g) -> dict:
    """Per path, the d values (of all chunks) whose bf16 rounding differs
    from that of the plain version's d."""
    n, e = x.shape
    lbl = labels.to(torch.int32)
    s = torch.cuda.current_stream().cuda_stream
    make_d = fce.plain_chunk_ops(x, w, b, labels, lse, *g, None, None,
                                 None)[0]
    ptrs = [t.data_ptr() for t in (x, w, b, lbl, lse, *g)]
    out = {"tensor cores": 0, "CUDA cores": 0}
    for v0, width in fce.vocab_chunks(n, VOCAB, elem=2):
        ldd = -(-width // fce.CHUNK_ALIGN) * fce.CHUNK_ALIGN
        plain = make_d(v0, width).bfloat16()
        d16 = torch.empty((n, ldd), device=x.device, dtype=torch.bfloat16)
        fce._fn("fused_ce_bwd_tc_dlogit", 11, 5, True)(
            *ptrs, d16.data_ptr(), None, None, n, e, v0, width, ldd, s)
        out["tensor cores"] += int((d16[:, :width] != plain).sum())
        del d16
        d32 = torch.empty((n, ldd), device=x.device)
        fce._fn("fused_ce_bwd_dlogit", 9, 7, True)(
            *ptrs, d32.data_ptr(), n, e, v0, width, ldd, 1, 1, s)
        out["CUDA cores"] += int((d32[:, :width].bfloat16() != plain).sum())
        del d32, plain
    return out


def margin(got, ref, rel: float) -> float:
    """The largest excess of |got - ref| over one bf16 spacing of ref, in
    units of rel x max(1, max |ref|): chip_smoke.close_bf16 fails over 1."""
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1.0)
    over = (got - ref).abs() - 2.0 ** -7 * ref.abs()
    return float(over.max()) / (rel * scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3,
                    help="inputs a shape (seeds 100, 101, ...)")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fused_ce_tc_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from marian_tpu_torch.device import resolve_device
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    from torch_fused_ce_fwd_ab import entry
    resolve_device("cuda")
    cs.phase_card()
    dev = torch.device("cuda")
    own = fce._fn
    paths = {"tensor cores": own}
    if args.variants:
        paths.update({name: entry(lib)
                      for name, lib in build_variants().items()})
    worst = {}
    for name, n, e in SHAPES:
        for k in range(args.seeds):
            seed = 100 + k
            x, w, b, labels, g = inputs(torch.Generator().manual_seed(seed),
                                        n, e, dev)
            lse = fce.fused_ce_stats_reference(x, w, b, labels)[0]
            diff = rounding_differences(fce, x, w, b, labels, lse, g)
            rdx, rdw, _ = fce.fused_ce_bwd_reference(x, w, b, labels, lse,
                                                     *g)
            got = {}
            for path, fn in paths.items():
                fce._fn = fn
                got[path] = fce.fused_ce_bwd(x, w, b, labels, lse, *g)[:2]
            fce._fn = own
            saved = fce.tc_path
            fce.tc_path = lambda *a: False
            got["CUDA cores"] = fce.fused_ce_bwd(x, w, b, labels, lse, *g)[:2]
            fce.tc_path = saved
            line = []
            for path, (dx, dw) in got.items():
                m = (margin(dx, rdx, cs.REL_TOL), margin(dw, rdw, cs.REL_TOL))
                worst[path] = max(worst.get(path, 0.0), *m)
                line.append(f"{path} dx {m[0]:.3f} dw {m[1]:.3f}")
            print(f"[{name}] N={n} E={e} seed {seed}: d values rounded "
                  f"otherwise than the plain d, of {n * VOCAB}: "
                  f"tensor cores {diff['tensor cores']}, CUDA cores "
                  f"{diff['CUDA cores']}; margins (over 1 fails): "
                  + "; ".join(line), flush=True)
            del x, w, b, labels, g, lse, rdx, rdw, got
            torch.cuda.empty_cache()
    print("largest margin over all inputs: " + "; ".join(
        f"{path} {m:.3f}" for path, m in worst.items()))
    if not args.variants:
        return 0
    for name, n, e in SHAPES:
        x, w, b, labels, g = inputs(torch.Generator().manual_seed(17), n, e,
                                    dev)
        lse = fce.fused_ce_stats_reference(x, w, b, labels)[0]
        times = {path: [] for path in paths}
        order = list(paths) + list(paths)[::-1]
        for _ in range(2):
            for path in order:
                fce._fn = paths[path]
                times[path].append(cs.time_ms(
                    lambda: fce.fused_ce_bwd(x, w, b, labels, lse, *g), 5))
        fce._fn = own
        for path, ms in times.items():
            print(f"[{name}] N={n} E={e} joint bf16 backward, {path}: ms "
                  f"{' '.join(f'{t:.4f}' for t in ms)} (best {min(ms):.4f})")
        del x, w, b, labels, g, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
