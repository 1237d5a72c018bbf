#!/usr/bin/env python3
"""Where the time of marian_tpu_torch's paged serving engine goes, on the
card.

Builds the engine chip_smoke.py serves (transformer-base with the
weights ``chip_smoke.serve_weights`` makes from --seed to copy their
source, vocab 32,000, 64 slots, pages of 16, cap 128) and decodes
one warm-up set of sentences. Then it decodes --sentences sentences of
8-40 words three ways and prints each one's rounds, rows per round and
time per round:

- through ``PagedDecodeEngine.decode_texts`` on the main thread (the
  serving loop's rounds without the scheduler and the sockets), once
  untraced and once under torch.profiler, with the device's busy time
  (sum of kernel times), its idle share over the untraced wall time,
  the kernels launched per round, and the kernels and host operators
  that took the most time;
- the same on a worker thread (as the scheduler runs rounds);
- served: ServingApp on a TCP port, 16 clients, every request at once,
  twice untraced and once traced (engine and wall time per round).

``--beam`` profiles the beam engine chip_smoke.py serves instead (beam 6,
``chip_smoke.beam_serve_options``), with ``--merge host`` (the default
here) or ``fused`` (the server's own default at beam > 1); ``--steps N``
runs N decode steps a round (--iteration-steps; the host merge takes 1).
Each line gives sentences/s and the time per round and per step.

Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_serve_profile.py [--seed 17] [--sentences 256]
        [--beam [--merge host|fused]] [--steps N]
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def report(prof, rounds: int, wall: float, top: int) -> None:
    """Device busy time, idle share of ``wall``, launches per round, top
    kernels and host operators of a trace over ``rounds`` rounds."""
    averages = prof.key_averages()
    # device kernels only: operator rows carry their kernels' time too
    kernels = [e for e in averages if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"  device busy {busy_us / 1e3:.1f} ms = "
          f"{busy_us / 1e3 / rounds:.3f} ms/round; idle share "
          f"{1 - busy_us / 1e6 / wall:.3f} of the untraced wall; "
          f"{launches / rounds:.1f} kernels launched per round")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<7d} {e.key[:90]}")
    host = [e for e in averages if not str(e.device_type).endswith("CUDA")
            and e.key.startswith("aten::")]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    print("  host operators by self CPU time:")
    for e in host[:top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"x{e.count:<7d} ({e.count / rounds:6.1f}/round) {e.key[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--sentences", type=int, default=256)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--beam", action="store_true",
                    help="the beam engine (beam 6)")
    ap.add_argument("--merge", choices=("host", "fused"), default="host",
                    help="the beam engine's merge (with --beam)")
    ap.add_argument("--steps", type=int, default=1,
                    help="decode steps a round (--iteration-steps)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.server.server import ServingApp, _make_tcp_handler
    from torch.profiler import ProfilerActivity, profile

    _build.build_all()
    cs.write_model(args.seed)
    steps = ("--iteration-steps", str(args.steps))
    app = ServingApp(cs.beam_serve_options(*steps, merge=args.merge)
                     if args.beam else cs.serve_options(*steps))
    engine = app.scheduler.engine
    print(f"engine: {type(engine).__name__}, "
          f"{getattr(engine, 'merge', 'greedy')} "
          f"merge, {engine.steps_per_round} steps a round, "
          f"{engine.pool.usable_pages} pages")
    sents = cs.serve_sentences(args.seed, args.sentences)
    engine.decode_texts(cs.serve_sentences(args.seed + 1, cs.SERVE_ROWS))

    def measured(fn):
        before = dict(engine.counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, {k: engine.counters[k] - before[k] for k in before}

    def line(name, wall, n):
        print(f"{name}: {n['rounds']} rounds, {n['steps']} decode steps, "
              f"{n['encodes']} encoder calls, {n['rows'] / n['rounds']:.2f} "
              f"rows per round; {1e3 * n['round_s'] / n['rounds']:.3f} "
              f"ms/round in the engine, {1e3 * wall / n['rounds']:.3f} "
              f"ms/round wall, {1e3 * wall / n['steps']:.3f} ms/step wall, "
              f"{wall:.3f} s, {len(sents) / wall:.2f} sentences/s")

    def decode():
        engine.decode_texts(sents)
    wall, n = measured(decode)
    line("engine, main thread", wall, n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        measured(decode)
    report(prof, n["rounds"], wall, args.top)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        wall_t, n_t = pool.submit(measured, decode).result()
    line("engine, worker thread", wall_t, n_t)

    async def serve():
        app.start()
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]

        async def traffic():
            before = dict(engine.counters)
            t0 = time.perf_counter()
            await cs.serve_traffic(port, sents, cs.SERVE_CLIENTS)
            secs = time.perf_counter() - t0
            return secs, {k: engine.counters[k] - before[k] for k in before}
        try:
            for run in (1, 2):
                line(f"served run {run}", *await traffic())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                secs, n = await traffic()
            line("served run 3 (traced)", secs, n)
            report(prof, n["rounds"], secs, args.top)
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
