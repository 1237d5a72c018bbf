"""Warmup pipeline — turn a committed bundle into a serving-ready
executor OFF the serving path; after
``marian_tpu/serving/lifecycle/warmup.py``.

Order of operations, cheapest refusal first:

1. **Compat check** (no weights touched): the candidate manifest's
   ``compat`` block (vocab sha256 + model-geometry config hash, written
   by training/bundle.py since manifest v2) must match the live
   version's. A mismatched vocabulary or geometry would serve garbage
   tokens or fail inside the decode step mid-traffic — refuse here,
   while the refusal costs a dict comparison. v1 manifests carry no
   compat block and are accepted with a warning (documented fallback).
2. **Load**: ``executor_factory(bundle_dir, manifest)`` builds a fresh
   ``translate_lines``-style callable against the bundle's members (the
   server's factories load ``model.npz`` onto the card; tests inject
   stubs).
3. **Golden smoke**: the executor translates the golden set
   (``--warmup-golden`` file, or a built-in probe) in one call, as the
   reference does with its perf plane off, and the call's arity and
   replies are checked (one reply a line, each a string without a
   newline: the scheduler's reply-routing invariant). A paged engine
   executor then decodes at each of its row buckets
   (``smoke_engine_grid``); ``--warmup-on-boot`` smokes one call per
   width bucket (``smoke_buckets``). This proves the checkpoint loads on
   the card and decodes; a checkpoint that loads but cannot run never
   reaches dispatch. There is no compile to time here (the reference
   times its XLA compiles per bucket; the port's kernels are built once
   per process), so a warmup that fails fails its candidate and nothing
   falls back.

Everything runs on the caller's thread (the watcher thread in the real
wiring), so a model load never stalls a batch.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

from ...common import faultpoints as fp
from ...common import logging as log
from ...data.batching import DEFAULT_LENGTH_BUCKETS, bucket_length
from ...training import bundle as bdl

# Built-in golden probe when --warmup-golden is unset: short sentences in
# the bucket widths serving traffic most commonly lands on. Unknown
# tokens are fine — warmup proves the decode path runs, not quality.
DEFAULT_GOLDEN = [
    "hello",
    "a b c d",
    "the quick brown fox jumps over the lazy dog",
]


class WarmupError(RuntimeError):
    """The candidate could not be warmed (load error, golden smoke
    failure, bad output arity)."""


class CompatMismatch(WarmupError):
    """Refused before loading weights: the candidate's compat block
    contradicts the live version's."""


def load_golden(path: Optional[str]) -> List[str]:
    """Golden source sentences from --warmup-golden (one per line, blank
    lines dropped); the built-in probe set when unset. An unreadable
    file is a hard error — a typo'd path silently warming with the
    default would void the operator's golden-set contract."""
    if not path:
        return list(DEFAULT_GOLDEN)
    with open(path, "r", encoding="utf-8") as fh:
        lines = [ln.strip() for ln in fh]
    lines = [ln for ln in lines if ln]
    if not lines:
        raise WarmupError(f"--warmup-golden {path} contains no sentences")
    return lines


def check_compat(candidate: Optional[Dict], live: Optional[Dict],
                 name: str) -> None:
    """Raise CompatMismatch on a declared mismatch; log the permissive
    v1-manifest fallback so an operator can see an unchecked swap."""
    ok, why = bdl.compat_ok(candidate, live)
    if not ok:
        raise CompatMismatch(f"bundle {name} is incompatible with the "
                             f"live model: {why}")
    if why:
        log.warn("model lifecycle: {} — swap proceeds unchecked ({})",
                 why, name)


def golden_buckets(golden: List[str],
                   length_buckets=DEFAULT_LENGTH_BUCKETS
                   ) -> "collections.OrderedDict":
    """Group golden sentences by the width bucket their whitespace
    token count (+EOS, matching the scheduler's default_length_fn)
    lands on — one group = one warmup call at one serving width."""
    groups: "collections.OrderedDict[int, List[str]]" = \
        collections.OrderedDict()
    for line in golden:
        w = bucket_length(len(line.split()) + 1, length_buckets)
        groups.setdefault(w, []).append(line)
    return groups


def _checked(executor, lines: List[str], where: str) -> List[str]:
    """One smoke call: its replies, after the arity and reply checks."""
    try:
        out = executor(list(lines))
    except Exception as e:  # noqa: BLE001
        raise WarmupError(f"golden-set smoke translation failed for "
                          f"{where}: {e}") from e
    if not isinstance(out, (list, tuple)) or len(out) != len(lines):
        raise WarmupError(
            f"golden-set smoke returned "
            f"{len(out) if isinstance(out, (list, tuple)) else type(out).__name__} "
            f"outputs for {len(lines)} inputs ({where}) — reply routing "
            f"would misalign")
    bad = [i for i, r in enumerate(out)
           if not isinstance(r, str) or "\n" in r]
    if bad:
        raise WarmupError(f"golden-set smoke reply {bad[0]} is not a "
                          f"one-line string ({where}): {out[bad[0]]!r}")
    return list(out)


def smoke_buckets(executor: Callable[[List[str]], List[str]],
                  golden: List[str], where: str) -> None:
    """Per-bucket golden smoke: one executor call per width bucket (a
    combined call would decode every sentence padded to the widest
    bucket). Raises WarmupError."""
    for width, lines in golden_buckets(golden).items():
        _checked(executor, lines, f"{where}, bucket w{width}")


def smoke_engine_grid(executor, golden: List[str], where: str) -> int:
    """Iteration mode: when the warmed executor wraps a paged decode
    engine (``EngineExecutor``), decode the first golden sentence at
    every row bucket of the engine (``ROW_BUCKETS`` cut to its slots;
    a beam engine's buckets are beam-block multiples, a sentence a
    block), so every row shape a round can take has run on the card
    before the engine serves. Returns the number of buckets driven (0
    for other executors)."""
    engine = getattr(executor, "engine", None)
    buckets = tuple(getattr(engine, "row_buckets", ()) or ())
    if engine is None or not buckets:
        return 0
    per = max(1, int(getattr(engine, "beam_size", 1) or 1))
    for rb in buckets:
        n = max(1, rb // per)
        _checked(executor, [golden[0]] * n,
                 f"{where}, row bucket {rb}")
    log.info("model lifecycle: engine row buckets {} warmed for {}",
             list(buckets), where)
    return len(buckets)


def warm_executor(bundle_dir: str, manifest: Optional[Dict],
                  executor_factory: Callable[[str, Optional[Dict]],
                                             Callable[[List[str]],
                                                      List[str]]],
                  golden: List[str]) -> Callable[[List[str]], List[str]]:
    """Steps 2+3: build the executor and golden-smoke it. Returns the
    warmed ``translate_lines``; raises WarmupError on any failure."""
    fp.fault_point("lifecycle.warmup")
    t0 = time.perf_counter()
    try:
        executor = executor_factory(bundle_dir, manifest)
    except Exception as e:  # noqa: BLE001 — any load error refuses the swap
        raise WarmupError(f"executor load failed for {bundle_dir}: "
                          f"{e}") from e
    t_load = time.perf_counter()
    _checked(executor, golden, bundle_dir)
    smoke_engine_grid(executor, golden, bundle_dir)
    t_done = time.perf_counter()
    log.info("model lifecycle: warmed {} (load {:.2f}s, golden smoke of "
             "{} sentences {:.2f}s)", bundle_dir, t_load - t0,
             len(golden), t_done - t_load)
    return executor
