#!/usr/bin/env python3
"""Chip smoke test of marian_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA card. Run from the root of a checkout:

    python3 chip_smoke.py [--seed 17]

It builds the port's CUDA kernels from csrc/ (one nvcc per library, all
at once), holds each kernel against its plain PyTorch version on the
card, and drives the port's main paths on data made from --seed:

- marian-decoder, transformer-base: beam 6 on random weights; the same
  sentences are decoded on the card and on the CPU;
- marian-train, transformer-base: a synthetic 32,000-word parallel
  corpus, 2 updates through ``marian_train.main`` (which write a
  checkpoint), then 20 counted updates through the trainer object
  ``main`` drives, resuming from that checkpoint; the trained checkpoint
  is decoded on the card; a 2+2-layer cut trains 3 updates on the card
  and on the CPU, which must agree leaf by leaf in gradients and
  parameter changes; every save is a committed checkpoint bundle
  (train.npz.bundles: one a save, each validates, train.npz the newest
  one's model member byte for byte; a copy with that member truncated
  restores from the bundle before it; both runs --overwrite: no
  iteration-numbered copies);
- the model lifecycle (marian-server --model-watch 0.2, --metrics-port)
  in request mode on the copying weights' 2+2-layer cut (full width),
  committed as a bundle:
  /readyz 503 while the server boots (--warmup-on-boot) and 200 once it
  serves; marian_train, in this process, trains 2 updates on the same
  model path and commits B while 16 clients send 256 sentences, one
  request after another: zero failures, every reply Translate.run of A
  or of B, every reply B's once /lifecyclez shows B live; at
  --canary-fraction 0.5 --canary-min-batches 8 a candidate C whose
  executor raises after its golden decode is rolled back with zero
  client failures (counted in /metrics), the card's allocated bytes
  rising by one model while C is canary and falling back at its
  release; a bundle D with another vocabulary hash refused with nothing
  loaded; POST /admin/rollback returns live to A; then in iteration
  mode (greedy, 64 slots, --quiesce-deadline 0.5) a swap through the
  quiesce protocol under the same load: every reply A's or B's dense
  greedy decode or !!SERVER-RETRY, the retries equal to the quiesce
  evictions, both pools audited clean, the old engine's pool freed once
  it leaves the rollback slot; and one fused beam-6 swap on 8
  sentences with the live engine's rounds under the sync guard (the
  candidate's load and golden decode on the watcher thread never
  overlap a guarded round);
- the same training on the 2+2 cut at full width (its warm-up in the
  same run) at --optimizer-delay 2 (two micro-batches of half the words
  an update: twice the kernel launches), validated every 5
  updates on a 64-line dev set from the seed (cross-entropy, bleu, chrf,
  translation: the validators decode through the beam search), with
  --keep-best and stall-driven --lr-decay: the validations fire where
  --valid-freq says, the dev cross-entropy recomputed sentence by
  sentence agrees, bleu and chrf equal those of Translate.run of their
  .best checkpoints, the .best files are written where a metric
  improved and the lr factor follows the stalls; the 2+2 cut at delay 2
  on the card and on the CPU within the f32 limits;
- doc-level marian-train, the 2+2 cut of transformer-big at full width:
  documents of 1,023-2,047 words, 2 + 8 updates in one run (its save the
  model file, which the decode reads), every attention through the
  flash kernels; the trained checkpoint then decodes 4 documents at beam 6
  with a 1,024-position cache (doc-level marian-decoder); a 2+2-layer,
  dim-256 cut trains on documents past 1,024 tokens on the card and on
  the CPU (held as above) and decodes one with a cache past 442
  positions on both;
- marian-server, transformer-base, iteration mode at beam 1: the server
  runs in this process on a TCP port with weights made from --seed to
  copy their source (``serve_weights``: greedy output then follows the
  attention and each row leaves at its own EOS); 16 clients send 256
  one-line requests of 8-40 words, all at once, into 64 decode slots
  over a paged KV pool, so rows join mid-decode and leave at their own
  EOS; every reply must equal the dense greedy decode of its sentence on
  the card, and the engine's logits at every step the dense step's on
  the same tokens; 16 of the sentences decode to the same texts, with
  the same logits within a tolerance, on the card and on the CPU;
- marian-server in request mode, its defaults (beam 12, batches by token
  budget): the same 256 sentences from 16 clients through the scheduler
  into the dense beam search; every reply must equal Translate.run of
  the same sentences on the card (in other batches);
- from here on the serve paths (the beam ones in f32 and bf16, the
  prefix cache, the decode surface, the watchdog and the lifecycle) run
  the copying weights of the 2+2-layer base cut at full width
  (SERVE_CUT_MODEL: a depth cut for the run's time);
- marian-server in iteration mode at beam 6 with the host merge: the
  copy-on-write beam engine over the paged pool answers the same
  traffic; every reply must equal the dense beam search's best
  hypothesis on the card at its decode cap (raw scores within a
  tolerance), joins land mid-decode, hypotheses fork and share pages,
  and the pool ends empty; 8 sentences decode to the same texts on the
  card and on the CPU;
- the same at the server's own default at beam > 1, the fused on-device
  merge, at --iteration-steps 1 and 4 (the same checks; every round's
  step loop runs under torch.cuda.set_sync_debug_mode("error"), so a
  host sync inside it fails the run; no round falls back to the host
  merge), printed beside the host merge's rounds and sentences/s; on a
  pool too small for the rounds' worst-case page preclaim (12 slots, 8
  steps a round), where rounds fall back to one host-merge step with
  the same replies; 8 sentences on the card and on the CPU at 4 steps;
- --prefix-cache, greedy and fused beam at 4 steps a round: 64
  sentences each sent twice (half the repeats while the first copy
  decodes, half after its reply); every reply equals the dense decode,
  the greedy engine forks repeats from live rows, both replay finished
  ones, and after the cache's drop_all the pool is empty;
- the decode surface, with a lex table from --seed
  (each word's own copy and 19 random targets; parsed once from its
  text, lex.s2t, and read by the phase's decoders and servers as the
  port's binary table, --shortlist lex.npz 100 20, with vocab.json, the
  same map as vocab.yml: host parsing cut for the run's time): the
  dense beam-6 search with the shortlist (card against CPU, and
  --word-scores summing to the raw scores); greedy with the shortlist
  equal to the full-vocabulary decode (the smallest top-1 margin
  printed); iteration greedy and the fused beam (4 steps a round, under
  the sync guard) with per-row shortlists, each reply the dense
  shortlisted decode of its sentence; --force-decode through a prefix
  file (marian-decoder) and TAB lines (the fused beam), replies the
  dense forced decode; --output-sampling topk 1 equal to the unsampled
  decode and topk 10 0.8 replaying at its seed; iteration --n-best equal
  to request mode's blocks; a #stream:1 client's partials prefixes of
  its final reply; and the sampling noise equal on the card and the CPU;
- the dispatch watchdog (--dispatch-stall-timeout) on the serve model:
  one request's device call waits on a host event past the timeout in
  request mode, iteration greedy and the fused beam merge (there inside
  the round's sync-debug guard); its reply is !!SERVER-RETRY, the
  scheduler trips once, the sync-debug mode is back to default, and 16
  following requests are served on a fresh worker (a rebuilt engine
  whose pool audits clean), each equal to Translate.run or the dense
  greedy or beam decode; the flight recorder armed (--trace-dump), each
  trip writes one flight file holding the trip's event, the span ring
  and a /metrics snapshot;
- the observability plane on the 2+2 cut, request mode and the fused
  beam merge (4 steps a round, under the sync guard): 128 one-line
  requests with #trace:<id> headers from 16 clients, with every plane
  on (--trace, --trace-dump, --metrics-port, --slo-availability 0.999,
  --slo-p99-ms) and with every plane off (--perf-accounting false),
  off, on, on, off: each reply its #trace: line (queue_ms + service_ms
  within the client's latency) over Translate.run's or the dense beam
  search's text; /tracez holds each id's span tree with the reference's
  names and parent edges; /metrics passes the port's promlint with its
  latency exemplars' ids among those sent and the request counters
  equal to the requests sent; /poolz is consistent with the engine's
  pool; /sloz reports both objectives; the MFU, busy ratio and headroom
  gauges read within (0, 1]; the on and off sentences/s and ms per
  batch or round printed with the card's name and power limit;
- the brownout ladder on the 2+2 cut, iteration greedy, 64 slots
  (--brownout --brownout-hold 0.5 --brownout-cool 1, a cap factor of
  0.25 that cuts the copying replies), the step loop under the sync
  guard: 128 closed-loop priority-0 clients and 4 priority-2 clients of
  8 sentences climb the ladder on the card's headroom gauge (the floor
  set just above the gauge's reading when the flood does not reach the
  default 0.1, both printed) one rung at a time to 3, counted in
  /metrics; every joined row's cap is the engine's rule at the scale of
  its join, every served reply the dense greedy decode at that cap; the
  priority-0 !!SERVER-RETRY replies equal the brownout evictions and the
  !!SERVER-OVERLOADED ones the brownout sheds, priority-2 requests are
  served at level 3; after the traffic the ladder cools to 0 and the cap
  scale returns to 1; one flight file an escalation with the ladder's
  state; /sloz shows level 3; the pool ends empty and audited clean;
  p50/p99 per lane and the ladder's timeline printed;
- fleet serving through server._serve (the transport it announces:
  WebSocket where the websockets package is installed, as on the card's
  machine, else TCP; the client speaks it), request mode at beam
  12: tenant a the 6+6 serve model, tenant b the 2+2 cut of the copying
  weights of --seed + 1, --fleet-default-tenant a and a budget between
  one tenant's estimate and the two estimates' sum; 128 traced requests
  from 16 clients in waves a, b, a (each wave warms its tenant on demand
  and evicts the other) and 4 with an unknown tag: every reply
  Translate.run of its tenant's model with its version in the #trace:
  line, each tenant's executor decoding exactly its requests, the
  unknown tags !!SERVER-ERROR, the cold-start and eviction counters
  equal to /fleetz and /metrics, every eviction giving back the
  tenant's parameter bytes, the marian_fleet_* series through promlint;
  each warm's estimate printed beside the bytes the card allocated;
- the test hooks on the 2+2 cut with MARIAN_OWNWIT=1 and
  MARIAN_LOCKDEP=1 (set for the phase only): each corruption drill armed
  once on an engine serving rows that an unarmed round audited clean
  (pool.double_free, pool.table_corrupt, pool.release_drop on the greedy
  engine; pool.refcount_corrupt, beam.diff_corrupt on the fused beam
  engine at 4 steps a round under the sync guard; tenant.page_leak on a
  greedy engine serving two tenants' rows), each named by its auditor
  (the engine's audit; the tenant leak by audit_tenants alone, the
  pool's audit clean), the dropped release by the ownership witness;
  serving.translate=hang at twice --dispatch-stall-timeout trips the
  iteration watchdog once and 16 following requests are served; the
  witnessed locks show no acquisition-order cycle;
- the chaos harness (scripts/torch_chaos.py) on the card, its processes
  beside the doc card-vs-CPU phase: the fixed round on the harness's
  kill-schedule config (the 2+2 cut of transformer-base at full width, 4
  updates, a save every 2, one batch a corpus window): marian_train with
  MARIAN_FAULTS=ckpt.commit=kill@2 exits 117, its committed bundle
  validates and no staging directory is listed as one, its flight file
  holds the fault plane; a restart in this process resumes to the
  harness's uninterrupted run, parameters, optimizer state and progress
  bit for bit; then the harness's seeded kill round (ckpt.async.worker
  under --async-save), one --swap and one --swap --iteration round
  (tiny model, iteration mode over a two-row pool under traffic), each
  reported and each held to the harness's contract;
- the transformer-base recipe: marian-train --task transformer-base
  (6+6, dim 512, max-length 100, --mini-batch-fit) on lines of 1-99
  words, the fit searching under a 24 GiB memory fraction (an
  out-of-memory probe crossed, the card's allocated bytes back where
  they were), then 6 updates with --mini-batch-warmup 4 (the budget
  ramping), --mini-batch-track-lr and --dynamic-gradient-scaling 2 log:
  losses and gradient norms finite, gstat:n saved equal to 6, the tiled
  packed backward and the fused CE past 16,384 tokens counted;
- the rest of the training slice at the base width (6+6), through
  marian_train: --tsv with guided alignment, gradient checkpointing,
  --output-omit-bias, depth scaling and pretrained vectors with the
  source table fixed (costs and guided costs finite, the fixed table
  byte-equal to the vectors loaded, no bias key saved, every update's
  launches counted, the model decoded); --right-left with --quantize-bits
  8 and --gradient-dropping-rate 0.9 (at most 255 values a quantized
  matrix, the checkpoint's decode equal on the card and the CPU); the
  2+2 cut card against CPU for guided alignment with checkpointing, for
  compression and for the unlikelihood loss (no fused CE launch); and
  checkpointing against none at the base width, loss, gradients and
  updated parameters bit-identical, with peak memory, ms/update and the
  packed forward's recomputed launches;
- the trainer's observability plane on the base train path, without
  and with --trace-sync-phases: /metrics at a display linted clean with
  the six trainer series, the phase gauge and the two train gauges,
  marian_train_mfu in (0, 1], chip-seconds per token x labels the
  window's logged time within 5%, /tracez's train spans, the profiler
  window's trace naming the port's kernels of rows 2, 3 and 7-9; the
  MFU, the phase shares and ms/update printed;
- mixed precision (--precision bfloat16 float32): the fused CE's bf16
  instantiations (its forward and backward on the tensor cores at E % 8
  == 0) and the attention kernels' bf16 instantiations (at the bf16
  paths' shapes, timed beside SDPA on bf16; the flash forward, dq and
  dkv on the tensor cores for aligned operands, the packed forward
  there at every length and the packed backward up to 64 tokens) held
  against their plain versions on the same
  bf16 operands;
  transformer-base trained 2 + 10 updates in one run (nothing saved:
  no check reads it) and decoded (beam 6,
  the same sentences) in bf16; and bf16 on the card against bf16 on the
  CPU within PARITY_LIMITS_BF16: the 2+2 base and doc-level training
  cuts, and the 2+2 base decode by its step logits on the card's own
  tokens. Their CPU halves need no card: a child process of this script
  (--cpu-references) runs them while the kernels build and the kernel
  phases run, on its own copy of the same data, and the card's halves
  are held to them later; request mode, the host merge and the
  fused merge (4 steps a round) in bf16 (64 sentences each), their
  replies held to the bf16 dense decodes on the card; and the decode
  surface in bf16 on the 2+2 cut, held as the bf16 decode is (8
  sentences shortlisted with --word-scores, and with a forced prefix).

Each main path (and the bf16 doc-level cut, the bf16 flash kernels'
path) runs with every launch count set to 0 just before it and read
just after; a kernel's ``launches`` in the kernel line is the sum over
the paths that run it (for the attention kernels, whose f32 and bf16
instantiations share a counter, over the paths of the row's type; the
tensor-core kernels count on their wrappers' ``launches_bf16_tc``). The
flash phase also runs head sizes the flash kernels are not built for
(Dh 48, 80: zero-padded to 64, 128).
Phases print their own lines, each with its seconds and the bytes the
script and every process it started wrote meanwhile (WriteMeter), and a
total before the kernel line; any failure ends the run with a non-zero
exit and no result. The last line is
{"ok": true, "device": {...}}; the line before it lists every kernel.

Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# the child process's copy of the data (--cpu-references), and its
# threads: the rest of the cores build the kernels meanwhile
CPU_WORK = ROOT / "build" / "chip_smoke_cpu"
CPU_REF_THREADS = 4

# transformer-base as the repo runs it (bench_decode.py 'base' preset)
BASE = {"type": "transformer", "dim-emb": 512, "transformer-heads": 8,
        "transformer-dim-ffn": 2048, "enc-depth": 6, "dec-depth": 6,
        "tied-embeddings-all": True, "transformer-ffn-activation": "relu",
        "precision": ["float32", "float32"], "max-length": 64}
VOCAB, BATCH, SRC_LEN, BEAM, N_BATCHES = 32000, 64, 32, 6, 2
# the doc-level card-vs-CPU cut's vocabulary (w2 .. w499 of the same
# words): the card's f32 rounding noise in its gradient norms grows with
# the vocabulary (scripts/torch_train_parity.py; PERF.md section 6)
VOCAB_CUT = 500
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 on the tensor cores, dense
TOL = 2e-5
# The packed backward and the fused CE sum hundreds to thousands of
# products in another order than their plain versions: held to this
# share of the output's largest magnitude.
REL_TOL = 1e-5
# the fused CE backward's forced narrow vocabulary chunk (several chunks,
# the last one ragged)
FORCED_CHUNK = 3000
# training: bench.py's 'base' preset (f32, --transformer-dropout 0.1)
TRAIN_WORDS, TRAIN_LINES, WARM_UPDATES, COUNTED_UPDATES = 12288, 8000, 2, 20
TRAIN_FLAGS = [
    "--type", "transformer", "--dim-emb", "512", "--transformer-heads", "8",
    "--transformer-dim-ffn", "2048", "--enc-depth", "6", "--dec-depth", "6",
    "--tied-embeddings-all", "--transformer-ffn-activation", "relu",
    "--precision", "float32", "float32", "--label-smoothing", "0.1",
    "--cost-type", "ce-mean-words", "--learn-rate", "2e-4",
    "--lr-warmup", "8000", "--lr-decay-inv-sqrt", "8000",
    "--optimizer", "adam", "--optimizer-params", "0.9", "0.98", "1e-9",
    "--clip-norm", "0", "--exponential-smoothing", "1e-4",
    "--max-length", "63", "--max-length-crop", "--mini-batch", "512",
    "--maxi-batch", "100", "--maxi-batch-sort", "trg", "--shuffle", "data",
    "--seed", "1111", "--transformer-dropout", "0.1", "--disp-freq", "10",
    "--quiet"]
# the delay + validation train path: --optimizer-delay DELAY at half the
# base path's words a micro-batch, validated every VALID_FREQ updates on
# a held-out dev set of DEV_LINES lines from the seed through
# DELAY_METRICS at beam BEAM (--valid-mini-batch DEV_LINES: one dev
# batch), --keep-best, and --lr-decay 0.5 after every validation at
# which the first metric has stalled
DELAY, DEV_LINES, VALID_FREQ = 2, 64, 5
DELAY_METRICS = ("cross-entropy", "bleu", "chrf", "translation")
# the validator's dev cross-entropy against the same loss recomputed
# sentence by sentence on the card, relative
CE_REL_TOL = 1e-5
# each training main path's ms/update and peak memory, by model file
TRAIN_RUNS = {}
# card vs CPU training (parity_readings), relative: limits set between
# the sound port's readings and those of planted faults
# (scripts/torch_train_parity.py; PERF.md section 6)
PARITY_LIMITS = {"loss": 1e-3, "grad": 3e-3, "grad_norm": 3e-4,
                 "update": 1e-4}
# per update: 6 encoder self + 6 decoder causal self + 6 cross attentions
PER_UPDATE = {"packed_attention": 18, "packed_attention_bwd": 18,
              "flash_attention_fwd": 0, "flash_attention_dq": 0,
              "flash_attention_dkv": 0,
              "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
# the 2+2 cut at full width (the delay path, the chaos harness's fixed
# round): 2 encoder self + 2 decoder causal self + 2 cross attentions
PER_UPDATE_2X2 = {**PER_UPDATE, "packed_attention": 6,
                  "packed_attention_bwd": 6}
# mixed precision (--precision bfloat16 float32, bench.py's presets'
# precision): the same base training and decode in bf16 from f32 master
# weights, the fused CE through its bf16 instantiations
BF16_FLAGS = ["--precision", "bfloat16", "float32"]
BF16_WARM, BF16_COUNTED = 2, 10
# (E 512: the fused CE's forward and backward on the tensor-core
# kernels, counted on the wrappers' launches_bf16_tc; the CUDA-core bf16
# kernels not at all)
PER_UPDATE_BF16 = {**PER_UPDATE, "fused_ce_fwd": 0, "fused_ce_dx": 0,
                   "fused_ce_dw": 0, "fused_ce_fwd_bf16": 0,
                   "fused_ce_dx_bf16": 0, "fused_ce_dw_bf16": 0,
                   "fused_ce_fwd_bf16_tc": 1, "fused_ce_dx_bf16_tc": 1,
                   "fused_ce_dw_bf16_tc": 1,
                   # every sentence within 64 tokens: the packed backward
                   # on the tensor cores; the packed forward there at
                   # every length
                   "packed_attention_bwd": 0,
                   "packed_attention_bwd_bf16_tc": 18,
                   "packed_attention": 0, "packed_attention_bf16_tc": 18}
# the main paths, by the names run_phases gives their launch counts. The
# attention kernels' f32 and bf16 instantiations count on one wrapper's
# launches (the bf16 tensor-core kernels on their own,
# launches_bf16_tc), so their rows sum their counter over these
# paths only (a row's "paths"); other rows sum it over every path.
F32_PATHS = ("decode", "serve", "request serve", "beam serve",
             "fused beam serve", "fused beam pressure", "prefix serve",
             "decode surface", "observability serve", "brownout serve",
             "fleet serve", "pool drills", "train", "crash resume",
             "train obs", "recipe train", "train extras",
             "lifecycle serve", "lifecycle iteration", "delay train",
             "doc train", "doc decode")
BF16_PATHS = ("bf16 train", "bf16 decode", "bf16 doc cut",
              "bf16 request serve", "bf16 beam serve",
              "bf16 fused beam serve", "bf16 decode surface")
# card vs CPU in bf16, relative, each cut its own: limits set between
# the sound port's readings and those of planted faults
# (scripts/torch_train_parity.py --precision bfloat16, seeds 17 and 19;
# PERF.md section 6). Sound: base loss 2.3-3.1e-4, grad 4.4-4.6e-2,
# grad_norm 7.7-9.1e-3, update 1.6e-7; doc 7.0-8.0e-4, 2.4e-2, 2.7-2.9e-3,
# 2.4e-7; decode 6.2e-4. Faults: d not rounded and the logits cotangent
# not rounded read base loss 1.7-1.9e-3 (in the doc cut, 500 words, they
# stay within its noise); bf16 master weights read update 1 and loss
# 1.9e-3 (base), 2.4-3.5e-2 (doc); bf16 split-K reduction reads as the
# sound port (cuBLAS takes no split-K here). ``decode``: the largest step
# logit difference under teacher forcing over the largest logit.
PARITY_LIMITS_BF16 = {
    "base": {"loss": 7e-4, "grad": 9e-2, "grad_norm": 1.8e-2,
             "update": 1e-4},
    "doc": {"loss": 2e-3, "grad": 4.8e-2, "grad_norm": 6e-3,
            "update": 1e-4},
    "decode": 2.5e-3}
# doc-level training: bench.py's 'big' preset (bench.py:290-293) in its
# MARIAN_BENCH_SEQLEN=2048 stage (bench.py:303-321): transformer-big
# (dim 1024, ffn 4096, 16 heads), lines of 1,023-2,047 words, an 8,192-word
# budget, max length 2,047 cropped; f32 and dropout 0.1 as above. The
# trainer keeps its default length buckets (1,024, 1,536, 2,048).
DOC_FLAGS = ["--dim-emb", "1024", "--transformer-heads", "16",
             "--transformer-dim-ffn", "4096", "--max-length", "2047"]
DOC_WORDS, DOC_LINES, DOC_WARM, DOC_COUNTED, DOC_DOCS = 8192, 200, 2, 8, 4
# the fused CE forward's tokens at the doc shape: 8 rows of the 2,048 bucket
DOC_FWD_TOKENS = 8 * 2048
# every attention of the update runs through flash (T >= 1024)
DOC_PER_UPDATE = {"packed_attention": 0, "packed_attention_bwd": 0,
                  "flash_attention_fwd": 18, "flash_attention_dq": 18,
                  "flash_attention_dkv": 18,
                  "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
# the doc train main path trains the 2+2 cut of transformer-big at full
# width (a depth cut for the run's writes: its save, the model file the
# doc decode reads, is a third of the 6+6's): 6 attentions an update
DOC_DEPTH = ("--enc-depth", "2", "--dec-depth", "2")
DOC_PER_UPDATE_2X2 = {**DOC_PER_UPDATE, "flash_attention_fwd": 6,
                      "flash_attention_dq": 6, "flash_attention_dkv": 6}
# the doc-level card-vs-CPU cut: 2+2 layers, dim 256, 4 heads (Dh 64)
# (a gradient pass and 2 updates, 6 attentions each, all through flash:
# in bf16 the forward, dq and dkv on the tensor cores)
DOC_CUT_FLAGS = ["--dim-emb", "256", "--transformer-heads", "4",
                 "--transformer-dim-ffn", "1024", "--enc-depth", "2",
                 "--dec-depth", "2", "--max-length", "2047"]
DOC_CUT_FLASH = 18
# the serve main path (marian-server, iteration mode, greedy)
SERVE_ROWS, SERVE_SENTENCES, SERVE_CLIENTS, SERVE_CUT = 64, 256, 16, 16
# the serve model (serve_weights): its random sublayers' outputs scaled
# by COPY_SCALE, a copy head of gain COPY_GAIN whose scores resolve
# positions 0 .. COPY_POSITIONS-1 through the COPY_FREQS highest
# sinusoid frequencies (ridge COPY_RIDGE), sharpened by COPY_BETA
COPY_SCALE, COPY_GAIN, COPY_BETA = 0.2, 8.0, 6.0
COPY_POSITIONS, COPY_FREQS, COPY_RIDGE = 64, 32, 1e-4
# a served step's logits (f32, of order 1) against the dense step's on
# the same tokens on the card, and the card's engine against the CPU's:
# the sound port reads about 2e-6 in both, a paged read one position
# short 1.4e-2
SERVE_LOGIT_TOL = 1e-4
# the request-mode serve path (marian-server's defaults: request mode,
# beam 12): --mini-batch 16 makes the token budget 16 x the bucketed
# --max-length + 1 (3,072 tokens: 64 sentences of the 48-token bucket)
REQUEST_MINI_BATCH = 16
# the iteration beam path: --beam-size 6 --iteration-beam-merge host over
# the greedy serve path's 64 slots (10 sentences at once), pages of 16;
# its raw path scores against the dense beam search's on the card, f32
# (sums of up to 41 log-probs read through the paged and the dense
# attention: the sound port reads about 1e-5)
SERVE_BEAM, SERVE_BEAM_CUT, SERVE_BEAM_SCORE_TOL = 6, 8, 1e-3
# the fused beam merge (the server's default at beam > 1) and the prefix
# cache: steps a round of the multi-step runs
FUSED_STEPS = 4
# the pressured fused run: 12 slots (two sentences), a pool of 12
# full-cap rows (96 pages: the host merge never runs dry), 8 steps a
# round (a worst-case preclaim of up to 41 pages a sentence), 32
# sentences
PRESSURE_ROWS, PRESSURE_STEPS, PRESSURE_SENTENCES = 12, 8, 32
# the prefix serve paths: the first 64 served sentences, each sent twice
PREFIX_SENTENCES = 64
# the decode surface: --shortlist lex.s2t 100 20 over a table of each
# word's own copy (probability 0.9) and LEX_RANDOM random targets; a
# 40-word sentence's union is at most 100 + 40 x 20 = 900 words, below
# the engines' static K of 1,024, so no row is cut. SURFACE_SENTENCES
# of the served sentences through each check, SURFACE_CUT of them
# through the CPU and the n-best comparisons
LEX_RANDOM, SURFACE_SENTENCES, SURFACE_CUT = 19, 24, 8
# the copying serve weights of the 2+2-layer base cut, at full width: the
# model of the beam serve paths (f32 and bf16), the prefix cache, the
# decode surface, the watchdog and the lifecycle phases (a depth cut for
# the run's time: the greedy serve and request-mode paths keep the 6+6
# serve model)
SERVE_CUT_MODEL, SERVE_CUT_DEPTH = "serve_2x2.npz", 2
# the model lifecycle phases commit that cut as bundles; the trainer that
# commits B trains that depth
LIFE_DEPTH = ("--enc-depth", str(SERVE_CUT_DEPTH), "--dec-depth",
              str(SERVE_CUT_DEPTH))
# the dispatch watchdog phase: --dispatch-stall-timeout (seconds, well
# above a request-mode batch of the following requests), the requests
# served after the trip, and the longest a wedged call waits
STALL_TIMEOUT_S, STALL_FOLLOWING, STALL_WAIT_S = 4.0, 16, 120.0
# the observability serve phase: one-line requests with #trace: headers
# from SERVE_CLIENTS clients; a p99 objective no run misses, the span
# ring's capacity (every request's tree and every round's span fit)
OBS_REQUESTS, OBS_P99_MS, OBS_RING = 128, 60000.0, 16384
# the brownout serve phase (greedy, SERVE_ROWS slots, SERVE_CUT_MODEL):
# BROWNOUT_FLOOD closed-loop priority-0 clients of one sentence a request
# and BROWNOUT_HIGH priority-2 clients of BROWNOUT_HIGH_LINES sentences a
# request, each on its own connection; a shed priority-0 client waits
# BROWNOUT_BACKOFF_S before its next request. The ladder runs at hold
# 0.5 s, cool 1 s and a cap factor of BROWNOUT_CAP_FACTOR: the copying
# weights end a reply at 1x its source, under half the 3x cap, so only a
# factor below 1/3 cuts replies. The traffic stops once the ladder has
# spent BROWNOUT_TOP_S at level 3 with a shed, an eviction and a served
# priority-2 request there, or fails after BROWNOUT_TIMEOUT_S
BROWNOUT_FLOOD, BROWNOUT_HIGH, BROWNOUT_HIGH_LINES = 128, 4, 8
BROWNOUT_CAP_FACTOR, BROWNOUT_BACKOFF_S = 0.25, 0.2
BROWNOUT_TOP_S, BROWNOUT_TIMEOUT_S = 2.0, 45.0
# the fleet serve phase: tenant a the 6+6 serve model, tenant b the
# 2+2 cut of the copying weights of a second weight set (--seed + 1),
# request mode at beam 12; FLEET_SENTENCES one-line requests from
# SERVE_CLIENTS clients in three waves (a, b, a: each tenant warms on
# demand and evicts the other) and FLEET_UNKNOWN with a tag no tenant has
FLEET_B_MODEL, FLEET_SENTENCES, FLEET_UNKNOWN = "fleet_b_2x2.npz", 128, 4
# sentences of the bf16 cuts of the two serve paths
SERVE_BF16 = 64
# bf16 flash outputs carry one bf16 rounding (2^-8 relative)
BF16_REL_TOL = 1e-2
# one bf16 spacing, at most, relative to the value: a bf16 output whose
# f32 sum the kernel and its plain version take in two orders may round
# to neighbouring values
BF16_SPACING = 2.0 ** -7
# the flash lse (f32, of order log Tk) on rows with a live key, absolute
LSE_TOL = 1e-5
# the pool drills' watchdog: --dispatch-stall-timeout (seconds); the
# armed serving.translate hang is twice it
DRILL_STALL_S = 2.0
# the chaos harness phase (scripts/torch_chaos.py's kill-schedule
# config, make_config: 4 updates, a save every 2, one batch a corpus
# window, on the 2+2 cut of transformer-base at full width): the fixed
# round first (ckpt.commit=kill@2, sync: the second save dies before its
# rename), then CHAOS_KILL_ROUNDS seeded rounds of the harness at
# CHAOS_KILL_SEED (its first: ckpt.async.worker=kill@1 under
# --async-save), one --swap and one --swap --iteration round at
# CHAOS_SWAP_SEED (lifecycle.warmup; serving.quiesce) on the reference's
# tiny model
CHAOS_UPDATES, CHAOS_SAVE_FREQ, CHAOS_FIXED = 4, 2, "ckpt.commit=kill@2"
CHAOS_KILL_SEED, CHAOS_KILL_ROUNDS, CHAOS_SWAP_SEED = 159, 1, 0
CHAOS_WAIT_S = 900
# the train observability phase: OBS_TRAIN_UPDATES updates of the base
# train path a run, a display every OBS_DISP: four windows, the profiler
# on in the second (updates 3-4), its trace written in the third, the
# fourth clean
OBS_TRAIN_UPDATES, OBS_DISP = 8, 2
# the recipe phase: marian-train --task transformer-base (6+6, dim 512,
# max-length 100, --mini-batch-fit) for RECIPE_UPDATES updates on
# RECIPE_LINES synthetic lines of 1-99 words, the batch ramped over
# RECIPE_WARMUP updates; the fit searches within RECIPE_HBM_GIB of the
# card's memory (torch.cuda.set_per_process_memory_fraction), where the
# worst-case batch of the 131,072-word cap cannot fit, so the search
# crosses an out-of-memory probe. --maxi-batch 1 --mini-batch
# RECIPE_WINDOW: a window of that many sentences, so the ramp (read once
# a window) reaches the full budget within the run
RECIPE_UPDATES, RECIPE_WARMUP, RECIPE_LINES = 6, 4, 2000
RECIPE_HBM_GIB, RECIPE_WINDOW = 24, 200
RECIPE_FLAGS = ["--task", "transformer-base", "--after-batches",
                str(RECIPE_UPDATES), "--mini-batch-warmup",
                str(RECIPE_WARMUP), "--mini-batch-track-lr",
                "--dynamic-gradient-scaling", "2", "log",
                "--gradient-norm-average-window", "4", "--maxi-batch", "1",
                "--mini-batch", str(RECIPE_WINDOW), "--overwrite",
                "--seed", "1111", "--disp-freq", "1", "--quiet"]
# memory_allocated before and after the fit's search, at most apart
RECIPE_MEM_SLACK = 8 << 20
# the train extras phase (the rest of the training slice): two runs of
# marian_train at the base width (6+6), EXTRAS_UPDATES updates each and
# one save (the model file only), on the training corpus's side files
# (write_extras_data: its TSV copy, Pharaoh alignments, word weights of
# both signs, word2vec vectors of the first EXTRAS_VEC_WORDS words):
# run A with --tsv, guided alignment, gradient checkpointing,
# --output-omit-bias, depth scaling and pretrained vectors with the
# source table fixed (untied, so that each side has its table); run B
# with --right-left and train-time compression. Then the 2+2 base cut
# on the card against the CPU (the child process) for each group of
# flags in EXTRAS_CUTS, and the checkpointing A/B at the base width:
# one gradient pass and EXTRAS_AB_UPDATES timed updates each way
EXTRAS_UPDATES, EXTRAS_VEC_WORDS, EXTRAS_AB_UPDATES = 4, 2000, 3
# the base update's packed forward launches that checkpointing repeats:
# 6 encoder self, 6 decoder self and 6 cross attentions, each
# checkpointed layer's forward once more in the backward
EXTRAS_RECOMPUTED = 18
# the port's kernels of rows 2, 3 and 7-9 (by their kernel-line names)
# as the profiler trace names them: substrings of the CUDA kernels each
# row's wrapper launches on the f32 base update
TRACE_KERNELS = {
    "packed_attention": ("packed_attention_fwd_kernel",
                         "packed_attention_generic_kernel"),
    "packed_attention_bwd": ("packed_attention_bwd",),
    "fused_ce_fwd": ("fce_fwd_kernel",),
    "fused_ce_dx": ("fce_bwd_dx_kernel",),
    "fused_ce_dw": ("fce_bwd_dw_kernel",)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the launches queue up behind a device
    sleep, so host-side launch cost does not show between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """The least time (ms) for the bytes at the HBM rate and the
    operations at ``peak`` (the card's rate for the operands' type), and
    which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close_bf16(got, ref, what: str, rel: float = REL_TOL) -> float:
    """A bf16 output against its plain version, which rounds its own f32
    sum: |got - ref| within one bf16 spacing of ref (at most 2^-7 of it)
    plus rel * max(1, max |ref|); returns max |got - ref|."""
    check(got.dtype == ref.dtype == torch.bfloat16,
          f"{what}: {got.dtype} against {ref.dtype}")
    got, ref = got.detach().float(), ref.detach().float()
    scale = max(float(ref.abs().max()), 1.0)
    over = float(((got - ref).abs() - BF16_SPACING * ref.abs()).max())
    check(over <= rel * scale, f"{what}: |err| exceeds one bf16 spacing by "
          f"{over:.3g} > {rel} x scale {scale:.3g}")
    return float((got - ref).abs().max())


def close_to_scale(got, ref, what: str, rel: float = REL_TOL) -> float:
    """max |got - ref|, checked against rel * max(1, max |ref|)."""
    got, ref = got.detach().float(), ref.detach().float()
    err = float((got - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    check(err <= rel * scale, f"{what}: max |err| {err:.3g} > "
          f"{rel} x scale {scale:.3g}")
    return err


def lse_err(lse, ref, what: str) -> float:
    """The flash forward's lse against the plain version's: rows with a
    live key (lse of order log Tk) within LSE_TOL, fully masked rows
    (-1e9) equal; returns the live rows' max |err|."""
    from marian_tpu_torch.ops.ops import NEG_INF
    live = ref > 0.5 * NEG_INF
    check(bool(live.any()), f"{what}: no row has a live key")
    err = float((lse[live] - ref[live]).abs().max())
    check(err <= LSE_TOL, f"{what}: max |err| {err:.3g} > {LSE_TOL} on rows "
          f"with a live key")
    check(torch.equal(lse[~live], ref[~live]),
          f"{what}: fully masked rows differ from the plain version")
    return err


def top_kernel(fn) -> str:
    """The name of the device kernel that takes most of one call of
    ``fn`` (which backend a library call picked), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not events:
        return "not traced"
    return max(events, key=lambda e: e.self_device_time_total).key[:80]


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    from marian_tpu_torch.ops.kernels import _build
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    t0 = time.time()
    took = _build.build_all()
    each = ", ".join(f"{n} {t:.1f} s" for n, t in took.items())
    flash = [line for line in _build.USAGE.get("flash_attention_bf16", [])
             if line.startswith("flash_tc_")]
    packed = [line for line in _build.USAGE.get("packed_attention_bf16", [])
              if line.startswith("packed_tc_")]
    print(f"build: {each or 'nothing to build'}; {time.time() - t0:.1f} s "
          f"in all, one nvcc a library in parallel "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}); ptxas -v of the fused CE's "
          f"tensor-core kernels (dynamic shared memory "
          f"{fce.TC_SMEM_BYTES} B each): " + "; ".join(
              line for line in _build.USAGE.get("fused_ce_bf16", [])
              if "fce_tc_" in line)
          + "; of the flash tensor-core kernels: " + "; ".join(flash)
          + "; of the packed tensor-core forward and backward: "
          + "; ".join(packed))
    # the attention tensor-core kernels: every instance built here (the
    # flash forward, dq and dkv, the packed backward, at Dh 16, 32, 64
    # and 128; the packed forward at those and 32 or 64 query rows), none
    # spills
    for lib, lines, n in (("flash_attention_bf16", flash, 12),
                          ("packed_attention_bf16", packed, 12)):
        if lib in took:
            spill = [line for line in lines if "0 bytes spill stores, 0 "
                     "bytes spill loads" not in line]
            check(len(lines) == n and not spill,
                  f"{lib} tensor-core kernels: {len(lines)} of {n} "
                  f"instances, spills: {spill}")


def phase_decode_kernel(gen) -> dict:
    from marian_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    dev = torch.device("cuda")
    r, h, L, dh = BATCH * BEAM, 8, 64, 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    q, kn, vn = randn(r, h, 1, dh), randn(r, h, 1, dh), randn(r, h, 1, dh)
    ck, cv = randn(r, h, L, dh), randn(r, h, L, dh)
    beams = (torch.arange(BATCH)[:, None] * BEAM
             + torch.randint(0, BEAM, (BATCH, BEAM), generator=gen))
    beam_src = beams.reshape(-1).to(torch.int32).to(dev)
    repeats = torch.randint(0, r, (r,), generator=gen).to(torch.int32).to(dev)
    rows_pos = torch.randint(0, L, (r,), generator=gen)
    rows_pos[0], rows_pos[1] = 0, L - 1
    cases = [("repeats, pos 0", repeats, 0),
             ("repeats, pos L-1", repeats, L - 1),
             ("beam rows, per-row pos", beam_src, rows_pos.to(torch.int32).to(dev)),
             ("identity, pos 31", None, 31)]
    err = 0.0
    for name, src, pos in cases:
        out, nk, nv = decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
        ro, rk, rv = decode_attention_reference(q, kn, vn, ck, cv, pos, src)
        torch.cuda.synchronize()
        e = (out - ro).abs().max().item()
        check(e <= TOL, f"decode_attention [{name}] max |err| {e} > {TOL}")
        check(torch.equal(nk, rk) and torch.equal(nv, rv),
              f"decode_attention [{name}] caches differ from the plain version")
        err = max(err, e)
        print(f"kernel decode_attention [{name}]: max |err| {e:.3g}, caches "
              f"exact")
    err = max(err, decode_edge_cases(gen, dev))
    bk, bv = torch.empty_like(ck), torch.empty_like(cv)
    pos_t = torch.full((r,), L - 1, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: decode_attention(q, kn, vn, ck, cv, pos_t,
                                          src_rows=beam_src, out_k=bk,
                                          out_v=bv))
    plain_ms = time_ms(lambda: decode_attention_reference(
        q, kn, vn, ck, cv, pos_t, beam_src))
    gk = ck.index_select(0, beam_src.long())
    gv = cv.index_select(0, beam_src.long())
    live = torch.ones((r, 1, 1, L), dtype=torch.bool, device=dev)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, gk, gv, attn_mask=live))
    uniq = int(torch.unique(beam_src).numel())
    tile = h * L * dh * 4
    nbytes = 2 * uniq * tile + 2 * r * tile + 4 * r * h * dh * 4 + 2 * r * 4
    flops = 4 * r * h * L * dh
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel decode_attention R={r} H={h} L={L} Dh={dh} f32: kernel_ms "
          f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa, attention only) "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({nbytes / 1e6:.1f} MB)")
    # document-length caches (past the old 442-position cap) at the doc
    # decode's rows: 8 rows (4 documents padded) x beam 6, 16 heads
    docs = 8
    r2, h2 = docs * BEAM, 16
    beams2 = (torch.arange(docs)[:, None] * BEAM
              + torch.randint(0, BEAM, (docs, BEAM), generator=gen))
    src2 = beams2.reshape(-1).to(torch.int32).to(dev)
    for L2 in (1024, 2048):
        q2, kn2, vn2 = (randn(r2, h2, 1, dh) for _ in range(3))
        ck2, cv2 = randn(r2, h2, L2, dh), randn(r2, h2, L2, dh)
        pos2 = torch.randint(0, L2, (r2,), generator=gen)
        pos2[0], pos2[1], pos2[2] = 0, L2 - 1, 700
        pos2 = pos2.to(torch.int32).to(dev)
        out, nk, nv = decode_attention(q2, kn2, vn2, ck2, cv2, pos2,
                                       src_rows=src2)
        ro, rk, rv = decode_attention_reference(q2, kn2, vn2, ck2, cv2,
                                                pos2, src2)
        torch.cuda.synchronize()
        e = (out - ro).abs().max().item()
        check(e <= TOL, f"decode_attention L={L2} max |err| {e} > {TOL}")
        check(torch.equal(nk, rk) and torch.equal(nv, rv),
              f"decode_attention L={L2}: caches differ from the plain "
              f"version")
        err = max(err, e)
        print(f"kernel decode_attention [beam rows, per-row pos] R={r2} "
              f"H={h2} L={L2} Dh={dh}: max |err| {e:.3g}, caches exact")
        if L2 == 1024:          # the doc decode's cache (0.5 x 2,048)
            pos_t2 = torch.full((r2,), L2 - 1, dtype=torch.int32, device=dev)
            bk2, bv2 = torch.empty_like(ck2), torch.empty_like(cv2)
            ms2 = time_ms(lambda: decode_attention(
                q2, kn2, vn2, ck2, cv2, pos_t2, src_rows=src2, out_k=bk2,
                out_v=bv2))
            plain2 = time_ms(lambda: decode_attention_reference(
                q2, kn2, vn2, ck2, cv2, pos_t2, src2), iters=5)
            gk2 = ck2.index_select(0, src2.long())
            gv2 = cv2.index_select(0, src2.long())
            live2 = torch.ones((r2, 1, 1, L2), dtype=torch.bool, device=dev)
            lib2 = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q2, gk2, gv2, attn_mask=live2))
            del gk2, gv2
            uniq2 = int(torch.unique(src2).numel())
            tile2 = h2 * L2 * dh * 4
            nb2 = (2 * uniq2 * tile2 + 2 * r2 * tile2 + 4 * r2 * h2 * dh * 4
                   + 2 * r2 * 4)
            b2, _ = bound(nb2, 4 * r2 * h2 * L2 * dh)
            print(f"kernel decode_attention R={r2} H={h2} L={L2} Dh={dh} "
                  f"f32 (doc decode): kernel_ms {ms2:.4f} plain_ms "
                  f"{plain2:.4f} library_ms(sdpa, attention only) "
                  f"{lib2:.4f} bound_ms {b2:.4f} ({nb2 / 1e6:.1f} MB)")
            del bk2, bv2
        del q2, kn2, vn2, ck2, cv2, out, nk, nv, ro, rk, rv
    return {"name": "decode_attention", "route": "cuda",
            "source": "marian_tpu_torch/csrc/decode_attention.cu",
            "replaces": "marian_tpu/ops/pallas/decode_attention.py:117",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "paths": F32_PATHS}


def decode_edge_cases(gen, dev) -> float:
    """decode_attention at the shapes its launcher routes apart, against
    the plain version (context within TOL, bf16 queries within
    BF16_REL_TOL of scale, caches exact), each also called twice for the
    same bits: a length that is not a multiple of a chunk, Dh 30 and Dh
    20 with bf16 caches (the scalar kernel), Dh 256, bf16 queries, pos -1
    (every position masked) and past L, and one document at beam 6 (R 6,
    H 16, L 1,024: few blocks, a long cache). Returns the max
    |err| of the f32 contexts."""
    from marian_tpu_torch.ops.kernels import decode_attention as da
    err = 0.0
    for name, r, h, L, dh, qd, cd in (
            ("L 77", 12, 8, 77, 64, torch.float32, torch.float32),
            ("scalar Dh 30", 12, 4, 100, 30, torch.float32, torch.float32),
            ("scalar Dh 20 bf16 caches", 12, 4, 100, 20, torch.float32,
             torch.bfloat16),
            ("Dh 256", 6, 2, 90, 256, torch.float32, torch.float32),
            ("bf16 queries and caches", 12, 8, 64, 64, torch.bfloat16,
             torch.bfloat16),
            ("one document", BEAM, 16, 1024, 64, torch.float32,
             torch.float32)):
        q, kn, vn = (torch.randn(r, h, 1, dh, generator=gen).to(dev, qd)
                     for _ in range(3))
        ck, cv = (torch.randn(r, h, L, dh, generator=gen).to(dev, cd)
                  for _ in range(2))
        src = torch.randint(0, r, (r,), generator=gen).to(dev, torch.int32)
        pos = torch.randint(0, L, (r,), generator=gen)
        pos[0], pos[1], pos[2] = -1, L + 7, L - 1
        pos = pos.to(dev, torch.int32)
        vector = da.vector_path(dh, ck.element_size())
        got = da.decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
        again = da.decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
        ro, rk, rv = da.decode_attention_reference(q, kn, vn, ck, cv, pos,
                                                   src)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"decode_attention [{name}]: two calls differ")
        check(torch.equal(got[1], rk) and torch.equal(got[2], rv),
              f"decode_attention [{name}]: caches differ from the plain "
              f"version")
        if qd == torch.float32:
            e = (got[0] - ro).abs().max().item()
            check(e <= TOL, f"decode_attention [{name}] max |err| {e} > "
                  f"{TOL}")
            err = max(err, e)
        else:
            e = close_to_scale(got[0], ro, f"decode_attention [{name}]",
                               BF16_REL_TOL)
        print(f"kernel decode_attention [{name}] R={r} H={h} L={L} Dh={dh} "
              f"{'vector' if vector else 'scalar'} kernel, "
              f"pos -1, past L, L-1 and random: max |err| "
              f"{e:.3g}, caches exact, two calls bit-identical")
    return err


def phase_packed_kernel(gen) -> dict:
    """The forward against its plain version: at the decode encoder's
    shape and lengths around it, at one tile pair and past it (64, 65,
    128 and the routing cap, 428, keys), at 20 queries (32-query tiles)
    against 90 keys, at Dh 48 (the generic kernel),
    causal and cross, each with a fully masked row and, past 128 keys, a
    row whose first live key lies inside a tile; two calls of each give
    the same bits. Then its times: at the decode encoder's shape (the
    kernel line) and at base training's (B 192, H 8, T 64: self, causal,
    cross 64 x 48), each beside SDPA's and the bound."""
    from marian_tpu_torch.ops.kernels.packed_attention import (
        fwd_query_tile, max_t, packed_attention, packed_attention_reference)
    dev = torch.device("cuda")
    b, h, dh = BATCH, 8, 64
    err = 0.0
    cap = max_t(dh)
    for bb, hh, tq, tk, d, causal in (
            (b, h, SRC_LEN, SRC_LEN, dh, False), (b, h, 50, 50, dh, False),
            (b, h, 50, 50, dh, True), (16, h, 64, 64, dh, True),
            (16, h, 65, 65, dh, True), (16, h, 40, 65, dh, False),
            (8, h, 128, 128, dh, False), (4, h, cap, cap, dh, True),
            (4, h, 100, cap, dh, False), (16, h, 20, 90, dh, True),
            (16, h, 70, 50, 48, True)):
        q = torch.randn(bb, hh, tq, d, generator=gen).to(dev)
        k, v = (torch.randn(bb, hh, tk, d, generator=gen).to(dev)
                for _ in range(2))
        lens = torch.randint(1, tk + 1, (bb,), generator=gen)
        lens[0] = tk
        kvm = (torch.arange(tk)[None, :] < lens[:, None]).float()
        kvm[1] = 0.0                                  # a fully-masked row
        if tk > 128:
            kvm[2, :70] = 0.0
        kvm = kvm.to(dev)
        out = packed_attention(q, k, v, kvm, causal=causal)
        again = packed_attention(q, k, v, kvm, causal=causal)
        ref = packed_attention_reference(q, k, v, kvm, causal=causal)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"packed_attention Tq={tq} Tk={tk} "
              f"Dh={d} causal={causal}: two calls differ")
        e = (out - ref).abs().max().item()
        check(e <= TOL, f"packed_attention Tq={tq} Tk={tk} Dh={d} "
              f"causal={causal} max |err| {e} > {TOL}")
        err = max(err, e)
        print(f"kernel packed_attention B={bb} H={hh} Tq={tq} Tk={tk} Dh={d} "
              f"causal={causal} (query tile {fwd_query_tile(d, tq)}, 0: the "
              f"generic kernel): max |err| {e:.3g}, two calls "
              f"bit-identical")

    def fwd_bound(b, tq, tk, causal):
        """Reads q, k, v and the key mask and writes out; 4 flops a
        feature of each live (query, key) pair."""
        pairs = b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                         else tq * tk)
        return bound((2 * tq + 2 * tk) * b * h * dh * 4 + b * tk * 4,
                     4 * pairs * dh)

    def sdpa_ms(q, k, v, kvm, causal):
        mask = (torch.ones(q.shape[2], k.shape[2], device=dev).tril().bool()
                if causal else kvm.bool()[:, None, None, :])
        return time_ms(lambda: torch.nn.functional
                       .scaled_dot_product_attention(q, k, v,
                                                     attn_mask=mask))

    t = SRC_LEN
    q, k, v = (torch.randn(b, h, t, dh, generator=gen).to(dev)
               for _ in range(3))
    kvm = torch.ones(b, t, device=dev)
    ms = time_ms(lambda: packed_attention(q, k, v, kvm))
    plain_ms = time_ms(lambda: packed_attention_reference(q, k, v, kvm))
    library_ms = sdpa_ms(q, k, v, kvm, False)
    bound_ms, bound_by = fwd_bound(b, t, t, False)
    nbytes = 4 * b * h * t * dh * 4 + b * t * 4
    print(f"kernel packed_attention B={b} H={h} T={t} Dh={dh} f32: kernel_ms "
          f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa) {library_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({nbytes / 1e6:.1f} MB)")
    # base training's attentions: the rows of a 12,288-token batch
    for tq, tk, causal in ((64, 64, False), (64, 64, True), (64, 48, False)):
        bt = 12288 // tq
        q = torch.randn(bt, h, tq, dh, generator=gen).to(dev)
        k, v = (torch.randn(bt, h, tk, dh, generator=gen).to(dev)
                for _ in range(2))
        kvm = torch.ones(bt, tk, device=dev)
        t_ms = time_ms(lambda: packed_attention(q, k, v, kvm, causal=causal))
        lib = sdpa_ms(q, k, v, kvm, causal)
        bm, by = fwd_bound(bt, tq, tk, causal)
        print(f"kernel packed_attention B={bt} H={h} Tq={tq} Tk={tk} Dh={dh} "
              f"causal={causal} f32 (training): kernel_ms {t_ms:.4f} "
              f"library_ms(sdpa) {lib:.4f} bound_ms {bm:.4f} ({by}, live "
              f"pairs)")
    return {"name": "packed_attention", "route": "cuda",
            "source": "marian_tpu_torch/csrc/packed_attention.cu",
            "replaces": "marian_tpu/ops/pallas/packed_attention.py:197",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "paths": F32_PATHS}


def phase_packed_bwd_kernel(gen):
    """The backward against its plain version at the training path's
    shapes (the rows of a 12,288-token batch: B 192 at T 64) and, in its
    tiled form, at T 200 and 256, where the dispatcher now takes it; the
    forward that feeds it ``out`` is held against its own plain version
    there too, and two backward calls must give the same bits. Then its
    times: at T 64 self (the kernel line), causal and cross, and at T 256
    against SDPA's backward and the dense path's, which the dispatcher
    took there before. Returns (backward row, forward max |err|)."""
    from marian_tpu_torch.ops import attention as att
    from marian_tpu_torch.ops.kernels.packed_attention import (
        packed_attention, packed_attention_bwd,
        packed_attention_bwd_reference, packed_attention_reference)
    dev = torch.device("cuda")
    h, dh, tokens = 8, 64, 12288
    err = fwd_err = 0.0

    def inputs(tq, tk, live=True):
        b = tokens // max(tq, tk)
        q, do = (torch.randn(b, h, tq, dh, generator=gen).to(dev)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tk, dh, generator=gen).to(dev)
                for _ in range(2))
        lens = torch.randint(1, tk + 1, (b,), generator=gen)
        lens[0] = tk
        kvm = (torch.arange(tk)[None, :] < lens[:, None]).float()
        kvm[1] = 0.0                                  # a fully-masked row
        if live:
            kvm.fill_(1.0)
        return q, k, v, do, kvm.to(dev)

    for tq, tk, causal in ((64, 64, False), (64, 64, True), (64, 48, False),
                           (200, 200, True), (256, 256, False)):
        q, k, v, do, kvm = inputs(tq, tk, live=False)
        b = q.shape[0]
        out = packed_attention(q, k, v, kvm, causal=causal)
        got = packed_attention_bwd(q, k, v, kvm, do, out, causal)
        again = packed_attention_bwd(q, k, v, kvm, do, out, causal)
        ref = packed_attention_bwd_reference(q, k, v, kvm, do, out, causal)
        plain_out = packed_attention_reference(q, k, v, kvm, causal=causal)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"packed_attention_bwd Tq={tq} Tk={tk} causal={causal}: two "
              f"calls differ")
        e = (out - plain_out).abs().max().item()
        check(e <= TOL, f"packed_attention B={b} Tq={tq} Tk={tk} "
              f"causal={causal} max |err| {e} > {TOL}")
        fwd_err = max(fwd_err, e)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = max(err, close_to_scale(
                g, r, f"packed_attention_bwd Tq={tq} Tk={tk} causal={causal} "
                f"{name}"))
        print(f"kernel packed_attention_bwd B={b} H={h} Tq={tq} Tk={tk} "
              f"Dh={dh} causal={causal}: max |err| {err:.3g} (tolerance "
              f"{REL_TOL} x max |plain|), two calls bit-identical; its "
              f"forward: max |err| {e:.3g}")

    def packed_bound(b, tq, tk, causal):
        """Reads q, dO, k, v, the key mask and delta and writes dq, dk,
        dv; 10 flops a feature of each live (query, key) pair."""
        pairs = b * h * (sum(min(i + 1, tk) for i in range(tq)) if causal
                         else tq * tk)
        return bound((3 * tq + 4 * tk) * b * h * dh * 4 + b * tk * 4
                     + b * h * tq * 4, 10 * pairs * dh)

    def timed(tq, tk, causal):
        q, k, v, do, kvm = inputs(tq, tk)
        out = packed_attention(q, k, v, kvm, causal=causal)
        ms = time_ms(lambda: packed_attention_bwd(q, k, v, kvm, do, out,
                                                  causal))
        return (q, k, v, do, kvm, out), ms

    (q, k, v, do, kvm, out), ms = timed(64, 64, False)
    b = q.shape[0]
    plain_ms = time_ms(lambda: packed_attention_bwd_reference(
        q, k, v, kvm, do, out))
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=kvm.bool()[:, None, None, :])
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    bound_ms, bound_by = packed_bound(b, 64, 64, False)
    flops = 10 * b * h * 64 * 64 * dh
    print(f"kernel packed_attention_bwd B={b} H={h} T=64 Dh={dh} f32: "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa "
          f"backward) {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{flops / 1e9:.2f} GFLOP, {flops / ms / 1e9:.2f} TFLOP/s)")
    row = {"name": "packed_attention_bwd", "route": "cuda",
           "source": "marian_tpu_torch/csrc/packed_attention.cu",
           "replaces": "marian_tpu/ops/pallas/packed_attention.py:214",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "paths": F32_PATHS}
    del q, k, v, do, kvm, out, ql, kl, vl, lib_out
    for tq, tk, causal in ((64, 64, True), (64, 48, False)):
        (q, *_), ms = timed(tq, tk, causal)
        bm, by = packed_bound(q.shape[0], tq, tk, causal)
        print(f"kernel packed_attention_bwd B={q.shape[0]} H={h} Tq={tq} "
              f"Tk={tk} Dh={dh} causal={causal} f32: kernel_ms {ms:.4f} "
              f"bound_ms {bm:.4f} ({by}, live pairs)")
    # T 256: the kernel's tiled form against SDPA's backward and the
    # dense path's, which the dispatcher took there before the cap rose
    (q, k, v, do, kvm, out), ms = timed(256, 256, False)
    b = q.shape[0]
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
    mask = kvm[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask.bool())
    lib_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True), iters=10)
    dense_out, _ = att.dense_attention_with_weights(ql, kl, vl, mask,
                                                    False)
    dense_ms = time_ms(lambda: torch.autograd.grad(
        dense_out, (ql, kl, vl), do, retain_graph=True), iters=10)
    bm, by = packed_bound(b, 256, 256, False)
    flops = 10 * b * h * 256 * 256 * dh
    print(f"kernel packed_attention_bwd B={b} H={h} T=256 Dh={dh} f32 "
          f"(tiled): kernel_ms {ms:.4f} library_ms(sdpa backward) "
          f"{lib_ms:.4f} dense_path_backward_ms {dense_ms:.4f} bound_ms "
          f"{bm:.4f} ({by}; {flops / ms / 1e9:.2f} TFLOP/s)")
    return row, fwd_err


def phase_fused_ce_kernels(gen) -> list:
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    dev = torch.device("cuda")

    def inputs(n, v, e):
        """The first labels on the forward's tile edges (columns 0, 255,
        256 and V - 1)."""
        x = torch.randn(n, e, generator=gen).to(dev)
        w = (torch.randn(v, e, generator=gen) * e ** -0.5).to(dev)
        b = torch.randn(v, generator=gen).to(dev)
        labels = torch.randint(0, v, (n,), generator=gen)
        edges = [c for c in (0, 255, 256, v - 1) if c < v]
        labels[:len(edges)] = torch.tensor(edges)
        return x, w, b, labels.to(dev)

    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    # ragged N and V (V under one 256-column tile, one column in the last
    # tile), E not a multiple of 4 (scalar loads); E = 1024
    # (transformer-big) in two passes; the last case is the main path's N,
    # V and E, kept for the timings below
    for n, v, e in ((70, 200, 50), (130, 257, 64), (133, 513, 1024),
                    (4096, VOCAB, 512), (4001, VOCAB + 3, 512),
                    (2048, VOCAB + 3, 1024), (TRAIN_WORDS, VOCAB, 512)):
        x, w, b, labels = inputs(n, v, e)
        got = fce.fused_ce_stats(x, w, b, labels)
        ref = fce.fused_ce_stats_reference(x, w, b, labels)
        g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
        dx = fce.fused_ce_dx(x, w, b, labels, ref[0], *g)
        dw, db = fce.fused_ce_dw(x, w, b, labels, ref[0], *g)
        rdx, rdw, rdb = fce.fused_ce_bwd_reference(x, w, b, labels, ref[0],
                                                   *g)
        torch.cuda.synchronize()
        what = f"N={n} V={v} E={e}"
        for name, a, r in zip(("lse", "lab", "tot"), got, ref):
            errs["fwd"] = max(errs["fwd"], close_to_scale(
                a, r, f"fused_ce_fwd {what} {name}"))
        errs["dx"] = max(errs["dx"], close_to_scale(dx, rdx,
                                                   f"fused_ce_dx {what}"))
        errs["dw"] = max(errs["dw"], close_to_scale(dw, rdw,
                                                   f"fused_ce_dw {what}"),
                         close_to_scale(db, rdb, f"fused_ce_db {what}"))
        print(f"kernel fused_ce {what}: max |err| fwd {errs['fwd']:.3g} dx "
              f"{errs['dx']:.3g} dw/db {errs['dw']:.3g} (tolerance "
              f"{REL_TOL} x max |plain| of each output)")
        lse = ref[0]
        if (n, v) == (4001, VOCAB + 3):
            # the joint backward over forced narrow chunks at ragged N:
            # 11 chunks, the last one ragged
            jdx, jdw, jdb = fce.fused_ce_bwd(x, w, b, labels, lse, *g,
                                             chunk=FORCED_CHUNK)
            errs["dx"] = max(errs["dx"], close_to_scale(
                jdx, rdx, f"fused_ce_bwd {what} chunk {FORCED_CHUNK} dx"))
            errs["dw"] = max(errs["dw"], close_to_scale(
                jdw, rdw, f"fused_ce_bwd {what} chunk {FORCED_CHUNK} dw"),
                close_to_scale(jdb, rdb,
                               f"fused_ce_bwd {what} chunk {FORCED_CHUNK} db"))
            print(f"kernel fused_ce_bwd {what}, chunks of {FORCED_CHUNK}: "
                  f"{len(fce.vocab_chunks(n, v, FORCED_CHUNK))} chunks, "
                  f"within tolerance")
            del jdx, jdw, jdb
        del got, ref, dx, dw, db, rdx, rdw, rdb
    torch.cuda.empty_cache()
    # the same inputs twice: bit-identical lse, lab, tot and dx, dw, db
    one = fce.fused_ce_stats(x, w, b, labels)
    two = fce.fused_ce_stats(x, w, b, labels)
    check(all(torch.equal(p, q) for p, q in zip(one, two)),
          "fused_ce_fwd: two calls on the same inputs differ")
    print(f"kernel fused_ce_fwd N={n} V={v} E={e}: two calls bit-identical "
          f"(lse, lab, tot)")
    one = fce.fused_ce_bwd(x, w, b, labels, lse, *g)
    two = fce.fused_ce_bwd(x, w, b, labels, lse, *g)
    check(all(torch.equal(p, q) for p, q in zip(one, two)),
          "fused_ce_bwd: two calls on the same inputs differ")
    print(f"kernel fused_ce_bwd N={n} V={v} E={e}: two calls bit-identical "
          f"(dx, dw, db)")
    del one, two
    torch.cuda.empty_cache()
    times = {
        "fwd": (lambda: fce.fused_ce_stats(x, w, b, labels),
                lambda: fce.fused_ce_stats_reference(x, w, b, labels)),
        "dx": (lambda: fce.fused_ce_dx(x, w, b, labels, lse, *g),
               lambda: torch.matmul(fce.dlogits_reference(
                   x, w, b, labels, lse, *g), w)),
        "dw": (lambda: fce.fused_ce_dw(x, w, b, labels, lse, *g),
               lambda: (lambda d: (torch.matmul(d.t(), x), d.sum(0)))(
                   fce.dlogits_reference(x, w, b, labels, lse, *g))),
    }
    xl, wl, bl = (t.clone().requires_grad_(True) for t in (x, w, b))

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            torch.nn.functional.linear(xl, wl, bl), labels,
            label_smoothing=0.1, reduction="sum")
    lib_loss = lib_fwd()
    lib_fwd_ms = time_ms(lib_fwd, iters=5)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_loss, (xl, wl, bl), retain_graph=True), iters=5)
    del lib_loss
    flops = {"fwd": 2 * n * v * e, "dx": 4 * n * v * e, "dw": 4 * n * v * e}
    io_in = (n * e + v * e + v) * 4 + n * 4
    # the joint backward: three products; bytes: the inputs, the outputs
    # and the d scratch written once and read twice (dx and dw products)
    joint_ms = time_ms(lambda: fce.fused_ce_bwd(x, w, b, labels, lse, *g),
                       iters=5)
    joint_flops = 6 * n * v * e
    joint_bytes = (io_in + 4 * n * 4 + (n * e + v * e + v) * 4
                   + 3 * n * v * 4)
    joint_bound, joint_by = bound(joint_bytes, joint_flops)
    print(f"kernel fused_ce_bwd (joint: dx, dw, db) N={n} V={v} E={e} f32: "
          f"kernel_ms {joint_ms:.4f} library_ms (backward of linear + "
          f"cross_entropy, two calls) {lib_bwd_ms:.4f} bound_ms "
          f"{joint_bound:.4f} ({joint_by}; {joint_flops / 1e9:.0f} GFLOP, "
          f"{joint_bytes / 1e9:.2f} GB, {joint_flops / joint_ms / 1e9:.2f} "
          f"TFLOP/s achieved)")
    product_times(fce, x, w, b, labels, lse, g)
    fwd_times(fce, x, w, b, labels)
    nbytes = {"fwd": io_in + 3 * n * 4, "dx": io_in + 4 * n * 4 + n * e * 4,
              "dw": io_in + 4 * n * 4 + (v * e + v) * 4}
    rows = []
    for part, line in (("fwd", 205), ("dx", 233), ("dw", 233)):
        ms = time_ms(times[part][0], iters=5)
        plain_ms = time_ms(times[part][1], iters=5)
        library_ms = lib_fwd_ms if part == "fwd" else lib_bwd_ms
        bound_ms, bound_by = bound(nbytes[part], flops[part])
        print(f"kernel fused_ce_{part} N={n} V={v} E={e} f32: kernel_ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{'(linear + cross_entropy, two calls)' if part == 'fwd' else '(backward of linear + cross_entropy, two calls)'} "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"{flops[part] / 1e9:.0f} GFLOP, "
              f"{flops[part] / ms / 1e9:.2f} TFLOP/s achieved)")
        rows.append({"name": f"fused_ce_{part}", "route": "cuda",
                     "source": "marian_tpu_torch/csrc/fused_ce.cu",
                     "replaces": f"marian_tpu/ops/pallas/fused_ce.py:{line}",
                     "max_abs_err": errs[part], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    del x, w, b, labels, g, lse, xl, wl, bl
    torch.cuda.empty_cache()
    doc = inputs(DOC_FWD_TOKENS, VOCAB, 1024)
    got = fce.fused_ce_stats(*doc)
    for name, a, r in zip(("lse", "lab", "tot"), got,
                          fce.fused_ce_stats_reference(*doc)):
        close_to_scale(a, r, f"fused_ce_fwd doc shape {name}")
    del got
    torch.cuda.empty_cache()
    fwd_times(fce, *doc, library=True)
    return rows


def phase_fused_ce_kernels_bf16(gen) -> list:
    """The fused CE's bf16 instantiations (x and w bf16, b f32) against
    their plain versions on the same bf16 operands, at ragged shapes, the
    main path's (N 12,288, V 32,000, E 512) and the doc shape's (N
    16,384, E 1,024): lse, lab, tot and db (f32) within REL_TOL of the
    largest, dx and dw (bf16) within one bf16 spacing of the plain
    version's; two calls bit-identical; times beside the bound (bf16
    operand bytes, operations at the card's bf16 peak, the tensor cores'
    rate: the least time for this work on bf16 operands; the bound at the
    f32 CUDA-core peak rides along as bound_ms_f32_peak) and F.linear on
    bf16 + F.cross_entropy. The forward and the backward take the
    tensor-core kernels at E % 8 == 0 (every shape here but E 50, which
    keeps the CUDA-core ones): each shape's line names the paths its
    counters show."""
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    dev, bf = torch.device("cuda"), torch.bfloat16

    def inputs(n, v, e):
        x = torch.randn(n, e, generator=gen).to(dev, bf)
        w = (torch.randn(v, e, generator=gen) * e ** -0.5).to(dev, bf)
        b = torch.randn(v, generator=gen).to(dev)
        labels = torch.randint(0, v, (n,), generator=gen)
        edges = [c for c in (0, 255, 256, v - 1) if c < v]
        labels[:len(edges)] = torch.tensor(edges)
        return x, w, b, labels.to(dev)

    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    for n, v, e, chunk in ((70, 200, 50, None), (133, 513, 1024, None),
                           (4001, VOCAB + 3, 512, FORCED_CHUNK),
                           (DOC_FWD_TOKENS, VOCAB, 1024, None),
                           (TRAIN_WORDS, VOCAB, 512, None)):
        x, w, b, labels = inputs(n, v, e)
        path = "tensor cores" if e % 8 == 0 else "CUDA cores"
        before = bf16_paths(fce.fused_ce_stats)
        got = fce.fused_ce_stats(x, w, b, labels)
        took = {k: c - before[k]
                for k, c in bf16_paths(fce.fused_ce_stats).items()}
        check(took == {"tensor cores": int(e % 8 == 0),
                       "CUDA cores": int(e % 8 != 0)},
              f"fused_ce_fwd N={n} V={v} E={e} bf16: launches {took}, "
              f"expected the {path} path")
        ref = fce.fused_ce_stats_reference(x, w, b, labels)
        g = [torch.randn(n, generator=gen).to(dev) for _ in range(3)]
        bwd = (fce.fused_ce_dx, fce.fused_ce_dw)
        before = bf16_paths(*bwd)
        dx, dw, db = fce.fused_ce_bwd(x, w, b, labels, ref[0], *g,
                                      chunk=chunk)
        took = {k: c - before[k] for k, c in bf16_paths(*bwd).items()}
        check(took == {"tensor cores": 2 if e % 8 == 0 else 0,
                       "CUDA cores": 0 if e % 8 == 0 else 2},
              f"fused_ce_bwd N={n} V={v} E={e} bf16: launches {took}, "
              f"expected the {path} path")
        rdx, rdw, rdb = fce.fused_ce_bwd_reference(x, w, b, labels, ref[0],
                                                   *g)
        torch.cuda.synchronize()
        what = (f"N={n} V={v} E={e} bf16"
                + (f", chunks of {chunk}" if chunk else "")
                + f", forward and backward on the {path}")
        for name, a, r in zip(("lse", "lab", "tot"), got, ref):
            errs["fwd"] = max(errs["fwd"], close_to_scale(
                a, r, f"fused_ce_fwd {what} {name}"))
        errs["dx"] = max(errs["dx"], close_bf16(dx, rdx,
                                                f"fused_ce_dx {what}"))
        errs["dw"] = max(errs["dw"], close_bf16(dw, rdw,
                                                f"fused_ce_dw {what}"),
                         close_to_scale(db, rdb, f"fused_ce_db {what}"))
        print(f"kernel fused_ce {what}: max |err| fwd {errs['fwd']:.3g} dx "
              f"{errs['dx']:.3g} dw/db {errs['dw']:.3g} (f32 outputs: "
              f"{REL_TOL} x max |plain|; bf16 dx, dw: one bf16 spacing + "
              f"that); dx {dx.dtype}, dw {dw.dtype}, db {db.dtype}")
        del got, ref, dx, dw, db, rdx, rdw, rdb
        if n == DOC_FWD_TOKENS:
            fwd_times(fce, x, w, b, labels, library=True)
            del x, w, b, labels, g
        torch.cuda.empty_cache()
    lse = fce.fused_ce_stats_reference(x, w, b, labels)[0]
    one = fce.fused_ce_stats(x, w, b, labels)
    two = fce.fused_ce_stats(x, w, b, labels)
    check(all(torch.equal(p, q) for p, q in zip(one, two)),
          "fused_ce_fwd bf16: two calls on the same inputs differ")
    one = fce.fused_ce_bwd(x, w, b, labels, lse, *g)
    two = fce.fused_ce_bwd(x, w, b, labels, lse, *g)
    check(all(torch.equal(p, q) for p, q in zip(one, two)),
          "fused_ce_bwd bf16: two calls on the same inputs differ")
    print(f"kernel fused_ce N={n} V={v} E={e} bf16: two calls bit-identical "
          f"(lse, lab, tot; dx, dw, db)")
    del one, two
    torch.cuda.empty_cache()
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    bl = b.to(bf).requires_grad_(True)

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            torch.nn.functional.linear(xl, wl, bl), labels,
            label_smoothing=0.1, reduction="sum")
    lib_loss = lib_fwd()
    lib_fwd_ms = time_ms(lib_fwd, iters=5)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_loss, (xl, wl, bl), retain_graph=True), iters=5)
    del lib_loss, xl, wl, bl
    torch.cuda.empty_cache()

    def d16(t):
        return fce.round_d(fce.dlogits_reference(x, w, b, labels, lse, *g),
                           t.dtype)
    times = {
        "fwd": (lambda: fce.fused_ce_stats(x, w, b, labels),
                lambda: fce.fused_ce_stats_reference(x, w, b, labels)),
        "dx": (lambda: fce.fused_ce_dx(x, w, b, labels, lse, *g),
               lambda: torch.matmul(d16(w), w.float()).to(bf)),
        "dw": (lambda: fce.fused_ce_dw(x, w, b, labels, lse, *g),
               lambda: (torch.matmul(d16(x).t(), x.float()).to(bf),
                        fce.dlogits_reference(x, w, b, labels, lse,
                                              *g).sum(0))),
    }
    joint_ms = time_ms(lambda: fce.fused_ce_bwd(x, w, b, labels, lse, *g),
                       iters=5)
    # three products; bytes: the inputs, the outputs and the bf16 d
    # scratch written once and read twice
    joint_bound, joint_by = bound(
        (n * e + v * e) * 2 * 2 + v * 4 * 2 + n * 4 * 5 + 3 * n * v * 2,
        6 * n * v * e, BF16_FLOPS)
    print(f"kernel fused_ce_bwd (joint: dx, dw, db) N={n} V={v} E={e} bf16: "
          f"kernel_ms {joint_ms:.4f} library_ms (backward of linear + "
          f"cross_entropy on bf16, two calls) {lib_bwd_ms:.4f} bound_ms "
          f"{joint_bound:.4f} ({joint_by}, at the bf16 peak; "
          f"{6 * n * v * e / joint_ms / 1e9:.2f} TFLOP/s achieved)")
    product_times(fce, x, w, b, labels, lse, g)
    flops = {"fwd": 2 * n * v * e, "dx": 4 * n * v * e, "dw": 4 * n * v * e}
    io_in = (n * e + v * e) * 2 + v * 4 + n * 4
    nbytes = {"fwd": io_in + 3 * n * 4, "dx": io_in + 4 * n * 4 + n * e * 2,
              "dw": io_in + 4 * n * 4 + v * e * 2 + v * 4}
    rows = []
    for part, line in (("fwd", 205), ("dx", 233), ("dw", 233)):
        ms = time_ms(times[part][0], iters=5)
        plain_ms = time_ms(times[part][1], iters=3)
        library_ms = lib_fwd_ms if part == "fwd" else lib_bwd_ms
        bound_ms, bound_by = bound(nbytes[part], flops[part], BF16_FLOPS)
        f32_peak_ms = bound(nbytes[part], flops[part])[0]
        print(f"kernel fused_ce_{part}_bf16 N={n} V={v} E={e}: kernel_ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"({'' if part == 'fwd' else 'backward of '}linear + "
              f"cross_entropy on bf16, two calls) {library_ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({bound_by}; {flops[part] / 1e9:.0f} GFLOP "
              f"at the bf16 peak, {nbytes[part] / 1e9:.3f} GB; "
              f"{100 * bound_ms / ms:.1f}% of it) bound_ms_f32_peak "
              f"{f32_peak_ms:.4f} (the same operations at the f32 "
              f"CUDA-core peak); {flops[part] / ms / 1e9:.2f} TFLOP/s "
              f"achieved")
        # the rows are the tensor-core kernels (their counters)
        rows.append({"name": f"fused_ce_{part}_bf16", "route": "cuda",
                     "source": "marian_tpu_torch/csrc/fused_ce.cu",
                     "replaces": f"marian_tpu/ops/pallas/fused_ce.py:{line}",
                     "max_abs_err": errs[part], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "bound_ms_f32_peak": f32_peak_ms,
                     "counter": f"fused_ce_{part}_bf16_tc"})
    del x, w, b, labels, g, lse
    torch.cuda.empty_cache()
    return rows


def fwd_times(fce, x, w, b, labels, library: bool = False) -> None:
    """The forward kernel's time and TFLOP/s beside torch.matmul(x,
    w.t()) of the same shape (a yardstick; the port never calls it) and,
    with ``library``, the plain version and F.linear + F.cross_entropy,
    timed after the kernel, their logits freed after."""
    n, e = x.shape
    v = w.shape[0]
    flops = 2 * n * v * e
    nbytes = (n * e + v * e) * x.element_size() + (v + n) * 4 + 3 * n * 4
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                               if x.dtype == torch.bfloat16 else F32_FLOPS)
    ms = time_ms(lambda: fce.fused_ce_stats(x, w, b, labels), iters=5)
    mm_ms = time_ms(lambda: torch.matmul(x, w.t()), iters=5)
    entry, cols = fce.fwd_route(x, w)
    line = (f"kernel fused_ce_fwd N={n} V={v} E={e} {str(x.dtype)[6:]} "
            f"({entry}, {cols}-column tiles): kernel_ms {ms:.4f} "
            f"({flops / ms / 1e9:.2f} TFLOP/s), torch.matmul(x, w.t()) "
            f"{mm_ms:.4f} ({flops / mm_ms / 1e9:.2f} TFLOP/s)")
    if library:
        plain_ms = time_ms(lambda: fce.fused_ce_stats_reference(
            x, w, b, labels), iters=5)
        line += f", plain_ms {plain_ms:.4f}"
        with torch.no_grad():
            lib_ms = time_ms(lambda: torch.nn.functional.cross_entropy(
                torch.nn.functional.linear(x, w, b.to(x.dtype)), labels,
                label_smoothing=0.1, reduction="sum"), iters=5)
        torch.cuda.empty_cache()
        line += (f", library_ms (linear + cross_entropy, two calls) "
                 f"{lib_ms:.4f}")
    print(f"{line}, bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{flops / 1e9:.0f} GFLOP)")


def bf16_paths(*wrappers) -> dict:
    """The fused CE ``wrappers``' launches so far on each bf16 path,
    summed over the wrappers."""
    return {"tensor cores": sum(f.launches_bf16_tc for f in wrappers),
            "CUDA cores": sum(f.launches_bf16 for f in wrappers)}


def product_times(fce, x, w, b, labels, lse, g) -> None:
    """Each of the backward's three products alone on the first
    vocabulary chunk of the main shape, with its TFLOP/s, beside
    torch.matmul of the same shape (a yardstick; the port never calls
    it). bf16 operands take the tensor-core kernels."""
    if x.dtype == torch.bfloat16:
        return tc_product_times(fce, x, w, b, labels, lse, g)
    n, e = x.shape
    v0, width = fce.vocab_chunks(n, w.shape[0])[0]
    ldd = -(-width // fce.CHUNK_ALIGN) * fce.CHUNK_ALIGN
    bf16 = int(x.dtype == torch.bfloat16)
    d = torch.empty((n, ldd), device=x.device)
    dx, dw = torch.zeros_like(x), torch.empty_like(w)
    dxf = torch.zeros((n, e), device=x.device)
    db = torch.empty(w.shape[0], device=x.device)
    lbl = labels.to(torch.int32)
    s = torch.cuda.current_stream().cuda_stream
    fns = [fce._fn("fused_ce_bwd_dlogit", 9, 7, bf16),
           fce._fn("fused_ce_bwd_dx", 5, 10, bf16),
           fce._fn("fused_ce_bwd_dw", 5, 8, bf16)]
    sx, sw = fce.chunk_splits(n, e, width)
    part = torch.empty(max(sx * n * e, sw * width * (e + 1)),
                       device=x.device)
    wc, dc = w[:width], d[:, :width]
    runs = {
        "d (NT, x . w_c^T, d epilogue)": (
            lambda: fns[0](x.data_ptr(), w.data_ptr(), b.data_ptr(),
                           lbl.data_ptr(), *(t.data_ptr() for t in (lse, *g)),
                           d.data_ptr(), n, e, v0, width, ldd, 1, bf16, s),
            lambda: torch.matmul(x, wc.t())),
        f"dx (NN, d_c . w_c, accumulate, {sx} slices)": (
            lambda: fns[1](d.data_ptr(), w.data_ptr(),
                           (dxf if bf16 else dx).data_ptr(), dx.data_ptr(),
                           part.data_ptr(), n, e, v0, width, ldd, 1, 0, 1,
                           sx, bf16, s),
            lambda: torch.matmul(dc.to(x.dtype), wc)),
        f"dw (TN, d_c^T . x, db, {sw} slices)": (
            lambda: fns[2](d.data_ptr(), x.data_ptr(), dw.data_ptr(),
                           db.data_ptr(), part.data_ptr(), n, e, v0, width,
                           ldd, 1, sw, bf16, s),
            lambda: torch.matmul(dc.t().to(x.dtype), x)),
    }
    flops = 2 * n * width * e
    for name, (kernel, yardstick) in runs.items():
        ms, mm_ms = time_ms(kernel, iters=10), time_ms(yardstick, iters=10)
        print(f"kernel fused_ce_bwd product {name} N={n} Vc={width} E={e} "
              f"{str(x.dtype)[6:]}: "
              f"kernel_ms {ms:.4f} ({flops / ms / 1e9:.2f} TFLOP/s), "
              f"torch.matmul of the same shape {mm_ms:.4f} "
              f"({flops / mm_ms / 1e9:.2f} TFLOP/s)")


def tc_product_times(fce, x, w, b, labels, lse, g) -> None:
    """``product_times`` of the tensor-core kernels (bf16 d scratch; the
    d kernel with and without its db sums)."""
    n, e = x.shape
    v0, width = fce.vocab_chunks(n, w.shape[0], elem=2)[0]
    ldd = -(-width // fce.CHUNK_ALIGN) * fce.CHUNK_ALIGN
    d = torch.empty((n, ldd), device=x.device, dtype=torch.bfloat16)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dxf = torch.zeros((n, e), device=x.device)
    db = torch.empty(w.shape[0], device=x.device)
    lbl = labels.to(torch.int32)
    s = torch.cuda.current_stream().cuda_stream
    fns = [fce._fn("fused_ce_bwd_tc_dlogit", 11, 5, True),
           fce._fn("fused_ce_bwd_tc_dx", 5, 8, True),
           fce._fn("fused_ce_bwd_tc_dw", 4, 6, True)]
    sx, sw = fce.chunk_splits(n, e, width, tc=True)
    part = torch.empty(max(sx * n * e, sw * width * e,
                           -(-n // fce.TC_TILE) * width), device=x.device)
    wc, dc = w[:width], d[:, :width]

    def dlogit(out_db):
        return fns[0](x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      lbl.data_ptr(), *(t.data_ptr() for t in (lse, *g)),
                      d.data_ptr(), out_db, part.data_ptr(), n, e, v0, width,
                      ldd, s)
    runs = {
        "d (NT, x . w_c^T, d epilogue, db)": (
            lambda: dlogit(db.data_ptr()), lambda: torch.matmul(x, wc.t())),
        "d (NT, x . w_c^T, d epilogue)": (
            lambda: dlogit(None), lambda: torch.matmul(x, wc.t())),
        f"dx (NN, d_c . w_c, accumulate, {sx} slices)": (
            lambda: fns[1](d.data_ptr(), w.data_ptr(), dxf.data_ptr(),
                           dx.data_ptr(), part.data_ptr(), n, e, v0, width,
                           ldd, 1, 0, sx, s),
            lambda: torch.matmul(dc, wc)),
        f"dw (TN, d_c^T . x, {sw} slices)": (
            lambda: fns[2](d.data_ptr(), x.data_ptr(), dw.data_ptr(),
                           part.data_ptr(), n, e, v0, width, ldd, sw, s),
            lambda: torch.matmul(dc.t(), x)),
    }
    flops = 2 * n * width * e
    for name, (kernel, yardstick) in runs.items():
        ms, mm_ms = time_ms(kernel, iters=10), time_ms(yardstick, iters=10)
        print(f"kernel fused_ce_bwd tensor-core product {name} N={n} "
              f"Vc={width} E={e} bfloat16: kernel_ms {ms:.4f} "
              f"({flops / ms / 1e9:.2f} TFLOP/s), torch.matmul of the same "
              f"shape {mm_ms:.4f} ({flops / mm_ms / 1e9:.2f} TFLOP/s)")


def phase_attention_kernels_bf16(gen) -> list:
    """The attention kernels' bf16 instantiations at the shapes the bf16
    paths give them, against their plain versions on the same bf16
    operands (outputs within BF16_REL_TOL of the largest; the outputs of
    the tensor-core kernels, the flash forward's out, dq, dk and dv (the
    plain backward fed the kernel's own out and lse) and the packed
    backward's dq, dk and dv, within one bf16 spacing plus REL_TOL of the
    scale, ``close_bf16``; the flash lse within LSE_TOL; new caches
    exact; two calls of each tensor-core backward bit-identical), timed
    beside SDPA on the same bf16 operands and the bound (bf16 operand
    bytes, operations at the bf16 tensor-core peak): decode_attention on
    bf16 queries and caches at the base decode's R 384, H 8, L 64; the
    packed forward and backward at the bf16 base update's B 192, H 8, T
    64 (both also at Dh 16, 32 and 128, causal, cross and ragged with a
    fully masked row; the forward at T 32 and past 64 tokens on the
    tensor cores, ``packed_fwd_bf16_cases``; the backward past 64 tokens
    on the CUDA cores); the
    flash forward, dq and dkv at the doc shape (B 8, H 16, T 2,048,
    every key live). Each row prints its route. Rows ``<kernel>_bf16``
    count their route's launches on the bf16 paths (BF16_PATHS): the
    flash forward, dq and dkv and the packed forward and backward on
    ``launches_bf16_tc``."""
    from marian_tpu_torch.ops.kernels import decode_attention as da
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    dev, bf = torch.device("cuda"), torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, bf)

    def add(name, what, source, replaces, err, ms, plain_ms, library_ms,
            nbytes, flops, route="CUDA cores", counter=None):
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        print(f"kernel {name} {what} [route: {route}]: kernel_ms {ms:.4f} "
              f"plain_ms "
              f"{plain_ms:.4f} library_ms (sdpa on bf16) {library_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}, at the bf16 peak; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
              f"{100 * bound_ms / ms:.1f}% of it; {ms / library_ms:.2f}x "
              f"the library's time); max |err| {err:.3g}")
        rows.append({"name": f"{name}_bf16", "route": "cuda",
                     "source": f"marian_tpu_torch/csrc/{source}",
                     "replaces": f"marian_tpu/ops/pallas/{replaces}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "counter": counter or name,
                     "paths": BF16_PATHS})

    # decode_attention: the base decode's rows (beam reorder), bf16 caches
    r, h, L, dh = BATCH * BEAM, 8, 64, 64
    q, kn, vn = randn(r, h, 1, dh), randn(r, h, 1, dh), randn(r, h, 1, dh)
    ck, cv = randn(r, h, L, dh), randn(r, h, L, dh)
    beams = (torch.arange(BATCH)[:, None] * BEAM
             + torch.randint(0, BEAM, (BATCH, BEAM), generator=gen))
    src = beams.reshape(-1).to(dev, torch.int32)
    pos = torch.full((r,), L - 1, dtype=torch.int32, device=dev)
    out, nk, nv = da.decode_attention(q, kn, vn, ck, cv, pos, src_rows=src)
    ro, rk, rv = da.decode_attention_reference(q, kn, vn, ck, cv, pos, src)
    torch.cuda.synchronize()
    check(torch.equal(nk, rk) and torch.equal(nv, rv),
          "decode_attention bf16: caches differ from the plain version")
    err = close_to_scale(out, ro, "decode_attention bf16", BF16_REL_TOL)
    bk, bv = torch.empty_like(ck), torch.empty_like(cv)
    ms = time_ms(lambda: da.decode_attention(q, kn, vn, ck, cv, pos,
                                             src_rows=src, out_k=bk,
                                             out_v=bv))
    plain_ms = time_ms(lambda: da.decode_attention_reference(
        q, kn, vn, ck, cv, pos, src))
    gk, gv = ck.index_select(0, src.long()), cv.index_select(0, src.long())
    live = torch.ones((r, 1, 1, L), dtype=torch.bool, device=dev)
    lib_ms = time_ms(lambda: sdpa(q, gk, gv, attn_mask=live))
    tile = h * L * dh * 2
    uniq = int(torch.unique(src).numel())
    add("decode_attention", f"R={r} H={h} L={L} Dh={dh} bf16 queries and "
        f"caches (base decode)", "decode_attention.cu",
        "decode_attention.py:117", err, ms, plain_ms, lib_ms,
        2 * uniq * tile + 2 * r * tile + 4 * r * h * dh * 2 + 2 * r * 4,
        4 * r * h * L * dh)
    del q, kn, vn, ck, cv, out, nk, nv, ro, rk, rv, bk, bv, gk, gv

    # the packed forward and backward: the rows of a 12,288-token batch
    t = 64
    b = TRAIN_WORDS // t
    q, k, v, do = (randn(b, h, t, dh) for _ in range(4))
    kvm = torch.ones(b, t, device=dev)
    mask = kvm.bool()[:, None, None, :]
    err = packed_fwd_bf16_cases(gen, q, k, v, kvm)
    out = pa.packed_attention(q, k, v, kvm)
    bwd_err = packed_bwd_bf16_cases(gen, q, k, v, do, kvm, out)
    ms = time_ms(lambda: pa.packed_attention(q, k, v, kvm))
    plain_ms = time_ms(lambda: pa.packed_attention_reference(q, k, v, kvm))
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    elems = b * h * t * dh * 2
    add("packed_attention", f"B={b} H={h} T={t} Dh={dh} bf16 (base "
        f"training)", "packed_attention.cu", "packed_attention.py:197",
        err, ms, plain_ms, lib_ms, 4 * elems + b * t * 4,
        4 * b * h * t * t * dh, "tensor cores, packed_tc_fwd_kernel",
        "packed_attention_bf16_tc")
    ms = time_ms(lambda: pa.packed_attention_bwd(q, k, v, kvm, do, out))
    plain_ms = time_ms(lambda: pa.packed_attention_bwd_reference(
        q, k, v, kvm, do, out))
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(ql, kl, vl, attn_mask=mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                 retain_graph=True))
    # the call reads q, k, v, dO, out and the key mask (delta is taken
    # from out) and writes dq, dk, dv
    add("packed_attention_bwd", f"B={b} H={h} T={t} Dh={dh} bf16 (base "
        f"training, with delta)", "packed_attention.cu",
        "packed_attention.py:214", bwd_err, ms, plain_ms, lib_ms,
        8 * elems + b * t * 4, 10 * b * h * t * t * dh,
        "tensor cores, packed_tc_bwd_kernel", "packed_attention_bwd_bf16_tc")
    del q, k, v, do, kvm, mask, out, ql, kl, vl, lib_out
    torch.cuda.empty_cache()

    # flash: the doc shape, every key live; the forward, dq and dkv take
    # the tensor cores (bf16, aligned, Dh 64)
    b, h, t = 8, 16, 2048
    q, k, v, do = (randn(b, h, t, dh) for _ in range(4))
    kvm = torch.ones(b, t, device=dev)
    mask = kvm.bool()[:, None, None, :]
    tc = (fa.flash_attention_fwd.launches_bf16_tc,
          fa.flash_attention_dq.launches_bf16_tc,
          fa.flash_attention_dkv.launches_bf16_tc)
    out, lse = fa.flash_attention_fwd(q, k, v, kvm)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kvm)
    errs = {"fwd": max(close_bf16(out, ref, "flash_attention_fwd bf16 out"),
                       lse_err(lse, ref_lse, "flash_attention_fwd bf16"))}
    del ref, ref_lse
    got = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse)
    again = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse)
    rgot = fa.flash_attention_bwd_reference(q, k, v, kvm, do, out, lse)
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches_bf16_tc == tc[0] + 1
          and fa.flash_attention_dq.launches_bf16_tc == tc[1] + 2
          and fa.flash_attention_dkv.launches_bf16_tc == tc[2] + 2,
          "the doc shape's bf16 flash forward, dq and dkv did not take the "
          "tensor cores")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "flash_attention_dq/dkv bf16: two calls differ")
    # the plain backward is fed the kernel's own out and lse
    errs["dq"] = close_bf16(got[0], rgot[0], "flash_attention_dq bf16")
    errs["dkv"] = max(close_bf16(g, r_, f"flash_attention_dkv bf16 {n}")
                      for n, g, r_ in zip(("dk", "dv"), got[1:], rgot[1:]))
    print("kernel flash_attention_dq, flash_attention_dkv bf16 (tensor "
          "cores): two calls give bit-identical dq, dk, dv")
    del got, again, rgot
    torch.cuda.empty_cache()
    scale = dh ** -0.5
    operands = (q, k, v, kvm, do, lse,
                (do.float() * out.float()).sum(dim=-1))
    grad, grad2 = torch.empty_like(q), torch.empty_like(q)
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))

    def lib_fwd():
        return sdpa(ql, kl, vl, attn_mask=mask)
    lib_out = lib_fwd()
    lib = {"fwd": time_ms(lib_fwd, iters=5)}
    lib["dq"] = lib["dkv"] = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True), iters=5)
    del lib_out
    plain_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, kvm, do, out, lse), iters=3)
    torch.cuda.empty_cache()
    elems = b * h * t * dh * 2
    stats = b * h * t * 4
    pairs = b * h * t * t * dh
    routes = {"fwd": ("tensor cores, flash_tc_fwd_kernel",
                      "flash_attention_fwd_bf16_tc"),
              "dq": ("tensor cores, flash_tc_dq_kernel",
                     "flash_attention_dq_bf16_tc"),
              "dkv": ("tensor cores, flash_tc_dkv_kernel",
                      "flash_attention_dkv_bf16_tc")}
    for part, line, fn, plain, n_elems, n_stats, n_ops in (
            ("fwd", 252, lambda: fa.flash_attention_fwd(q, k, v, kvm),
             lambda: fa.flash_attention_reference(q, k, v, kvm), 4, 1, 4),
            ("dq", 287, lambda: fa.flash_attention_dq(operands, grad, False,
                                                      scale), None, 5, 2, 6),
            ("dkv", 309, lambda: fa.flash_attention_dkv(
                operands, grad, grad2, False, scale), None, 6, 2, 8)):
        ms = time_ms(fn, iters=5)
        plain_ms = plain_bwd_ms if plain is None else time_ms(plain, iters=3)
        add(f"flash_attention_{part}", f"B={b} H={h} T={t} Dh={dh} bf16 "
            f"(doc shape{'' if plain else '; plain_ms: whole backward'})",
            "flash_attention.cu", f"flash_attention.py:{line}", errs[part],
            ms, plain_ms, lib[part], n_elems * elems + n_stats * stats
            + b * t * 4, n_ops * pairs, *routes[part])
    return rows


def packed_bf16_inputs(gen, dev, b, h, tq, tk, dh, lead: int = 0):
    """bf16 q, k, v, dO on the card and a key mask [B, Tk] of ragged
    lengths (row 0 all Tk), row 1 fully masked, row 2's first ``lead``
    keys masked too."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, do = randn(b, h, tq, dh), randn(b, h, tq, dh)
    k, v = randn(b, h, tk, dh), randn(b, h, tk, dh)
    lens = torch.randint(1, tk + 1, (b,), generator=gen)
    lens[0] = tk
    kvm = (torch.arange(tk)[None, :] < lens[:, None]).float()
    kvm[1] = 0.0                                      # a fully masked row
    kvm[2, :lead] = 0.0
    return q, k, v, do, kvm.to(dev)


def packed_fwd_bf16_cases(gen, q, k, v, kvm) -> float:
    """The bf16 packed forward against its plain version, every case on
    the tensor cores (out within one bf16 spacing plus REL_TOL of the
    scale, ``close_bf16``; two calls bit-identical; the route by its
    counter): at the base shape (q, k, v, kvm; B 192, T 64, Dh 64, every
    key live), causal, cross 64 x 48, ragged with a fully masked row at
    Dh 16, Dh 32 causal, Dh 128, the decode encoder's T 32 (32-query
    tiles), and past one key tile at T 100 causal and T 256, where a row
    whose first 70 keys are masked walks every key tile. Returns the
    cases' max |err|."""
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    err = 0.0
    # name, B, H, Tq, Tk, Dh, causal
    cases = [("base", None), ("causal", (64, 8, 64, 64, 64, True)),
             ("cross", (64, 8, 64, 48, 64, False)),
             ("ragged, a fully masked row, Dh 16", (32, 8, 41, 41, 16,
                                                     False)),
             ("Dh 32 causal", (32, 8, 64, 64, 32, True)),
             ("Dh 128", (32, 4, 64, 64, 128, False)),
             ("decode encoder", (64, 8, 32, 32, 64, False)),
             ("two key tiles", (8, 8, 100, 100, 64, True)),
             ("four key tiles", (8, 8, 256, 256, 64, False))]
    fn = pa.packed_attention
    for name, shape in cases:
        causal = False
        if shape is not None:
            b, h, tq, tk, dh, causal = shape
            q, k, v, _, kvm = packed_bf16_inputs(
                gen, q.device, b, h, tq, tk, dh, 70 if tk > 64 else 0)
        b, h, tq, dh = q.shape
        tk = k.shape[2]
        before = (fn.launches, fn.launches_bf16_tc)
        got = fn(q, k, v, kvm, causal=causal)
        again = fn(q, k, v, kvm, causal=causal)
        ref = pa.packed_attention_reference(q, k, v, kvm, causal=causal)
        torch.cuda.synchronize()
        moved = (fn.launches - before[0], fn.launches_bf16_tc - before[1])
        check(moved == (0, 2),
              f"packed_attention bf16 [{name}]: launches by route (CUDA "
              f"cores, tensor cores) {moved}")
        check(torch.equal(got, again),
              f"packed_attention bf16 [{name}]: two calls differ")
        what = (f"packed_attention bf16 [{name}] B={b} H={h} Tq={tq} "
                f"Tk={tk} Dh={dh} causal={causal}")
        e = close_bf16(got, ref, what)
        err = max(err, e)
        print(f"kernel {what} [route: tensor cores]: max |err| {e:.3g} "
              f"(one bf16 spacing + {REL_TOL} x scale), two calls "
              f"bit-identical")
    return err


def packed_bwd_bf16_cases(gen, q, k, v, do, kvm, out) -> float:
    """The bf16 packed backward against its plain version: at the base
    shape (q, k, v, dO, kvm, out; B 192, T 64, Dh 64, every key live)
    and at Dh 16, 32 and 128, causal, cross 64 x 48 and ragged with a
    fully masked row, each on the tensor cores (dq, dk, dv within one
    bf16 spacing, ``close_bf16``; two calls bit-identical), then at T
    100 on the CUDA cores (BF16_REL_TOL). Each case checks its route;
    returns the tensor-core cases' max |err|."""
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    err = 0.0
    # name, B, H, Tq, Tk, Dh, causal
    cases = [("base", None), ("causal", (64, 8, 64, 64, 64, True)),
             ("cross", (64, 8, 64, 48, 64, False)),
             ("ragged, a fully masked row, Dh 16", (32, 8, 41, 41, 16,
                                                     False)),
             ("Dh 32 causal", (32, 8, 64, 64, 32, True)),
             ("Dh 128", (32, 4, 64, 64, 128, False)),
             ("past one tile", (8, 8, 100, 100, 64, True))]
    fn = pa.packed_attention_bwd
    for name, shape in cases:
        causal = False
        if shape is not None:
            b, h, tq, tk, dh, causal = shape
            q, k, v, do, kvm = packed_bf16_inputs(gen, q.device, b, h, tq,
                                                  tk, dh)
            out = pa.packed_attention(q, k, v, kvm, causal=causal)
        b, h, tq, dh = q.shape
        tk = k.shape[2]
        tc = pa.packed_tc_path(q.dtype, dh, tq, tk)
        before = (fn.launches, fn.launches_bf16_tc)
        got = fn(q, k, v, kvm, do, out, causal)
        again = fn(q, k, v, kvm, do, out, causal)
        ref = pa.packed_attention_bwd_reference(q, k, v, kvm, do, out, causal)
        torch.cuda.synchronize()
        moved = (fn.launches - before[0], fn.launches_bf16_tc - before[1])
        check(moved == ((0, 2) if tc else (2, 0)),
              f"packed_attention_bwd bf16 [{name}]: launches by route "
              f"(CUDA cores, tensor cores) {moved}")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"packed_attention_bwd bf16 [{name}]: two calls differ")
        what = (f"packed_attention_bwd bf16 [{name}] B={b} H={h} Tq={tq} "
                f"Tk={tk} Dh={dh} causal={causal}")
        e = max(close_bf16(g, r_, f"{what} {n}") if tc else
                close_to_scale(g, r_, f"{what} {n}", BF16_REL_TOL)
                for n, g, r_ in zip(("dq", "dk", "dv"), got, ref))
        if tc:
            err = max(err, e)
        print(f"kernel {what} [route: {'tensor' if tc else 'CUDA'} cores]: "
              f"max |err| {e:.3g} ("
              + (f"one bf16 spacing + {REL_TOL} x scale" if tc else
                 f"{BF16_REL_TOL} x max |plain|")
              + "), two calls bit-identical")
    return err


def flash_inputs(gen, b, h, tq, tk, dh, dtype=torch.float32, live_rows=None,
                 lead=0, unaligned=False):
    """q, k, v, dO and a key mask [B, Tk] on the card. Rows at and past
    ``live_rows`` mask every key (the batch generator's padding rows)
    and get no output gradient, as in training; the live rows have
    ragged lengths, the first row all Tk; with ``lead`` the second row's
    first ``lead`` keys are masked too (its first live key then lies
    inside a tile); with ``unaligned`` q is a contiguous view 8 bytes
    into its buffer (16-byte aligned no more)."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    q, do = randn(b, h, tq, dh), randn(b, h, tq, dh)
    k, v = randn(b, h, tk, dh), randn(b, h, tk, dh)
    live_rows = b if live_rows is None else live_rows
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[0] = tk
    lens[live_rows:] = 0
    kvm = (torch.arange(tk)[None, :] < lens[:, None]).float()
    kvm[1:2, :lead] = 0.0
    kvm = kvm.to(dev)
    do[live_rows:] = 0.0
    if unaligned:
        shift = 8 // q.element_size()
        buf = torch.empty(q.numel() + shift, dtype=dtype, device=dev)
        q = buf[shift:].view(q.shape).copy_(q)
    return q, k, v, do, kvm


def phase_flash_kernels(gen) -> list:
    """The three flash kernels against their plain versions at the doc
    slice's shapes (B 8 with 4 padding rows, H 16, T 2,048, Dh 64: encoder
    self, decoder causal, cross with Tk 1,536), at ragged lengths, at the
    backward's tile edges (1,050 = 8 x 128 + 26 rows, a row whose first
    live key lies inside a tile, fewer keys than queries), other head
    sizes (Dh 48 and 80 run zero-padded to 64 and 128 and come back at
    their own Dh) and bf16: aligned bf16 takes the tensor-core forward, dq
    and dkv (their out, dq, dk and dv within one bf16 spacing plus
    REL_TOL of the scale of the plain backward fed the kernel's own out
    and lse), an unaligned bf16 view the CUDA-core ones; each case checks
    the route its launches took. Two backward calls at the encoder shape,
    and at every bf16 tensor-core case, must give the same bits. Then their
    times at the encoder shape, the joint backward's against SDPA's, and
    the forward, dq and dkv at the decoder's causal shape."""
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    b, h, t, dh = 8, 16, 2048, 64
    f32, bf = torch.float32, torch.bfloat16
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    # name, B, H, Tq, Tk, Dh, causal, dtype, live rows, first live key of
    # row 1, q unaligned
    cases = [("encoder self", b, h, t, t, dh, False, f32, 4, 0, False),
             ("decoder causal", b, h, t, t, dh, True, f32, 4, 0, False),
             ("cross", b, h, t, 1536, dh, False, f32, 4, 0, False),
             ("ragged", 2, 4, 1000, 1100, dh, False, f32, 1, 0, False),
             ("ragged causal", 2, 4, 1000, 1000, dh, True, f32, 1, 0, False),
             ("Dh 32", 2, 4, 300, 333, 32, True, f32, 1, 0, False),
             ("Dh 128", 2, 4, 300, 260, 128, False, f32, 1, 0, False),
             ("Dh 16", 2, 4, 130, 130, 16, False, f32, 1, 0, False),
             ("bf16", 2, 4, 1000, 1100, dh, False, bf, 1, 0, False),
             ("bf16 causal", 2, 4, 777, 777, dh, True, bf, 1, 0, False),
             ("bf16 Dh 128", 2, 4, 300, 260, 128, False, bf, 1, 0, False),
             ("bf16 Dh 128 causal", 2, 4, 333, 333, 128, True, bf, 1, 0,
              False),
             ("bf16 Dh 32", 2, 4, 300, 333, 32, True, bf, 1, 0, False),
             ("bf16 Dh 16", 2, 4, 130, 130, 16, False, bf, 1, 0, False),
             ("bf16 cross, Tk < Tq", 2, 4, 1050, 300, dh, False, bf, 1, 0,
              False),
             ("bf16 tile edges causal", 3, 4, 1050, 1050, dh, True, bf, 2,
              70, False),
             ("bf16 padding rows", 4, 4, 640, 640, dh, False, bf, 2, 0,
              False),
             ("bf16 unaligned view", 2, 4, 500, 520, dh, True, bf, 1, 0,
              True),
             ("tile edges causal", 3, 4, 1050, 1050, dh, True, f32, 2, 70,
              False),
             ("tile edges cross", 2, 4, 1050, 300, dh, False, f32, 1, 0,
              False),
             ("Dh 48, padded", 2, 4, 300, 333, 48, False, f32, 1, 0, False),
             ("Dh 80 causal, padded", 2, 4, 260, 260, 80, True, f32, 1, 0,
              False),
             ("bf16 Dh 48, padded", 2, 4, 300, 333, 48, False, bf, 1, 0,
              False),
             ("bf16 Dh 80 causal, padded", 2, 4, 260, 260, 80, True, bf, 1,
              0, False)]
    routes = [(fa.flash_attention_fwd, "launches"),
              (fa.flash_attention_fwd, "launches_bf16_tc"),
              (fa.flash_attention_dq, "launches"),
              (fa.flash_attention_dq, "launches_bf16_tc"),
              (fa.flash_attention_dkv, "launches"),
              (fa.flash_attention_dkv, "launches_bf16_tc")]
    for (name, b_, h_, tq, tk, d_, causal, dtype, live, lead,
         unaligned) in cases:
        q, k, v, do, kvm = flash_inputs(gen, b_, h_, tq, tk, d_, dtype, live,
                                        lead, unaligned)
        tc = dtype == bf and not unaligned
        before = [getattr(fn, a) for fn, a in routes]
        out, lse = fa.flash_attention_fwd(q, k, v, kvm, causal)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, kvm, causal)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse,
                                            causal)
        calls = 1
        if name == "encoder self" or tc:
            again = fa.flash_attention_bwd(q, k, v, kvm, do, out, lse, causal)
            check(all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
                  f"flash_attention_bwd [{name}]: two calls differ")
            print(f"kernel flash_attention_bwd [{name}]: two calls give "
                  f"bit-identical dq, dk, dv")
            calls = 2
            del again
        torch.cuda.synchronize()
        moved = [getattr(fn, a) - n for (fn, a), n in zip(routes, before)]
        check(moved == ([0, 1, 0, calls, 0, calls] if tc
                        else [1, 0, calls, 0, calls, 0]),
              f"flash_attention [{name}]: launches by route (forward, dq, "
              f"dkv, each on the CUDA cores, then on the tensor cores) "
              f"{moved}, expected the {'tensor' if tc else 'CUDA'} cores")
        check(out.shape == q.shape and dq.shape == q.shape
              and dk.shape == k.shape and dv.shape == v.shape,
              f"flash_attention [{name}]: outputs not at Dh {d_}")
        rel = REL_TOL if dtype == f32 else BF16_REL_TOL
        what = (f"flash_attention [{name}] B={b_} H={h_} Tq={tq} Tk={tk} "
                f"Dh={d_} {str(dtype)[6:]}")

        def gate(got, want, msg, one_spacing):
            if one_spacing:
                return close_bf16(got, want, msg)
            return close_to_scale(got, want, msg, rel)
        e = {"fwd": max(gate(out, ref, f"{what} out", tc),
                        lse_err(lse, ref_lse, f"{what} lse")),
             "dq": 0.0, "dkv": 0.0}
        # the plain backward fed the kernel's own out and lse, then the
        # plain forward's: a wrong lse skews every gradient of the second
        # (the tensor-core dq, dk and dv are held to one bf16 spacing of
        # the first)
        for src, fwd in (("kernel", (out, lse)), ("plain", (ref, ref_lse))):
            rdq, rdk, rdv = fa.flash_attention_bwd_reference(
                q, k, v, kvm, do, *fwd, causal)
            own = tc and src == "kernel"
            e["dq"] = max(e["dq"], gate(
                dq, rdq, f"{what} dq (plain from {src} out/lse)", own))
            e["dkv"] = max(e["dkv"], gate(
                dk, rdk, f"{what} dk (plain from {src} out/lse)", own),
                gate(dv, rdv, f"{what} dv (plain from {src} out/lse)", own))
            del rdq, rdk, rdv
        check(bool(torch.isfinite(out.float()).all()
                   and torch.isfinite(dq.float()).all()
                   and torch.isfinite(dk.float()).all()),
              f"{what}: non-finite values")
        if dtype == f32:        # the rows below are the f32 kernels'
            for part in errs:
                errs[part] = max(errs[part], e[part])
        spacing = (f"; out, dq, dk, dv one bf16 spacing + {REL_TOL} x scale"
                   if tc else "")
        print(f"kernel {what} causal={causal} "
              f"[route: {'tensor' if tc else 'CUDA'} cores]: max |err| "
              f"out/lse {e['fwd']:.3g} dq {e['dq']:.3g} dk/dv "
              f"{e['dkv']:.3g} (tolerance {rel} x max |plain| of each "
              f"output{spacing}; lse {LSE_TOL} on rows with a live key, "
              f"fully masked rows exact)")
        del q, k, v, do, kvm, out, lse, ref, ref_lse, dq, dk, dv
        torch.cuda.empty_cache()
    # times at the encoder's shape, every key live (the bound below counts
    # every (query, key) pair, which is what this data needs)
    q, k, v, do, kvm = flash_inputs(gen, b, h, t, t, dh, live_rows=b)
    kvm.fill_(1.0)
    out, lse = fa.flash_attention_fwd(q, k, v, kvm)
    # dq and dkv timed one launch each, on flash_attention_bwd's operands
    scale = dh ** -0.5
    operands = (q, k, v, kvm, do, lse, (do * out).sum(dim=-1))
    grad, grad2 = torch.empty_like(q), torch.empty_like(q)
    times = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, kvm),
                lambda: fa.flash_attention_reference(q, k, v, kvm)),
        "dq": (lambda: fa.flash_attention_dq(operands, grad, False, scale),
               lambda: fa.flash_attention_bwd_reference(q, k, v, kvm, do,
                                                        out, lse)),
        "dkv": (lambda: fa.flash_attention_dkv(operands, grad, grad2, False,
                                               scale),
                lambda: fa.flash_attention_bwd_reference(q, k, v, kvm, do,
                                                         out, lse)),
    }
    mask = kvm.bool()[:, None, None, :]
    ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))

    def lib_fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask)
    lib_out = lib_fwd()
    lib_bwd = (lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                           retain_graph=True))
    lib_ms = {"fwd": time_ms(lib_fwd, iters=5)}
    lib_ms["dq"] = lib_ms["dkv"] = time_ms(lib_bwd, iters=5)
    backend = f"{top_kernel(lib_fwd)} / {top_kernel(lib_bwd)}"
    elems = b * h * t * dh * 4
    stats = b * h * t * 4
    pairs = b * h * t * t * dh
    flops = {"fwd": 4 * pairs, "dq": 6 * pairs, "dkv": 8 * pairs}
    nbytes = {"fwd": 4 * elems + stats + b * t * 4,
              "dq": 5 * elems + 2 * stats + b * t * 4,
              "dkv": 6 * elems + 2 * stats + b * t * 4}
    rows = []
    for part, line in (("fwd", 252), ("dq", 287), ("dkv", 309)):
        ms = time_ms(times[part][0], iters=5)
        plain_ms = time_ms(times[part][1], iters=3)
        bound_ms, bound_by = bound(nbytes[part], flops[part])
        print(f"kernel flash_attention_{part} B={b} H={h} T={t} Dh={dh} f32: "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"(sdpa {'forward' if part == 'fwd' else 'backward'}; "
              f"{backend}) {lib_ms[part]:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}; {flops[part] / 1e9:.0f} GFLOP, "
              f"{flops[part] / ms / 1e9:.2f} TFLOP/s achieved)")
        rows.append({"name": f"flash_attention_{part}", "route": "cuda",
                     "source": "marian_tpu_torch/csrc/flash_attention.cu",
                     "replaces": f"marian_tpu/ops/pallas/flash_attention.py:"
                                 f"{line}",
                     "max_abs_err": errs[part], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms[part],
                     "paths": F32_PATHS})
    flash_bwd_lines(fa, q, k, v, kvm, do, out, lse, lib_ms["dq"])
    del lib_out
    return rows


def flash_bwd_lines(fa, q, k, v, kvm, do, out, lse, lib_bwd_ms) -> None:
    """The joint backward (``flash_attention_bwd``: delta, dq and dkv) at
    the encoder shape against SDPA's backward (``lib_bwd_ms``), bound by
    the 10 B.H.Tq.Tk.Dh flops dq, dk and dv need; then the forward, dq and
    dkv alone at the decoder's causal shape, bound by the live (query,
    key) pairs, T(T+1)/2 a head."""
    b, h, t, dh = q.shape
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, kvm, do, out, lse),
                 iters=5)
    flops = 10 * b * h * t * t * dh
    # reads q, k, v, dO, out, lse and the key mask; writes dq, dk, dv
    bound_ms, bound_by = bound(8 * q.numel() * 4 + b * h * t * 4 + b * t * 4,
                               flops)
    print(f"kernel flash_attention_bwd (delta + dq + dkv) B={b} H={h} T={t} "
          f"Dh={dh} f32: kernel_ms {ms:.4f} library_ms (sdpa backward) "
          f"{lib_bwd_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{flops / 1e9:.0f} GFLOP, {flops / ms / 1e9:.2f} TFLOP/s "
          f"achieved)")
    out_c, lse_c = fa.flash_attention_fwd(q, k, v, kvm, True)
    scale = dh ** -0.5
    operands = (q, k, v, kvm, do, lse_c, (do * out_c).sum(dim=-1))
    grad, grad2 = torch.empty_like(q), torch.empty_like(q)
    pairs = b * h * t * (t + 1) // 2 * dh
    for part, fn, n, elems in (
            ("fwd", lambda: fa.flash_attention_fwd(q, k, v, kvm, True), 4,
             4),
            ("dq", lambda: fa.flash_attention_dq(operands, grad, True,
                                                 scale), 6, 5),
            ("dkv", lambda: fa.flash_attention_dkv(operands, grad, grad2,
                                                   True, scale), 8, 6)):
        ms = time_ms(fn, iters=5)
        # fwd: q, k, v in, out and lse out; dq, dkv as their kernel lines
        stats = (1 if part == "fwd" else 2) * b * h * t * 4
        bound_ms, bound_by = bound(elems * q.numel() * 4 + stats + b * t * 4,
                                   n * pairs)
        print(f"kernel flash_attention_{part} causal B={b} H={h} T={t} "
              f"Dh={dh} f32: kernel_ms {ms:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}; {n * pairs / 1e9:.0f} GFLOP over the live "
              f"pairs, {n * pairs / ms / 1e9:.2f} TFLOP/s achieved)")


def paged_case(gen, r, h, dh, page_len, mp, pins, dtype=torch.float32,
               share=False):
    """One paged-attention case on the card: q and this step's K/V
    [R,H,1,Dh], pools of 1 + R*MP random pages, a page table that hands
    every row its own MP pages scattered over the pool in random order
    (rows share none; with ``share``, rows 4 and 5 share their first MP/2
    pages, as the prefix cache sends them, and write past them), and
    positions drawn from [-1, MP*page_len - 1] with the first rows pinned
    at ``pins``."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    n_pages = 1 + r * mp
    table = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(r, mp)
    if share:
        table[5, :mp // 2] = table[4, :mp // 2]
    pos = torch.randint(-1, mp * page_len, (r,), generator=gen)
    pos[:len(pins)] = torch.tensor(pins)
    q, kn, vn = randn(r, h, 1, dh), randn(r, h, 1, dh), randn(r, h, 1, dh)
    pk, pv = (randn(n_pages, h, page_len, dh) for _ in range(2))
    return (q, kn, vn, pk, pv, table.to(dev, torch.int32),
            pos.to(dev, torch.int32))


def paged_bound(q, pk, table, pos, peak: float = F32_FLOPS):
    """(bound_ms, bound_by, MB) of one paged read on these inputs: each
    active row's live positions of K and V (0 .. pos), an idle row's
    (pos < 0) V over all MP*page_len positions (every score is -1e9, so
    its answer is V's average and needs no K), the table entries of the
    pages those positions lie on, the positions, q and the output; 4*H*Dh
    flops per live position of an active row, 2*H*Dh of an idle one."""
    r, h, _, dh = q.shape
    page_len, mp = pk.shape[2], table.shape[1]
    p = pos.long().cpu()
    live = torch.where(p < 0, mp * page_len,
                       torch.clamp(p + 1, max=mp * page_len))
    active = int(live[p >= 0].sum())
    idle = int(live.sum()) - active
    pages = (live + page_len - 1) // page_len
    nbytes = ((2 * active + idle) * h * dh * pk.element_size()
              + int(pages.sum()) * 4 + pos.numel() * 4
              + 2 * q.numel() * q.element_size())
    ms, by = bound(nbytes, h * dh * (4 * active + 2 * idle), peak)
    return ms, by, nbytes / 1e6


def paged_route_name(route) -> str:
    """The paged read's kernel for a ``kv_pool.paged_route`` triple."""
    lanes, per_lane, stages = route
    return (f"vector kernel, {lanes} lanes x {per_lane}, {stages} buffers"
            if lanes else "scalar kernel")


def phase_paged_kernel(gen) -> list:
    """paged_decode_attention against its plain version (the insert, then
    the gather read), on both routes: the vector kernel at the serve
    path's shape (R 64, H 8, Dh 64, page 16, MP 8, pools of 513 pages),
    a 2,048-position row span, Dh 32 and 128, bf16, pages of 8 and 32
    and rows that share pages (one of them past its span); the scalar
    kernel at pages of 5 and at Dh 36 in bf16. Pools after the insert
    exact (and equal to the CPU's insert at the serve shape). Then the
    read's times at the serve shape, and at the long shape beside its
    bound; and row 10b, the read on bf16 pools at both shapes, held to
    its plain version and timed beside the gather + SDPA on bf16, its
    bound in bf16 bytes."""
    from marian_tpu_torch.ops.kernels import kv_pool as kv
    pins = [-1, 0, 15, 16]
    # (name, R, H, Dh, page, MP, pins, dtype, rows 4 and 5 share pages)
    cases = [("serve", 64, 8, 64, 16, 8, pins + [127], torch.float32, False),
             ("long", 8, 16, 64, 16, 128, pins + [2047], torch.float32,
              False),
             ("Dh 32", 16, 4, 32, 16, 8, pins + [127], torch.float32, False),
             ("Dh 128", 16, 4, 128, 16, 8, pins + [127], torch.float32,
              False),
             ("bf16", 16, 8, 64, 16, 8, pins + [127], torch.bfloat16, False),
             ("page 8", 16, 8, 64, 8, 16, pins + [127], torch.float32,
              False),
             ("page 32", 16, 8, 64, 32, 4, pins + [127], torch.float32,
              False),
             ("shared pages", 16, 8, 64, 16, 8, pins + [127, 100, 133],
              torch.float32, True),
             ("page 5", 16, 4, 64, 5, 20, pins + [99], torch.float32, False),
             ("Dh 36", 16, 4, 36, 16, 8, pins + [127], torch.bfloat16,
              False)]
    err = 0.0
    for name, r, h, dh, pl, mp, case_pins, dtype, share in cases:
        q, kn, vn, pk, pv, table, pos = paged_case(gen, r, h, dh, pl, mp,
                                                   case_pins, dtype, share)
        route = kv.paged_route(r, h, dh, pk.element_size(), pl, mp,
                               sms=kv._sms(torch.cuda.current_device()))
        check((route == (0, 0, 0)) == (name in ("page 5", "Dh 36")),
              f"paged_decode_attention [{name}]: route {route}")
        gk, gv = pk.clone(), pv.clone()
        out = kv.paged_decode_attention(q, kn, vn, gk, gv, table, pos)
        rk, rv = pk.clone(), pv.clone()
        kv.pool_insert(rk, rv, kn, vn, table, pos)
        ref = kv.paged_decode_attention_reference(q, rk, rv, table, pos)
        torch.cuda.synchronize()
        check(torch.equal(gk, rk) and torch.equal(gv, rv),
              f"paged_decode_attention [{name}]: pools after the insert "
              f"differ from the plain insert")
        if name == "serve":
            ck, cv = pk.cpu(), pv.cpu()
            kv.pool_insert(ck, cv, kn.cpu(), vn.cpu(), table.cpu(),
                           pos.cpu())
            check(torch.equal(gk.cpu(), ck) and torch.equal(gv.cpu(), cv),
                  "paged_decode_attention [serve]: pools after the insert "
                  "differ from the CPU's insert")
        what = (f"paged_decode_attention [{name}] R={r} H={h} Dh={dh} "
                f"page {pl} MP={mp} {str(dtype)[6:]}, "
                f"{paged_route_name(route)}")
        if dtype == torch.float32:
            e = (out - ref).abs().max().item()
            check(e <= TOL, f"{what}: max |err| {e} > {TOL}")
            err = max(err, e)
            print(f"kernel {what}: max |err| {e:.3g}, pools exact")
        else:
            e = close_bf16(out, ref, what)
            print(f"kernel {what}: max |err| {e:.3g} (one bf16 spacing + "
                  f"{REL_TOL} x scale), pools exact")
        if name == "long":
            ms_long = time_ms(lambda: kv.paged_decode_attention_read(
                q, gk, gv, table, pos))
            b_long, _, mb = paged_bound(q, pk, table, pos)
            long_line = (f"long shape R={r} H={h} MP={mp} "
                         f"({paged_route_name(route)}): kernel_ms "
                         f"{ms_long:.4f} bound_ms {b_long:.4f}")
            print(f"kernel {what}: kernel_ms {ms_long:.4f} bound_ms "
                  f"{b_long:.4f} ({mb:.1f} MB)")
        if name == "serve":
            serve, serve_route = (q, gk, gv, table, pos), route
    ms, plain_ms, library_ms, bound_ms, bound_by, mb = paged_times(*serve)
    q, pk, _, table, _ = serve
    r, h, _, dh = q.shape
    pl, mp = pk.shape[2], table.shape[1]
    print(f"kernel paged_decode_attention R={r} H={h} Dh={dh} page {pl} "
          f"MP={mp} f32 (the read, {paged_route_name(serve_route)}): "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms(gather pool[page_table] + sdpa, two calls) "
          f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{mb:.2f} MB); {long_line}")
    f32_row = {"name": "paged_decode_attention", "route": "cuda",
               "source": "marian_tpu_torch/csrc/paged_decode_attention.cu",
               "replaces": "marian_tpu/ops/pallas/kv_pool.py:750",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "paths": F32_PATHS}
    # row 10b: the read on bf16 pools (the bf16 beam serve path's), at the
    # serve shape and the long shape, against its plain version
    bf16_err, times = 0.0, []
    for name, r, h, mp, case_pins in (("serve", 64, 8, 8, pins + [127]),
                                      ("long", 8, 16, 128, pins + [2047])):
        q, kn, vn, pk, pv, table, pos = paged_case(gen, r, h, 64, 16, mp,
                                                   case_pins, torch.bfloat16)
        kv.pool_insert(pk, pv, kn, vn, table, pos)
        out = kv.paged_decode_attention_read(q, pk, pv, table, pos)
        ref = kv.paged_decode_attention_reference(q, pk, pv, table, pos)
        what = (f"paged_decode_attention bf16 [{name}] R={r} H={h} Dh=64 "
                f"page 16 MP={mp}")
        # the read sums in f32 and rounds once: one bf16 spacing holds
        e = close_bf16(out, ref, what)
        bf16_err = max(bf16_err, e)
        excess = float(((out.float() - ref.float()).abs()
                        - BF16_SPACING * ref.float().abs()).max())
        t = paged_times(q, pk, pv, table, pos, BF16_FLOPS)
        times.append(t)
        print(f"kernel {what} (the read on bf16 pools): kernel_ms "
              f"{t[0]:.4f} plain_ms {t[1]:.4f} library_ms (gather "
              f"pool[page_table] + sdpa on bf16, two calls) {t[2]:.4f} "
              f"bound_ms {t[3]:.4f} ({t[4]}, bf16 bytes; {t[5]:.2f} MB; "
              f"{100 * t[3] / t[0]:.1f}% of it; {t[0] / t[2]:.2f}x the "
              f"library's time); max |err| vs plain {e:.3g}, largest "
              f"|err| less one bf16 spacing {excess:.3g} (gate: one bf16 "
              f"spacing + {REL_TOL} x scale)")
    ms, plain_ms, library_ms, bound_ms, bound_by, _ = times[0]
    bf16_row = {"name": "paged_decode_attention_bf16", "route": "cuda",
                "source": "marian_tpu_torch/csrc/paged_decode_attention.cu",
                "replaces": "marian_tpu/ops/pallas/kv_pool.py:750",
                "max_abs_err": bf16_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "counter": "paged_decode_attention", "paths": BF16_PATHS}
    return [f32_row, bf16_row]


def paged_times(q, pk, pv, table, pos, peak: float = F32_FLOPS):
    """(kernel ms, plain ms, library ms, bound ms, bound_by, MB) of the
    paged read on these inputs; the library: the ``pool[page_table]``
    gather, then SDPA under the live-position mask (two calls)."""
    from marian_tpu_torch.ops.kernels import kv_pool as kv
    r, h, _, dh = q.shape
    pl, mp = pk.shape[2], table.shape[1]
    ms = time_ms(lambda: kv.paged_decode_attention_read(q, pk, pv, table,
                                                        pos))
    plain_ms = time_ms(lambda: kv.paged_decode_attention_reference(
        q, pk, pv, table, pos))
    live = (torch.arange(mp * pl, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    tl = table.long()

    def library():
        gk = pk[tl].transpose(1, 2).reshape(r, h, mp * pl, dh)
        gv = pv[tl].transpose(1, 2).reshape(r, h, mp * pl, dh)
        return torch.nn.functional.scaled_dot_product_attention(
            q, gk, gv, attn_mask=live)
    library_ms = time_ms(library)
    bound_ms, bound_by, mb = paged_bound(q, pk, table, pos, peak)
    return ms, plain_ms, library_ms, bound_ms, bound_by, mb


def vocab_map(size: int) -> dict:
    return {"</s>": 0, "<unk>": 1, **{f"w{i}": i for i in range(2, size)}}


def write_vocab() -> None:
    """The 32,000-word vocabulary w2 .. w31999 of the synthetic data
    (vocab.yml), and its first VOCAB_CUT words (vocab_cut.yml)."""
    from marian_tpu_torch.data.vocab import DefaultVocab
    WORK.mkdir(parents=True, exist_ok=True)
    for name, size in (("vocab.yml", VOCAB), ("vocab_cut.yml", VOCAB_CUT)):
        DefaultVocab(vocab_map(size)).save(str(WORK / name))


def write_model(seed: int, cuts_only: bool = False):
    """A 32,000-word vocab and transformer-base weights from ``seed``
    (plus a 2+2-layer cut of them), written through the port's own io;
    and the doc-level cut's random weights (2+2 layers, dim 256, 4
    heads). The output bias is drawn wide (std 2) so a random model's
    next-token ranking has gaps far above f32 rounding: card and CPU then
    pick the same beams. ``cuts_only``: the two cuts alone (the same
    weights), not the full base and serve models."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.options import Options
    from marian_tpu_torch.models import transformer as T
    write_vocab()
    opts = Options(BASE)
    flat = random_weights(opts, seed)
    if not cuts_only:
        mio.save_model(str(WORK / "base.npz"), flat, opts.as_yaml())
        mio.save_model(str(WORK / "serve.npz"), serve_weights(
            flat, T.config_from_options(opts, VOCAB, VOCAB)), opts.as_yaml())
    small, cut = depth_cut(flat, opts)
    mio.save_model(str(WORK / "base_2x2.npz"), small, cut.as_yaml())
    if not cuts_only:
        mio.save_model(str(WORK / SERVE_CUT_MODEL), serve_weights(
            small, T.config_from_options(cut, VOCAB, VOCAB)), cut.as_yaml())
    doc = opts.with_(**{"dim-emb": 256, "transformer-heads": 4,
                        "transformer-dim-ffn": 1024, "enc-depth": 2,
                        "dec-depth": 2, "max-length": 2048})
    mio.save_model(str(WORK / "doc_cut.npz"),
                   random_weights(doc, seed + 7, VOCAB_CUT), doc.as_yaml())
    rng = np.random.RandomState(seed)
    lines = [" ".join(f"w{i}" for i in rng.randint(2, VOCAB, SRC_LEN - 1))
             for _ in range(BATCH * N_BATCHES)]
    return lines


def random_weights(opts, seed: int, vocab: int = VOCAB) -> dict:
    """Random weights of ``opts``'s model from ``seed``, the output bias
    drawn wide (std 2)."""
    from marian_tpu_torch.models import transformer as T
    cfg = T.config_from_options(opts, vocab, vocab)
    params = T.init_params(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    params["decoder_ff_logit_out_b"] = 2.0 * torch.randn(1, vocab,
                                                         generator=gen)
    return {k: v.numpy() for k, v in params.items()}


def depth_cut(flat: dict, opts):
    """The SERVE_CUT_DEPTH+SERVE_CUT_DEPTH-layer cut of a model's
    weights (its first layers, every shared matrix) and its options."""
    small = {k: v for k, v in flat.items()
             if not k.startswith(("encoder_l", "decoder_l"))
             or k.split("_")[1] in ("l1", "l2")}
    return small, opts.with_(**{"enc-depth": SERVE_CUT_DEPTH,
                                "dec-depth": SERVE_CUT_DEPTH})


def serve_weights(flat: dict, cfg) -> dict:
    """The serve model: the base weights ``flat`` made to copy their
    source, so that greedy output follows the attention, is as varied as
    the sources, and every row leaves at its own EOS (the source's, at
    step n of an n-word sentence), as a translation does. The random
    base ranks the same top-bias token first at every step and never
    emits EOS: a paged read gone wrong would not change one reply.

    - Positions and words get orthogonal subspaces: ``span`` is the span
      of LN(pos(t)) for t < COPY_POSITIONS (rank 28 at dim 512), and the
      word embeddings are projected out of it.
    - Every random sublayer (attention Wo, FFN W2) is scaled by
      COPY_SCALE and projected out of ``span`` too: the layers move the
      stream, and with it the logits, but never its positional part.
    - The last decoder layer's cross-attention is a copy head. Every head
      scores with the same map ``fit``, the ridge regression of the 32
      highest-frequency sin/cos pairs of pos(t) on LN(pos(t)), so the
      step-t query peaks at source position t. Wv drops the positions;
      Wo writes the source word at position t with gain COPY_GAIN, and
      the tied output table ranks that word first.
    - The output bias is 0.
    """
    from marian_tpu_torch.models import transformer as T
    d, f64 = cfg.dim_emb, torch.float64
    raw = T.sinusoidal_positions(COPY_POSITIONS, d).to(f64)
    ln = raw - raw.mean(-1, keepdim=True)
    ln = ln / ln.pow(2).mean(-1, keepdim=True).sqrt()
    sv = torch.linalg.svd(ln, full_matrices=False)
    span = sv.Vh[:int((sv.S > 1e-4 * sv.S[0]).sum())].t()
    off = torch.eye(d, dtype=f64) - span @ span.t()
    p = {k: torch.from_numpy(v).to(f64) for k, v in flat.items()}
    p["Wemb"] = p["Wemb"] @ off
    p["decoder_ff_logit_out_b"] = torch.zeros_like(
        p["decoder_ff_logit_out_b"])
    for k in p:
        if k.endswith(("_Wo", "_ffn_W2")):
            p[k] = COPY_SCALE * p[k] @ off
    sel = [*range(COPY_FREQS), *range(d // 2, d // 2 + COPY_FREQS)]
    check(len(sel) == cfg.dim_head, "copy head features != head width")
    gram = ln.t() @ ln
    fit = torch.linalg.solve(
        gram + COPY_RIDGE * torch.linalg.matrix_norm(gram, 2)
        * torch.eye(d, dtype=f64), ln.t() @ raw[:, sel])
    c = f"decoder_l{cfg.dec_depth}_context"
    p[f"{c}_Wq"] = p[f"{c}_Wk"] = COPY_BETA * fit.repeat(1, cfg.heads)
    p[f"{c}_Wv"] = off
    p[f"{c}_Wo"] = COPY_GAIN * torch.eye(d, dtype=f64)
    return {k: v.to(torch.float32).numpy() for k, v in p.items()}


def decoder_options(model: str, *extra: str, vocab: str = "vocab.yml"):
    from marian_tpu_torch.common.config_parser import parse_options
    return parse_options(["--models", str(WORK / model), "--vocabs",
                          str(WORK / vocab), str(WORK / vocab),
                          "--beam-size", str(BEAM), "--max-length", "64",
                          "--mini-batch", str(BATCH), "--quiet", *extra])


def kernel_counters():
    """Every kernel of the port, by name: (its wrapper, the attribute
    that counts its launches). The fused CE's bf16 instantiations count
    on their wrappers' ``launches_bf16``, its tensor-core forward and
    backward, the flash tensor-core forward, dq and dkv and the packed
    tensor-core forward and backward on ``launches_bf16_tc``."""
    from marian_tpu_torch.ops.kernels import decode_attention as da
    from marian_tpu_torch.ops.kernels import flash_attention as fa
    from marian_tpu_torch.ops.kernels import fused_ce as fce
    from marian_tpu_torch.ops.kernels import kv_pool as kv
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    fns = {"decode_attention": da.decode_attention,
           "packed_attention": pa.packed_attention,
           "packed_attention_bwd": pa.packed_attention_bwd,
           "flash_attention_fwd": fa.flash_attention_fwd,
           "flash_attention_dq": fa.flash_attention_dq,
           "flash_attention_dkv": fa.flash_attention_dkv,
           "fused_ce_fwd": fce.fused_ce_stats,
           "fused_ce_dx": fce.fused_ce_dx, "fused_ce_dw": fce.fused_ce_dw,
           "paged_decode_attention": kv.paged_decode_attention}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        out[f"{name}_bf16"] = (fns[name], "launches_bf16")
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw",
                 "flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "packed_attention",
                 "packed_attention_bwd"):
        out[f"{name}_bf16_tc"] = (fns[name], "launches_bf16_tc")
    return out


def reset_counts() -> None:
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in kernel_counters().items()}


def decode_run(model: str, lines, *extra: str, vocab: str = "vocab.yml"):
    """The counted run of a decode main path: the decoder object
    marian_decoder.main drives, built from the same flags (model loading
    stays out of the timing), with every launch count set to 0 just
    before it and read just after. Returns (translator, n-best fields,
    seconds, counts)."""
    from marian_tpu_torch.translator.translator import Translate
    tr = Translate(decoder_options(model, "--n-best", *extra, vocab=vocab))
    check(tr.device.type == "cuda", f"decoder resolved {tr.device}")
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = tr.run(lines, out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    hyps = [l.split(" ||| ") for l in out.getvalue().splitlines()]
    check(len(got) == len(lines) and len(hyps) == BEAM * len(lines)
          and sorted({int(h[0]) for h in hyps}) == list(range(len(lines))),
          f"{len(hyps)} n-best lines for {len(lines)} inputs x beam {BEAM}")
    scores = np.array([float(h[2].split()[1]) for h in hyps])
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(all(tr.trg_vocab.encode(h[1], add_eos=False).count(1) == 0
              for h in hyps), "output words outside the vocabulary")
    return tr, hyps, secs, counts


def check_decode_counts(tr, counts, batches: int, encoder: str) -> None:
    """decode_attention once per decoder layer and step; the encoder's
    attention kernel (``encoder``) once per layer and batch; no other
    kernel."""
    steps = list(tr.search.steps)
    cfg = tr.model.cfg
    check(len(steps) == batches, f"{len(steps)} batches, expected {batches}")
    want = {name: 0 for name in counts}
    want["decode_attention"] = cfg.dec_depth * sum(steps)
    want[encoder] = cfg.enc_depth * batches
    check(counts == want, f"decode launches {counts}, expected {want}")


def phase_main_path(lines) -> dict:
    from marian_tpu_torch.cli import marian_decoder
    # warm-up, not counted: the command-line decoder on two sentences,
    # file in, file out
    (WORK / "warm.in").write_text("\n".join(lines[:2]) + "\n")
    marian_decoder.main(["--models", str(WORK / "base.npz"), "--vocabs",
                         str(WORK / "vocab.yml"), str(WORK / "vocab.yml"),
                         "--beam-size", str(BEAM), "--quiet", "--input",
                         str(WORK / "warm.in"), "--output",
                         str(WORK / "warm.out")])
    check(len((WORK / "warm.out").read_text().splitlines()) == 2,
          "command-line warm-up output")
    tr, _, secs, counts = decode_run("base.npz", lines)
    check_decode_counts(tr, counts, N_BATCHES, "packed_attention")
    steps = list(tr.search.steps)
    print(f"main path: transformer-base 6+6, dim 512, ffn 2048, 8 heads, "
          f"vocab {VOCAB}, beam {BEAM}, {len(lines)} sentences x {SRC_LEN} "
          f"tokens in {N_BATCHES} batches of {BATCH}: steps {steps}, "
          f"{secs:.3f} s, {len(lines) / secs:.2f} sentences/s, "
          f"{1e3 * secs / sum(steps):.3f} ms per decode step (whole run / "
          f"steps); launches {counts}")
    return counts


def decode_card_vs_cpu(what: str, model: str, sents, *extra: str,
                       vocab: str = "vocab.yml") -> None:
    """The same sentences decoded on the card (kernels) and on the CPU
    (plain versions): n-best tokens must be identical."""
    from marian_tpu_torch.translator.translator import Translate
    res = {}
    for name, dev in (("cuda", ()), ("cpu", ("--cpu-threads", "8"))):
        tr = Translate(decoder_options(model, "--n-best", *extra, *dev,
                                       vocab=vocab))
        check(tr.device.type == name, f"{name} run resolved {tr.device}")
        t0 = time.perf_counter()
        res[name] = tr.run(sents, io.StringIO())
        print(f"card vs cpu: {name} decode of {what}, n-best {BEAM}: "
              f"{time.perf_counter() - t0:.2f} s; steps {tr.search.steps}")

    def split(out):
        hyps = [l.split(" ||| ") for s in out for l in s.splitlines()]
        return [h[:2] for h in hyps], [float(h[2].split()[1]) for h in hyps]
    (gt, gs), (ct, cs) = split(res["cuda"]), split(res["cpu"])
    check(gt == ct, f"{what}: n-best tokens differ between the card and the "
          f"CPU")
    print(f"card vs cpu: {what}: {len(gt)} n-best hypotheses identical; max "
          f"|score diff| {np.max(np.abs(np.subtract(gs, cs))):.3g}")


def phase_card_vs_cpu(lines) -> None:
    decode_card_vs_cpu(f"{len(lines[:8])} sentences, 2+2 layers",
                       "base_2x2.npz", lines[:8])


def serve_options(*extra: str, model: str = "serve.npz",
                  vocab: str = "vocab.yml"):
    """marian-server flags of the serve main path: transformer-base (the
    copying serve checkpoint, ``serve_weights``; ``model``, its 2+2 cut
    for the decode surface) at --beam-size 1 in iteration mode, 64
    slots, pages of 16 tokens, cap 128 (3 x the source), the default
    pool (every slot can hold a full-cap row: 513 pages)."""
    from marian_tpu_torch.common.config_parser import parse_options
    return parse_options(
        ["--models", str(WORK / model), "--vocabs",
         str(WORK / vocab), str(WORK / vocab),
         "--batching-mode", "iteration", "--beam-size", "1",
         "--iteration-rows", str(SERVE_ROWS), "--kv-page-len", "16",
         "--max-length", "128", "--max-length-factor-translate", "3",
         "--port", "0", "--quiet", *extra], mode="server")


def serve_sentences(seed: int, n: int):
    """``n`` sentences of 8-40 random words of the 32,000-word vocab."""
    rng = np.random.RandomState(seed + 5)
    return [" ".join(f"w{i}"
                     for i in rng.randint(2, VOCAB, rng.randint(8, 41)))
            for _ in range(n)]


async def serve_traffic(port: int, sents, clients: int):
    """``clients`` concurrent clients over MTPU framing, each sending its
    share of ``sents`` as one-line requests back to back, one connection
    a request (a connection carries one request at a time), so every
    sentence is in the server at once; returns the replies in sentence
    order and the request latencies (s)."""
    replies, lat = [None] * len(sents), []

    async def request(i):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            payload = sents[i].encode("utf-8")
            t0 = time.perf_counter()
            writer.write(b"MTPU %d\n" % len(payload) + payload)
            await writer.drain()
            header = await reader.readline()
            check(header.startswith(b"MTPU "), f"reply header {header!r}")
            body = await reader.readexactly(int(header.split()[1]))
            lat.append(time.perf_counter() - t0)
            replies[i] = body.decode("utf-8")
        finally:
            writer.close()

    async def client(c):
        await asyncio.gather(*[request(i)
                               for i in range(c, len(sents), clients)])
    await asyncio.gather(*[client(c) for c in range(clients)])
    return replies, lat


def engine_step_logits(engine, sents):
    """``engine.decode_texts(sents)`` with the logits of every decode step
    kept: (texts, per sentence the [steps, V] logits its row got, in step
    order). The model's step is wrapped for the run and reads, as it is
    called, which sentence sits in each slot and at what position (one
    step a round)."""
    check(engine.steps_per_round == 1, "the logit record reads one step a "
          "round")
    model, rows = engine.model, {}
    step = model.step

    def recorded(params, state, prev, src_mask, beam_src=None, **kw):
        logits, new = step(params, state, prev, src_mask, beam_src, **kw)
        for i, p in enumerate(state["pos"].tolist()):
            slot = engine._slots[i]
            if slot is not None:
                rows.setdefault(slot.key, {})[p] = logits[i]
        return logits, new
    model.step = recorded
    try:
        texts = engine.decode_texts(sents)
    finally:
        del model.step
    check(all(sorted(rows[k]) == list(range(len(rows[k])))
              for k in range(len(sents))), "a row skipped a position")
    return texts, [torch.stack([rows[k][p] for p in range(len(rows[k]))])
                   for k in range(len(sents))]


def source_batch(tr, sents, device):
    """[B, W] ids (with EOS) and mask of ``sents``, W the widest."""
    ids = [tr.src_vocab.encode(t) for t in sents]
    width = max(len(x) for x in ids)
    src = torch.zeros((len(ids), width), dtype=torch.long)
    mask = torch.zeros((len(ids), width))
    for i, x in enumerate(ids):
        src[i, :len(x)] = torch.tensor(x)
        mask[i, :len(x)] = 1.0
    return ids, src.to(device), mask.to(device)


def dense_step_logits(model, params, src, mask, forced, fused=False):
    """The dense decode's logits [B, T, V] on the tokens ``forced`` [B, T]
    (step t reads token t-1; 0 at step 0). ``fused``: each row its own
    beam under the fused decode contract (identity backpointers), so the
    card reads its caches through decode_attention, as the beam search
    does."""
    rows = (torch.arange(forced.shape[0], dtype=torch.int32,
                         device=src.device) if fused else None)
    with torch.inference_mode():
        enc = model.encode_for_decode(params, src, mask)
        state = model.start_state(params, enc, mask, forced.shape[1])
        prev = torch.zeros_like(forced[:, :1])
        out = []
        for t in range(forced.shape[1]):
            logits, state = model.step(params, state, prev, mask,
                                       beam_src=rows)
            out.append(logits)
            prev = forced[:, t:t + 1]
        return torch.stack(out, 1)


def served_vs_dense_logits(engine, tr, sents, replies) -> float:
    """The engine's logits at every step of every row against the dense
    step's on the same tokens (the engine's own picks), on the card; the
    engine's texts must equal ``replies``. Returns the largest |diff|."""
    texts, got = engine_step_logits(engine, sents)
    check(texts == replies, "the engine's decode_texts differs from the "
          "served replies")
    _, src, mask = source_batch(tr, sents, engine.device)
    forced = torch.zeros((len(got), max(len(g) for g in got)),
                         dtype=torch.long, device=engine.device)
    for i, g in enumerate(got):
        forced[i, :len(g)] = g.argmax(-1)
    dense = dense_step_logits(tr.model, tr.params, src, mask, forced)
    err = max((g - dense[i, :len(g)]).abs().max().item()
              for i, g in enumerate(got))
    check(err <= SERVE_LOGIT_TOL, f"served logits differ from the dense "
          f"step's by {err} > {SERVE_LOGIT_TOL}")
    return err


def serve_counted(app, sents, warm, stats, on_warm=None, traffic=None):
    """The counted run of a serve main path: ``app`` (a ServingApp) on a
    TCP listener in this process answers the ``warm`` sentences (not
    counted; ``on_warm()`` runs after them), then ``sents`` from
    SERVE_CLIENTS clients (or ``traffic(port)``, which returns replies
    and latencies as serve_traffic does) with every launch count set to 0 just
    before and read just after (the device worker thread's work
    synchronized first); then it drains and shuts down. Returns
    (replies, latencies, seconds, counts, the change of each of
    ``stats()``'s counters over the counted run)."""
    from marian_tpu_torch.server.server import _make_tcp_handler

    async def serve():
        app.start()
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            await serve_traffic(port, warm, len(warm))
            if on_warm is not None:
                on_warm()
            before = stats()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if traffic is None:
                replies, lat = await serve_traffic(port, sents,
                                                   SERVE_CLIENTS)
            else:
                replies, lat = await traffic(port)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            after = stats()
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return replies, lat, secs, counts, {k: after[k] - before.get(k, 0)
                                            for k in after}
    replies, lat, secs, counts, run = asyncio.run(serve())
    flat = [r for x in replies
            for r in (x if isinstance(x, tuple) or x is None else (x,))]
    check(all(r is not None and not r.startswith("!!") for r in flat),
          "a request failed: " + str([r for r in flat
                                      if r is None or r.startswith("!!")][:2]))
    return replies, lat, secs, counts, run


def phase_serve_main_path(seed: int) -> dict:
    """The serve main path: the port's marian-server (ServingApp on a TCP
    listener, in this process so the launch counts can be read) answers
    SERVE_SENTENCES sentences from SERVE_CLIENTS concurrent clients with
    the copying serve model. Every reply must equal the dense greedy
    decode of its sentence on the card, cut at its cap; the engine's
    logits at every step must equal the dense step's within
    SERVE_LOGIT_TOL; and the traffic must be what it claims (most rows
    leave at their own EOS, replies as varied as their sources)."""
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.translator.greedy import greedy_decode
    sents = serve_sentences(seed, SERVE_SENTENCES)
    app = ServingApp(serve_options())
    check(app.scheduler.engine.device.type == "cuda",
          f"server resolved {app.scheduler.engine.device}")
    replies, lat, secs, counts, run = serve_counted(
        app, sents, serve_sentences(seed + 1, 4),
        lambda: dict(app.scheduler.engine.counters))
    engine = app.scheduler.engine
    check(engine.idle() and engine.pool.free_pages()
          == engine.pool.usable_pages and engine.pool.claims() == {},
          f"pages held after the run: {engine.pool.claims()}")
    bad = engine.audit()
    check(bad == [], f"pool audit after the run: {bad}")
    depth = engine.model.cfg.dec_depth
    want = {name: 0 for name in counts}
    want["paged_decode_attention"] = depth * run["steps"]
    want["packed_attention"] = engine.model.cfg.enc_depth * run["encodes"]
    check(counts == want, f"serve launches {counts}, expected {want} "
          f"({run['steps']} steps, {run['encodes']} encoder calls)")
    check(run["mid_decode_joins"] > 0, "no join landed mid-decode")
    # the dense comparator: greedy_decode of all sentences at the largest
    # cap, each row cut at its own cap and EOS
    tr = app.service.translator
    ids, src, mask = source_batch(tr, sents, engine.device)
    caps = [engine.decode_cap(len(x)) for x in ids]
    dense = greedy_decode(tr.model, tr.params, src, mask, max(caps))
    for i, (reply, cap) in enumerate(zip(replies, caps)):
        toks = list(dense[i, :cap])
        toks = toks[:toks.index(0)] if 0 in toks else toks
        check(reply == tr.trg_vocab.decode(toks),
              f"sentence {i}: the served reply differs from the dense greedy "
              f"decode on the card")
    words = [r.split() for r in replies]
    n_words = sum(len(w) for w in words)
    at_eos = sum(len(w) < cap for w, cap in zip(words, caps))
    distinct = len({t for w in words for t in w})
    copies = sum(r == s for r, s in zip(replies, sents))
    check(4 * at_eos >= 3 * len(sents) and 2 * distinct >= n_words,
          f"the traffic is degenerate: {at_eos} of {len(sents)} rows left at "
          f"EOS before their cap, {distinct} distinct words of {n_words}")
    logit_err = served_vs_dense_logits(engine, tr, sents, replies)
    lat_ms = np.percentile(np.array(lat) * 1e3, [50, 99])
    cfg = engine.model.cfg
    print(f"serve main path: transformer {cfg.enc_depth}+{cfg.dec_depth}, "
          f"dim {cfg.dim_emb}, vocab {len(tr.trg_vocab)}, copying weights, "
          f"greedy, {SERVE_ROWS} slots, pages of 16, pool "
          f"{engine.pool.usable_pages} pages: {len(sents)} sentences of "
          f"8-40 words (caps {min(caps)}-{max(caps)}) from {SERVE_CLIENTS} "
          f"clients in {secs:.3f} s: {len(sents) / secs:.2f} sentences/s, "
          f"{n_words / secs:.1f} target tokens/s; {run['rounds']} rounds, "
          f"{1e3 * run['round_s'] / run['rounds']:.3f} ms per round (engine), "
          f"{1e3 * secs / run['rounds']:.3f} ms per round (wall), "
          f"{run['rows'] / run['rounds']:.2f} rows per round, "
          f"{run['steps']} steps, {run['mid_decode_joins']} mid-decode "
          f"joins, {run['encodes']} encoder calls; latency p50 "
          f"{lat_ms[0]:.1f} ms p99 {lat_ms[1]:.1f} ms; launches {counts}")
    print(f"serve main path: replies equal the dense greedy decode; "
          f"{at_eos} of {len(sents)} rows left at EOS before their cap, "
          f"{copies} replies equal their source, {distinct} distinct words "
          f"of {n_words}; reply 0 {replies[0][:48]!r}...; engine logits vs "
          f"the dense step's on its tokens: max |diff| {logit_err:.3g} "
          f"(tolerance {SERVE_LOGIT_TOL}); pool empty, audit clean")
    return counts


def phase_serve_card_vs_cpu(seed: int) -> None:
    """SERVE_CUT of the served sentences through the engine on the card
    and on the CPU: identical texts, and logits at every step within
    SERVE_LOGIT_TOL."""
    from marian_tpu_torch.server.server import ServingApp
    sents = serve_sentences(seed, SERVE_CUT)
    res = {}
    for name, dev in (("cuda", None), ("cpu", "cpu")):
        app = ServingApp(serve_options(), device=dev)
        engine = app.scheduler.engine
        check(engine.device.type == name, f"{name} run resolved "
              f"{engine.device}")
        t0 = time.perf_counter()
        texts, logits = engine_step_logits(engine, sents)
        res[name] = texts, [g.cpu() for g in logits]
        print(f"serve card vs cpu: {name} engine, {len(sents)} sentences: "
              f"{time.perf_counter() - t0:.2f} s, {engine.counters['rounds']} "
              f"rounds")
    (gt, gl), (ct, cl) = res["cuda"], res["cpu"]
    check(gt == ct, "served texts differ between the card and the CPU")
    err = max((g - c).abs().max().item() for g, c in zip(gl, cl))
    check(err <= SERVE_LOGIT_TOL, f"served logits differ between the "
          f"card and the CPU by {err} > {SERVE_LOGIT_TOL}")
    print(f"serve card vs cpu: {len(sents)} texts identical "
          f"({sum(len(t.split()) for t in ct)} words); logits max |diff| "
          f"{err:.3g} (tolerance {SERVE_LOGIT_TOL})")


def request_options(*extra: str, model: str = "serve.npz"):
    """marian-server flags of the request-mode serve path: the server's
    defaults (--batching-mode request, --beam-size 12), the copying serve
    checkpoint (``model``), --mini-batch REQUEST_MINI_BATCH (the token
    budget: 16 x the 192-token bucket of --max-length 128 + 1)."""
    from marian_tpu_torch.common.config_parser import parse_options
    return parse_options(
        ["--models", str(WORK / model), "--vocabs",
         str(WORK / "vocab.yml"), str(WORK / "vocab.yml"),
         "--mini-batch", str(REQUEST_MINI_BATCH), "--max-length", "128",
         "--max-length-factor-translate", "3", "--port", "0", "--quiet",
         *extra], mode="server")


def beam_margins(tr, sents) -> list:
    """The gap between the best and the second normalized score of each
    of ``sents`` alone in ``tr``'s dense beam search: how near a decode
    whose reply differs was to a tie."""
    from marian_tpu_torch.translator.beam_search import (BeamConfig,
                                                         beam_search)
    out = []
    for sent in sents:
        _, src, mask = source_batch(tr, [sent], tr.device)
        cfg = BeamConfig.from_options(tr.options, tr.search.max_length_cap)
        with torch.inference_mode():
            norm = beam_search(tr.model, tr.params, cfg, src, mask)[3]
        top = norm[0].sort(descending=True).values
        out.append(float(top[0] - top[1]))
    return out


def phase_request_serve_main_path(seed: int, *extra: str,
                                  n: int = SERVE_SENTENCES,
                                  encoder: str = "packed_attention",
                                  what: str = "request serve") -> dict:
    """The request-mode serve path, the server's default: n sentences of
    8-40 words from SERVE_CLIENTS clients through the token-budget
    scheduler into the dense beam search at beam 12 (``extra``: more
    flags, BF16_FLAGS for the bf16 cut). Every reply must equal the
    port's Translate.run of the same sentences on the card (other
    batches); decode_attention launches dec_depth x steps, the encoder's
    kernel (``encoder``) enc_depth x batches, no other kernel."""
    from marian_tpu_torch.server.server import ServingApp
    sents = serve_sentences(seed, n)
    app = ServingApp(request_options(*extra))
    tr, sched = app.service.translator, app.scheduler
    check(tr.device.type == "cuda", f"server resolved {tr.device}")
    replies, lat, secs, counts, run = serve_counted(
        app, sents, serve_sentences(seed + 1, 4),
        lambda: {**sched.counts, "steps": sum(tr.search.steps),
                 "searches": len(tr.search.steps)})
    cfg = tr.model.cfg
    beam = int(tr.options.get("beam-size"))
    check(run["searches"] == run["batches"], f"{run['searches']} device "
          f"batches for {run['batches']} scheduler batches")
    want = {name: 0 for name in counts}
    want["decode_attention"] = cfg.dec_depth * run["steps"]
    want[encoder] = cfg.enc_depth * run["batches"]
    check(counts == want, f"{what} launches {counts}, expected {want} "
          f"({run['steps']} steps, {run['batches']} batches)")
    t0 = time.perf_counter()
    ref = tr.run(sents, io.StringIO())
    ref_s = time.perf_counter() - t0
    bad = [i for i, (r, w) in enumerate(zip(replies, ref)) if r != w]
    if bad:
        fail(f"{what}: {len(bad)} replies differ from Translate.run on the "
             f"card (sentences {bad[:8]}; best-second score margins alone "
             f"{beam_margins(tr, [sents[i] for i in bad[:8]])})")
    lat_ms = np.percentile(np.array(lat) * 1e3, [50, 99])
    print(f"{what} main path: transformer {cfg.enc_depth}+{cfg.dec_depth}, "
          f"dim {cfg.dim_emb}, {str(cfg.compute_dtype)[6:]}, vocab "
          f"{len(tr.trg_vocab)}, copying weights, request mode, beam {beam}, "
          f"token budget {sched.token_budget}: {len(sents)} sentences of "
          f"8-40 words from {SERVE_CLIENTS} clients in {secs:.3f} s: "
          f"{len(sents) / secs:.2f} sentences/s; {run['batches']} batches, "
          f"{run['batch_rows'] / run['batches']:.2f} sentences per batch, "
          f"fill {run['batch_tokens'] / run['batch_capacity']:.3f} (real "
          f"tokens over padded), {run['steps']} decode steps, "
          f"{1e3 * secs / run['steps']:.3f} ms per step (wall); latency p50 "
          f"{lat_ms[0]:.1f} ms p99 {lat_ms[1]:.1f} ms; launches {counts}")
    print(f"{what} main path: replies equal Translate.run of the same "
          f"sentences on the card ({ref_s:.3f} s, {len(sents)} sentences in "
          f"its own batches); reply 0 {replies[0][:48]!r}...")
    return counts


def beam_serve_options(*extra: str, merge: Optional[str] = "host",
                       model: str = SERVE_CUT_MODEL,
                       vocab: str = "vocab.yml"):
    """The serve path's flags at --beam-size SERVE_BEAM, with
    ``--iteration-beam-merge merge`` (None: no merge flag, the server's
    default, the fused merge). Every sentence of the traffic queues at
    once, each priced at its trunk plus 5 partial pages (about 11 pages,
    2,800 in all): the queue's page bound is raised past the default 4 x
    the pool."""
    merge_flags = ("--iteration-beam-merge", merge) if merge else ()
    return serve_options("--beam-size", str(SERVE_BEAM), *merge_flags,
                         "--max-queue-pages", "8192", *extra, model=model,
                         vocab=vocab)


def record_beam_rounds(engine) -> dict:
    """Wraps ``engine.admit_and_step`` for the run: the finished rows'
    info (raw scores) by source text, and the largest page refcount seen
    after a round."""
    seen = {"max_ref": 0, "info": {}}
    step = engine.admit_and_step

    def recorded(joins, evicts=()):
        res = step(joins, evicts)
        seen["max_ref"] = max(seen["max_ref"],
                              engine.pool.alias_stats()["max"])
        seen["info"].update({u.text: i for u, i in res.finished_info.items()})
        return res
    engine.admit_and_step = recorded
    return seen


# the dense beam search's best hypothesis of a served sentence, by
# ((compute dtype, model file), sentence): every beam serve phase holds
# its replies to it, and a sentence is searched once a run
DENSE_BEAM = {}
# the beam serve runs' figures by name, for the lines that set the fused
# merge beside the host merge
BEAM_RUNS = {}


def dense_beam_best(tr, sents, caps, engine) -> list:
    """The best hypothesis of each of ``sents`` in the port's dense beam
    search on the card at ``engine``'s beam, normalization and decode
    caps (``caps``: sentences of one cap decode in one batch), from
    DENSE_BEAM where a phase searched it before (with the same model
    file and compute dtype)."""
    from marian_tpu_torch.translator.beam_search import (BeamConfig,
                                                         BeamSearch,
                                                         beam_search)
    dtype = (str(tr.model.cfg.compute_dtype), tr.options.get("models")[0])
    groups = {}
    for i, cap in enumerate(caps):
        if (dtype, sents[i]) not in DENSE_BEAM:
            groups.setdefault(cap, []).append(i)
    for cap, idx in sorted(groups.items()):
        _, src, mask = source_batch(tr, [sents[i] for i in idx], tr.device)
        cfg = BeamConfig(beam_size=engine.beam_size,
                         normalize=engine.normalize,
                         word_penalty=engine.word_penalty,
                         allow_unk=engine.allow_unk, max_length=cap)
        with torch.inference_mode():
            res = beam_search(tr.model, tr.params, cfg, src, mask)
        best = BeamSearch._collect(*(x.cpu().numpy() for x in res[:4]), cfg)
        for row, i in enumerate(idx):
            DENSE_BEAM[dtype, sents[i]] = best[row][0]
    return [DENSE_BEAM[dtype, t] for t in sents]


def beam_serve_run(what: str, seed: int, sents, flags, encoder: str,
                   guard: bool = False, pressured: bool = False) -> dict:
    """One beam serve run: ``sents`` from SERVE_CLIENTS clients into the
    copy-on-write beam engine built from ``flags`` (beam_serve_options).
    Every reply must equal the best hypothesis of the dense beam search on
    the card at its decode cap, with raw scores within
    SERVE_BEAM_SCORE_TOL (f32; printed in bf16); paged_decode_attention
    launches dec_depth x steps, the encoder's kernel enc_depth x encoder
    calls; a join lands mid-decode, hypotheses fork and pages are shared,
    no sentence is evicted; the pool ends empty and its audit clean. A
    fused engine: ``guard`` runs its step loops under
    ``torch.cuda.set_sync_debug_mode("error")`` from the counted run on
    (the warm-up round outside, where kernels build), so a host sync
    inside a round fails the run; its rounds fall back to the host merge
    (``fused_fallback_rounds``) only when ``pressured``. Returns the
    launch counts."""
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.translator.beam_iteration import PagedBeamEngine
    app = ServingApp(flags)
    engine = app.scheduler.engine
    check(isinstance(engine, PagedBeamEngine)
          and engine.device.type == "cuda", f"{what}: engine "
          f"{type(engine).__name__} on {engine.device}")
    seen = record_beam_rounds(engine)

    def arm():
        engine.sync_debug = "error" if guard else None
    replies, lat, secs, counts, run = serve_counted(
        app, sents, serve_sentences(seed + 1, 4),
        lambda: dict(engine.counters), on_warm=arm)
    engine.sync_debug = None
    check(engine.idle() and engine.pool.free_pages()
          == engine.pool.usable_pages and engine.pool.refcounts() == {},
          f"{what}: pages held after the run: {engine.pool.claims()}")
    bad = engine.audit()
    check(bad == [], f"{what}: pool audit after the run: {bad}")
    cfg = engine.model.cfg
    want = {name: 0 for name in counts}
    want["paged_decode_attention"] = cfg.dec_depth * run["steps"]
    want[encoder] = cfg.enc_depth * run["encodes"]
    check(counts == want, f"{what} launches {counts}, expected {want} "
          f"({run['steps']} steps, {run['encodes']} encoder calls)")
    fallback = run["fused_fallback_rounds"]
    check(run["mid_decode_joins"] > 0 and run["forks"] > 0
          and seen["max_ref"] >= 2 and run["pool_evictions"] == 0
          and (fallback > 0 if pressured else fallback == 0)
          and (engine.merge == "host" or run["rounds"] > fallback),
          f"{what}: {run['mid_decode_joins']} mid-decode joins, "
          f"{run['forks']} forks, largest refcount {seen['max_ref']}, "
          f"{run['pool_evictions']} pool evictions, {fallback} of "
          f"{run['rounds']} rounds through the host-merge fallback")
    tr = app.service.translator
    caps = [engine.decode_cap(len(tr.src_vocab.encode(t))) for t in sents]
    t0 = time.perf_counter()
    dense = dense_beam_best(tr, sents, caps, engine)
    dense_s = time.perf_counter() - t0
    differ = [i for i, (r, d) in enumerate(zip(replies, dense))
              if r != tr.trg_vocab.decode(d["tokens"], ignore_eos=True)]
    check(not differ, f"{what}: {len(differ)} replies differ from the "
          f"dense beam search on the card (sentences {differ[:8]})")
    err = max(abs(seen["info"][t]["score"] - d["score"])
              for t, d in zip(sents, dense))
    f32 = cfg.compute_dtype == torch.float32
    check(not f32 or err <= SERVE_BEAM_SCORE_TOL, f"{what}: raw scores "
          f"differ from the dense search's by {err} > {SERVE_BEAM_SCORE_TOL}")
    lat_ms = np.percentile(np.array(lat) * 1e3, [50, 99])
    n_words = sum(len(r.split()) for r in replies)
    merge = (f"{engine.merge} merge, {engine.steps_per_round} steps a round"
             + (" under the sync guard" if guard else ""))
    BEAM_RUNS[what] = {
        "sentences/s": len(sents) / secs, "rounds": run["rounds"],
        "engine ms": 1e3 * run["round_s"] / run["rounds"],
        "wall ms": 1e3 * secs / run["rounds"],
        "steps": run["steps"], "merge": merge}
    print(f"{what} main path: transformer {cfg.enc_depth}+{cfg.dec_depth}, "
          f"dim {cfg.dim_emb}, {str(cfg.compute_dtype)[6:]} (pools "
          f"{str(engine._state['l1_pool_k'].dtype)[6:]}), copying weights, "
          f"beam {engine.beam_size}, {merge}, {engine.max_rows} slots, "
          f"pages of {engine.page_len}, pool {engine.pool.usable_pages} "
          f"pages: {len(sents)} sentences from {SERVE_CLIENTS} clients in "
          f"{secs:.3f} s: {len(sents) / secs:.2f} sentences/s, "
          f"{n_words / secs:.1f} target tokens/s; {run['rounds']} rounds "
          f"({fallback} through the host-merge fallback), {run['steps']} "
          f"steps, {1e3 * run['round_s'] / run['rounds']:.3f} ms per round "
          f"(engine), {1e3 * secs / run['rounds']:.3f} ms (wall), "
          f"{run['rows'] / run['rounds']:.2f} live rows per round, "
          f"{run['mid_decode_joins']} mid-decode joins, {run['forks']} "
          f"forks ({run['copied_pages']} partial pages copied), largest "
          f"refcount {seen['max_ref']}, {run['encodes']} encoder calls; "
          f"latency p50 {lat_ms[0]:.1f} ms p99 {lat_ms[1]:.1f} ms; launches "
          f"{counts}")
    print(f"{what} main path: replies equal the dense beam search's best "
          f"hypotheses on the card ({dense_s:.3f} s, {len(set(caps))} cap "
          f"groups); raw scores max |diff| {err:.3g}"
          + (f" (tolerance {SERVE_BEAM_SCORE_TOL})" if f32 else
             " (bf16: tokens held, scores printed)")
          + "; pool empty, audit clean")
    return counts


def add_counts(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def phase_beam_serve_main_path(seed: int, *extra: str,
                               n: int = SERVE_SENTENCES,
                               encoder: str = "packed_attention",
                               what: str = "beam serve") -> dict:
    """The iteration beam path with the host merge (beam SERVE_BEAM, 64
    slots, pages of 16; ``extra``: BF16_FLAGS for the bf16 cut): n
    sentences through ``beam_serve_run``."""
    return beam_serve_run(what, seed, serve_sentences(seed, n),
                          beam_serve_options(*extra), encoder)


def phase_fused_beam_serve_main_path(seed: int) -> dict:
    """The server's own default at beam > 1 in iteration mode, the fused
    on-device merge (no --iteration-beam-merge flag), at --iteration-steps
    1 and then FUSED_STEPS, each over the beam serve path's 256
    sentences from 16 clients, every step loop under the sync guard (one
    host sync a round), no round through the fallback at the default
    pool; both runs' figures beside the host merge's."""
    sents = serve_sentences(seed, SERVE_SENTENCES)
    # the guard is live: a host sync under it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
        fail("torch.cuda.set_sync_debug_mode('error') let .item() pass")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = [beam_serve_run(
        f"fused beam serve, steps {steps}", seed, sents,
        beam_serve_options("--iteration-steps", str(steps), merge=None),
        "packed_attention", guard=True) for steps in (1, FUSED_STEPS)]
    host = BEAM_RUNS["beam serve"]
    for name in ("beam serve", "fused beam serve, steps 1",
                 f"fused beam serve, steps {FUSED_STEPS}"):
        r = BEAM_RUNS[name]
        print(f"beam serve merges: {name} ({r['merge']}): {r['rounds']} "
              f"rounds of {r['engine ms']:.3f} ms (engine), "
              f"{r['wall ms']:.3f} ms (wall), {r['steps']} steps, "
              f"{r['sentences/s']:.2f} sentences/s "
              f"({r['sentences/s'] / host['sentences/s']:.2f}x the host "
              f"merge's)")
    return add_counts(*counts)


class Wedge:
    """A one-shot host stall on a device call: ``wrap(fn, picks)`` calls
    ``fn``, but the first call that ``picks(*args)`` chooses waits on
    ``release`` first (or, with ``wait_first`` False, runs with
    ``in_round`` set, for a wrapper inside ``fn`` to wait); ``done`` is
    set when that call has returned."""

    def __init__(self):
        self.release, self.done = threading.Event(), threading.Event()
        self.armed = True
        self.in_round = False

    def wrap(self, fn, picks, wait_first: bool = True):
        def call(*args):
            if not (self.armed and picks(*args)):
                return fn(*args)
            self.armed = False
            self.in_round = True
            try:
                if wait_first:
                    self.release.wait(STALL_WAIT_S)
                return fn(*args)
            finally:
                self.in_round = False
                self.done.set()
        return call

    def finish(self) -> None:
        """Release the wedged call and wait for it to return."""
        self.release.set()
        check(self.done.wait(STALL_WAIT_S),
              "the abandoned device call did not return")


def stall_traffic(app, warm: list, stall: str, following: list,
                  on_warm=None):
    """``app`` on a TCP listener: the ``warm`` requests (``on_warm()``
    after them), the ``stall`` request alone, then the following
    requests from STALL_FOLLOWING clients. Returns (the stall reply, the
    CUDA sync-debug mode after it, the card's allocated bytes then, the
    following replies)."""
    from marian_tpu_torch.server.server import _make_tcp_handler

    async def serve():
        app.start()
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            await serve_traffic(port, warm, len(warm))
            if on_warm is not None:
                on_warm()
            (stalled,), _ = await serve_traffic(port, [stall], 1)
            mode = torch.cuda.get_sync_debug_mode()
            alloc = torch.cuda.memory_allocated()
            replies, _ = await serve_traffic(port, following,
                                             STALL_FOLLOWING)
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return stalled, mode, alloc, replies
    return asyncio.run(serve())


def engine_pool_bytes(engine) -> int:
    """The bytes of an engine's paged KV pools (every layer, K and V)."""
    return sum(t.numel() * t.element_size()
               for k, t in engine._state.items() if "_pool_" in k)


def abandoned_bytes(alloc: int) -> int:
    """What the card freed once the abandoned engine was dropped: the
    allocation at the trip (both engines alive) less the allocation
    now."""
    gc.collect()
    return alloc - torch.cuda.memory_allocated()


def check_stall(what: str, app, stalled: str, mode: int, replies) -> None:
    sched = app.scheduler
    check(stalled.startswith("!!SERVER-RETRY ")
          and "stalled past" in stalled, f"{what}: the stalled request's "
          f"reply {stalled[:80]!r}")
    check(sched.counts["watchdog_trips"] == 1, f"{what}: "
          f"{sched.counts['watchdog_trips']} watchdog trips")
    check(mode == 0, f"{what}: sync-debug mode {mode} after the trip")
    check(all(not r.startswith("!!") for r in replies),
          f"{what}: a following request failed: "
          f"{[r for r in replies if r.startswith('!!')][:2]}")


def phase_watchdog_serve(seed: int) -> None:
    """The dispatch watchdog (--dispatch-stall-timeout STALL_TIMEOUT_S)
    on the serve model at full width: one request's device call is
    wedged on a host event past the timeout, in request mode (the
    translate call), iteration greedy (the engine round) and the fused
    beam merge (inside the round's sync-debug guard, mode "error"). Its
    reply is !!SERVER-RETRY, the scheduler trips once, the sync-debug
    mode is back to default, and STALL_FOLLOWING requests are served on
    the fresh worker, each equal to Translate.run (request mode) or the
    dense greedy or beam decode (iteration mode, on the rebuilt engine,
    whose pool then audits clean: its rounds run outside the guard, so a
    mode left at "error" would fail their host syncs); the wedged call
    is released and returns last. Each server answers two warm-up
    requests first; the fused engine's guard is armed after them (its
    first round stays outside, as in beam_serve_run). The flight
    recorder is armed (--trace-dump, a directory a mode): each trip
    writes one flight file holding the trip's event, the span ring and
    a /metrics snapshot (``flight_of``); the iteration modes' files the
    pool's page map too."""
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.translator.greedy import greedy_decode
    stall = serve_sentences(seed + 9, 1)[0]
    following = serve_sentences(seed + 10, STALL_FOLLOWING)
    warm = serve_sentences(seed + 1, 2)
    flag = ("--dispatch-stall-timeout", str(STALL_TIMEOUT_S))
    lines = []

    def dump_flags(mode: str):
        dump = WORK / f"flight_watchdog_{mode}"
        shutil.rmtree(dump, ignore_errors=True)
        return ("--trace-dump", str(dump))

    # request mode: the translate call of the stalled request's batch
    app = ServingApp(request_options(*flag, *dump_flags("request"),
                                     model=SERVE_CUT_MODEL))
    sched, tr = app.scheduler, app.service.translator
    wedge = Wedge()
    real = sched.translate_lines
    sched.translate_lines = wedge.wrap(real, lambda batch: stall in batch)
    t0 = time.perf_counter()
    stalled, mode, _, replies = stall_traffic(app, warm, stall, following)
    wedge.finish()
    check_stall("request mode", app, stalled, mode, replies)
    flight_of("request mode", WORK / "flight_watchdog_request")
    ref = tr.run(following, io.StringIO())
    check(replies == ref, "request mode: replies after the trip differ from "
          "Translate.run on the card")
    lines.append(f"request mode (beam {tr.options.get('beam-size')}) "
                 f"{time.perf_counter() - t0:.2f} s")
    del app, sched, tr, real

    # iteration greedy: the engine round that joins the stalled request
    app = ServingApp(serve_options(*flag, *dump_flags("greedy"),
                                   model=SERVE_CUT_MODEL))
    old = app.scheduler.engine
    wedge = Wedge()
    step = old.admit_and_step
    old.admit_and_step = wedge.wrap(
        step, lambda joins, evicts: any(t == stall for _, t, _ in joins))
    t0 = time.perf_counter()
    stalled, mode, alloc, replies = stall_traffic(app, warm, stall,
                                                  following)
    engine = app.scheduler.engine
    wedge.finish()
    check_stall("iteration greedy", app, stalled, mode, replies)
    check("pool" in flight_of("iteration greedy",
                              WORK / "flight_watchdog_greedy"),
          "iteration greedy: the flight file lacks the pool's page map")
    check(engine is not old and engine.idle() and engine.pool.free_pages()
          == engine.pool.usable_pages and engine.audit() == [],
          "iteration greedy: the rebuilt engine's pool after the run: "
          f"{engine.pool.claims()}, audit {engine.audit()}")
    tr = app.service.translator
    ids, src, mask = source_batch(tr, following, engine.device)
    caps = [engine.decode_cap(len(x)) for x in ids]
    dense = greedy_decode(tr.model, tr.params, src, mask, max(caps))
    for i, (reply, cap) in enumerate(zip(replies, caps)):
        toks = list(dense[i, :cap])
        toks = toks[:toks.index(0)] if 0 in toks else toks
        check(reply == tr.trg_vocab.decode(toks), f"iteration greedy: "
              f"reply {i} after the trip differs from the dense greedy "
              f"decode")
    del old, step
    lines.append(f"iteration greedy {time.perf_counter() - t0:.2f} s, the "
                 f"wedged engine held {abandoned_bytes(alloc) / 2**20:.1f} "
                 f"MiB beside the rebuilt one until its round returned "
                 f"(a pool of {engine_pool_bytes(engine) / 2**20:.1f} MiB)")
    del app, engine, tr

    # the fused beam merge: the wedge inside the round's sync guard
    app = ServingApp(beam_serve_options("--iteration-steps",
                                        str(FUSED_STEPS), *flag,
                                        *dump_flags("fused"), merge=None))
    sched = app.scheduler
    old = sched.engine
    wedge = Wedge()
    guard = old._sync_guard
    inside = []             # the mode the wedged round waited under

    @contextlib.contextmanager
    def wedged_guard():
        with guard():
            if wedge.in_round and not inside:
                inside.append(torch.cuda.get_sync_debug_mode())
                wedge.release.wait(STALL_WAIT_S)
            yield
    old._sync_guard = wedged_guard
    old.admit_and_step = wedge.wrap(
        old.admit_and_step,
        lambda joins, evicts: any(t == stall for _, t, _ in joins),
        wait_first=False)
    t0 = time.perf_counter()
    stalled, mode, alloc, replies = stall_traffic(
        app, warm, stall, following,
        on_warm=lambda: setattr(old, "sync_debug", "error"))
    engine = sched.engine
    wedge.finish()
    check_stall("fused beam", app, stalled, mode, replies)
    check("pool" in flight_of("fused beam", WORK / "flight_watchdog_fused"),
          "fused beam: the flight file lacks the pool's page map")
    check(inside == [2], f"fused beam: the wedged round waited under "
          f"sync-debug modes {inside}, not once under 'error' (2)")
    check(torch.cuda.get_sync_debug_mode() == 0, "fused beam: the "
          "abandoned guard's exit changed the sync-debug mode")
    check(engine is not old and engine.sync_debug is None
          and engine.idle() and engine.pool.free_pages()
          == engine.pool.usable_pages and engine.audit() == [],
          "fused beam: the rebuilt engine's pool after the run: "
          f"{engine.pool.claims()}, audit {engine.audit()}")
    tr = app.service.translator
    caps = [engine.decode_cap(len(tr.src_vocab.encode(t)))
            for t in following]
    dense = dense_beam_best(tr, following, caps, engine)
    differ = [i for i, (r, d) in enumerate(zip(replies, dense))
              if r != tr.trg_vocab.decode(d["tokens"], ignore_eos=True)]
    check(not differ, f"fused beam: replies {differ} after the trip differ "
          f"from the dense beam search")
    del old, guard, wedged_guard
    lines.append(f"fused beam, {FUSED_STEPS} steps a round, under the sync "
                 f"guard {time.perf_counter() - t0:.2f} s, the wedged engine "
                 f"held {abandoned_bytes(alloc) / 2**20:.1f} MiB (a pool of "
                 f"{engine_pool_bytes(engine) / 2**20:.1f} MiB)")
    del app, sched, engine, tr
    obs_reset()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"watchdog serve: --dispatch-stall-timeout {STALL_TIMEOUT_S}, "
          f"serve model {SERVE_CUT_DEPTH}+{SERVE_CUT_DEPTH} cut, dim 512, "
          f"vocab {VOCAB}: one request wedged past "
          f"the timeout got !!SERVER-RETRY, 1 trip, sync-debug mode default "
          f"after it, then {STALL_FOLLOWING} requests served on the fresh "
          f"worker, replies equal Translate.run / the dense greedy / the "
          f"dense beam decode, the rebuilt engines' pools empty and "
          f"audited clean, the wedged call released and returned, one "
          f"flight file a trip (the trip's event, the span ring, "
          f"/metrics): "
          + "; ".join(lines))


def flight_of(what: str, dump: Path) -> dict:
    """The one flight file a trip wrote into ``dump`` (the recorder
    writes it on a thread of its own: waited for), checked to hold the
    trip's timeline event, the span ring and a /metrics snapshot."""
    deadline = time.perf_counter() + 30.0
    names = []
    while time.perf_counter() < deadline:
        names = sorted(n for n in os.listdir(dump) if n.startswith("flight-"))
        if names:
            break
        time.sleep(0.05)
    check(len(names) == 1 and names[0].endswith("-watchdog.json"),
          f"{what}: flight files {names}")
    with open(dump / names[0], encoding="utf-8") as fh:
        payload = json.load(fh)
    events = payload["trace"]["traceEvents"]
    # the process-wide registry's counter, summed over the modes' trips
    trips = [ln for ln in payload["metrics"].splitlines()
             if ln.startswith("marian_serving_watchdog_trips_total ")]
    check(any(e["ph"] == "i" and e["name"] == "serve.watchdog_trip"
              for e in events)
          and any(e["ph"] == "X" for e in events)
          and trips and float(trips[0].split()[1]) >= 1,
          f"{what}: the flight file lacks the trip's event, the span ring "
          f"or the watchdog counter")
    return payload


def obs_reset() -> None:
    """Every plane of the process off: the tracer (its ring freed), the
    flight recorder, the perf meter (earlier serve paths ran it on, the
    server's default)."""
    from marian_tpu_torch import obs
    obs.TRACER.reset()
    obs.TRACER.capacity = obs.trace.DEFAULT_RING
    obs.FLIGHT.disarm()
    obs.PERF.reset()


async def traced_traffic(port: int, sents, clients: int, tag: str):
    """``serve_traffic`` with a ``#trace:<tag>-<i>`` header on request
    ``i``: the replies and each request's latency (s), in sentence
    order."""
    replies, lat = [None] * len(sents), [None] * len(sents)

    async def request(i):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            payload = f"#trace:{tag}-{i:03d}\n{sents[i]}".encode("utf-8")
            t0 = time.perf_counter()
            writer.write(b"MTPU %d\n" % len(payload) + payload)
            await writer.drain()
            header = await reader.readline()
            check(header.startswith(b"MTPU "), f"reply header {header!r}")
            body = await reader.readexactly(int(header.split()[1]))
            lat[i] = time.perf_counter() - t0
            replies[i] = body.decode("utf-8")
        finally:
            writer.close()

    async def client(c):
        await asyncio.gather(*[request(i)
                               for i in range(c, len(sents), clients)])
    await asyncio.gather(*[client(c) for c in range(clients)])
    return replies, lat


def gauge(text: str, name: str) -> float:
    """The value of the one sample of ``name`` in a /metrics text."""
    vals = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
            if ln.startswith(name) and not ln.startswith("#")]
    check(len(vals) == 1, f"{name}: samples {vals}")
    return vals[0]


def obs_serve_run(what: str, seed: int, flags, sents, refs, on: bool,
                  iteration: bool) -> dict:
    """One run of the observability serve phase: ``sents`` as traced
    requests from SERVE_CLIENTS clients into a ServingApp of ``flags``
    plus every plane (``on``) or none. Every reply is its #trace: line
    over ``refs``'s text; with the planes on, /tracez, /metrics,
    /poolz and /sloz are held as the module docstring says. Returns the
    run's launch counts and figures."""
    from marian_tpu_torch.obs import poolz
    from marian_tpu_torch.server.server import ServingApp, _make_tcp_handler
    from marian_tpu_torch.serving import metrics as msm
    from marian_tpu_torch.serving.promlint import lint_metrics_text
    obs_reset()
    # the trace-id alphabet: letters, digits, "-" and "_"
    tag = "".join(c if c.isalnum() else "-" for c in what)
    mport = free_port()
    dump = WORK / f"flight_{tag}"
    shutil.rmtree(dump, ignore_errors=True)
    planes = (("--trace", "--trace-ring", str(OBS_RING), "--trace-dump",
               str(dump), "--metrics-port", str(mport),
               "--slo-availability", "0.999", "--slo-p99-ms",
               str(OBS_P99_MS)) if on else ("--perf-accounting", "false"))
    reg = msm.Registry()
    app = ServingApp(flags(*planes), registry=reg)
    sched, engine = app.scheduler, app.scheduler.engine
    tr = app.service.translator
    if iteration:
        def stats():
            return dict(engine.counters)
    else:
        def stats():
            return {**sched.counts, "steps": sum(tr.search.steps)}
    warm = serve_sentences(seed + 1, 4)

    async def serve():
        loop = asyncio.get_event_loop()
        app.start()
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        scrape = {}
        try:
            await traced_traffic(port, warm, len(warm), f"{tag}-warm")
            if iteration:
                engine.sync_debug = "error"       # the rounds' sync guard
            before = stats()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            replies, lat = await traced_traffic(port, sents, SERVE_CLIENTS,
                                                tag)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            after = stats()
            if iteration:
                engine.sync_debug = None
            if on:
                # an idle second: the busy ratio's window then covers
                # more wall clock than device time
                await asyncio.sleep(1.0)
                for path in ("/metrics", "/metrics?exemplars=1", "/tracez",
                             "/poolz?check=1", "/sloz"):
                    scrape[path] = await loop.run_in_executor(
                        None, http_get, mport, path)
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return replies, lat, secs, counts, {
            k: after[k] - before.get(k, 0) for k in after}, scrape
    replies, lat, secs, counts, run, scrape = asyncio.run(serve())
    sent = [f"{tag}-{i:03d}" for i in range(len(sents))]
    sent_warm = [f"{tag}-warm-{i:03d}" for i in range(len(warm))]
    for i, (reply, ref) in enumerate(zip(replies, refs)):
        head, _, body = reply.partition("\n")
        check(head.startswith(f"#trace:{sent[i]} outcome=ok "),
              f"{what}: reply {i}'s metadata line {head!r}")
        fields = dict(kv.split("=", 1) for kv in head.split()[1:])
        check(fields.get("model_version") == "unversioned",
              f"{what}: reply {i}'s metadata line {head!r}")
        check(body == ref, f"{what}: reply {i} differs from the reference "
              f"without its header")
        check(float(fields["queue_ms"]) + float(fields["service_ms"])
              <= 1e3 * lat[i] + 0.2, f"{what}: reply {i}: queue_ms + "
              f"service_ms over the client's {1e3 * lat[i]:.1f} ms")
        check(not iteration or int(fields["rounds"]) >= 1,
              f"{what}: reply {i} rode {fields.get('rounds')} rounds")
    cfg = tr.model.cfg
    want = {name: 0 for name in counts}
    if iteration:
        want["paged_decode_attention"] = cfg.dec_depth * run["steps"]
        want["packed_attention"] = cfg.enc_depth * run["encodes"]
        per = run["rounds"]
        unit = (f"{run['rounds']} rounds, "
                f"{1e3 * run['round_s'] / per:.3f} ms per round (engine), "
                f"{1e3 * secs / per:.3f} ms (wall)")
    else:
        want["decode_attention"] = cfg.dec_depth * run["steps"]
        want["packed_attention"] = cfg.enc_depth * run["batches"]
        per = run["batches"]
        unit = (f"{run['batches']} batches, {1e3 * secs / per:.3f} ms per "
                f"batch (wall), {run['steps']} steps")
    check(counts == want, f"{what} launches {counts}, expected {want}")
    out = {"counts": counts, "sentences/s": len(sents) / secs,
           "ms": 1e3 * secs / per, "unit": unit}
    lat_ms = np.percentile(np.array(lat) * 1e3, [50, 99])
    line = (f"{what} ({'every plane on' if on else 'every plane off'}): "
            f"{len(sents)} traced requests from {SERVE_CLIENTS} clients in "
            f"{secs:.3f} s: {len(sents) / secs:.2f} sentences/s; {unit}; "
            f"latency p50 {lat_ms[0]:.1f} ms p99 {lat_ms[1]:.1f} ms")
    if not on:
        print(line)
        return out
    for path, (code, _) in scrape.items():
        check(code == 200, f"{what}: GET {path} answered {code}")
    # /tracez: each sent id's tree, the reference's names and edges
    events = json.loads(scrape["/tracez"][1])["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["args"]["span_id"]: e["name"] for e in spans}
    trees = {}
    for e in spans:
        trees.setdefault(e["args"]["trace_id"], []).append(
            (e["name"], names.get(e["args"].get("parent_id"), "")))
    tree = sorted([("reply.write", "request"), ("request", ""),
                   ("serve.dispatch", "request"), ("serve.queue", "request")]
                  + ([("serve.row", "request")] if iteration else []))
    bad = [t for t in sent if sorted(trees.get(t, [])) != tree]
    check(not bad, f"{what}: /tracez trees of {bad[:4]}: "
          f"{[sorted(trees.get(t, [])) for t in bad[:2]]}, expected {tree}")
    own = "serve.round" if iteration else "serve.batch"
    linked = {t for e in spans if e["name"] == own
              for t in e["args"]["traces"]}
    check(set(sent) <= linked, f"{what}: requests no {own} span names")
    # /metrics: promlint, exemplars of sent ids, the request counters
    plain, with_ex = scrape["/metrics"][1], scrape["/metrics?exemplars=1"][1]
    problems = lint_metrics_text(plain) + lint_metrics_text(
        with_ex, allow_exemplars=True)
    check(not problems, f"{what}: promlint: {problems[:4]}")
    ex_ids = {ln.split('trace_id="')[1].split('"')[0]
              for ln in with_ex.splitlines()
              if ln.startswith("marian_serving_request_latency_seconds_"
                               "bucket") and "# {" in ln}
    check(ex_ids and ex_ids <= set(sent + sent_warm),
          f"{what}: latency exemplars {sorted(ex_ids)[:4]} not sent")
    n_sent = len(sent) + len(sent_warm)
    check(gauge(plain, "marian_serving_requests_total") == n_sent
          and gauge(plain, 'marian_serving_request_outcomes_total{outcome='
                    '"ok",model_version="unversioned"}') == n_sent,
          f"{what}: the request counters differ from the {n_sent} sent")
    # /poolz and /sloz
    pz = json.loads(scrape["/poolz?check=1"][1])
    if iteration:
        check(pz["enabled"] and pz["consistency"] == []
              and pz["pool"]["usable_pages"] == engine.pool.usable_pages
              and pz["pool"]["free_pages"] == engine.pool.free_pages()
              and poolz.check_consistency(pz) == [],
              f"{what}: /poolz {pz.get('consistency')}, pool "
              f"{pz.get('pool', {}).get('free_pages')} free of "
              f"{pz.get('pool', {}).get('usable_pages')}")
    else:
        check(pz["enabled"] is False, f"{what}: /poolz {pz}")
    slo = json.loads(scrape["/sloz"][1])
    check(set(slo["slo"]["objectives"]) == {"availability", "latency_p99"}
          and slo["perf"]["enabled"], f"{what}: /sloz {slo}")
    # the perf plane's gauges on the card
    mfu = gauge(plain, 'marian_perf_mfu{model_version="unversioned"}')
    busy = gauge(plain, "marian_perf_device_busy_ratio")
    headroom = gauge(plain, "marian_capacity_headroom_ratio")
    check(all(0 < v <= 1 for v in (mfu, busy, headroom)), f"{what}: perf "
          f"gauges MFU {mfu}, busy {busy}, headroom {headroom}")
    out.update(mfu=mfu, busy=busy, headroom=headroom)
    pool = (f"consistent, {pz['pool']['usable_pages']} pages" if iteration
            else "enabled: false")
    dtype = "bf16" if cfg.compute_dtype == torch.bfloat16 else "f32"
    print(f"{line}; /tracez {len(spans)} spans, every tree the "
          f"reference's; /metrics lints clean, {len(ex_ids)} exemplars of "
          f"sent ids, {n_sent} requests counted; /poolz {pool}; /sloz "
          f"{sorted(slo['slo']['objectives'])}; perf gauges: MFU "
          f"{mfu:.6g} (against the {dtype} peak), busy ratio {busy:.4f}, "
          f"headroom {headroom:.4f}")
    return out


def phase_observability_serve(seed: int, smi: str) -> dict:
    """The observability plane on the 2+2 cut (SERVE_CUT_MODEL) at full
    width: request mode (beam 12) and the fused beam merge
    (--iteration-steps FUSED_STEPS, every round's step loop under the
    sync guard), each run off, on, on, off (every plane off:
    --perf-accounting false; on: --trace, --trace-dump, --metrics-port,
    both SLOs), OBS_REQUESTS traced requests a run (obs_serve_run).
    Replies are held to Translate.run on the card (request mode) and the
    dense beam search's best hypotheses (iteration). Returns the launch
    counts of every run."""
    from marian_tpu_torch.server.server import ServingApp
    sents = serve_sentences(seed, OBS_REQUESTS)
    counts, runs = [], {}
    ref_app = ServingApp(request_options("--perf-accounting", "false",
                                         model=SERVE_CUT_MODEL))
    tr = ref_app.service.translator
    request_refs = tr.run(sents, io.StringIO())
    del ref_app, tr
    beam_flags = ("--iteration-steps", str(FUSED_STEPS))
    ref_app = ServingApp(beam_serve_options(*beam_flags, "--perf-accounting",
                                            "false", merge=None))
    engine, tr = ref_app.scheduler.engine, ref_app.service.translator
    caps = [engine.decode_cap(len(tr.src_vocab.encode(t))) for t in sents]
    beam_refs = [tr.trg_vocab.decode(d["tokens"], ignore_eos=True)
                 for d in dense_beam_best(tr, sents, caps, engine)]
    del ref_app, engine, tr
    modes = (("request mode",
              lambda *x: request_options(*x, model=SERVE_CUT_MODEL),
              request_refs, False),
             (f"fused beam, {FUSED_STEPS} steps",
              lambda *x: beam_serve_options(*beam_flags, *x, merge=None),
              beam_refs, True))
    try:
        for what, flags, refs, iteration in modes:
            for i, on in enumerate((False, True, True, False)):
                r = obs_serve_run(f"observability {what} {i + 1}", seed,
                                  flags, sents, refs, on, iteration)
                counts.append(r.pop("counts"))
                runs.setdefault((what, on), []).append(r)
    finally:
        obs_reset()
        gc.collect()
        torch.cuda.empty_cache()
    for what, _, _, _ in modes:
        off, on = runs[what, False], runs[what, True]
        ratio = (sum(r["sentences/s"] for r in on)
                 / sum(r["sentences/s"] for r in off))
        print(f"observability serve, {what} ({smi}): every plane off "
              + ", ".join(f"{r['sentences/s']:.2f}" for r in off)
              + " sentences/s, on " + ", ".join(f"{r['sentences/s']:.2f}"
                                                for r in on)
              + f" (on/off {ratio:.4f}); ms per "
              + ("round" if "beam" in what else "batch") + " off "
              + ", ".join(f"{r['ms']:.3f}" for r in off) + ", on "
              + ", ".join(f"{r['ms']:.3f}" for r in on)
              + "; gauges on: " + "; ".join(
                  f"MFU {r['mfu']:.6g}, busy {r['busy']:.4f}, headroom "
                  f"{r['headroom']:.4f}" for r in on))
    return add_counts(*counts)


def unique_sentences(seed: int, n: int):
    """``n`` distinct sentences of 8-40 random words of the vocab."""
    rng = np.random.RandomState(seed)
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(f"w{i}"
                     for i in rng.randint(2, VOCAB, rng.randint(8, 41)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def phase_brownout_serve(seed: int, smi: str) -> dict:
    """The brownout ladder on the card's own headroom gauge: iteration
    greedy, SERVE_ROWS slots, the copying weights of the 2+2 cut at full
    width, ``--brownout --brownout-hold 0.5 --brownout-cool 1`` (and
    ``--brownout-cap-factor`` BROWNOUT_CAP_FACTOR, ``--trace-dump``,
    ``--metrics-port``), every round's step loop under the sync guard.
    BROWNOUT_FLOOD closed-loop priority-0 clients and BROWNOUT_HIGH
    priority-2 clients drive the ladder 0 -> 1 -> 2 -> 3; if the flood
    does not bring the headroom gauge to the default floor of 0.1, the
    floor is set just above what the gauge reads (both printed). Held:
    one rung at a time, counted in /metrics; every joined row's cap the
    engine's rule at the scale live at its join, some scaled; every
    served reply the dense greedy decode at its row's cap; the
    priority-0 !!SERVER-RETRY replies equal to the brownout evictions
    (at least one) and the !!SERVER-OVERLOADED ones to the brownout
    sheds (at least one), priority-2 requests served at level 3; the
    ladder back at 0 and the cap scale at 1 after the traffic; one
    flight file an escalation with the ladder's state in it; /sloz with
    the ladder's state at level 3; the pool empty and audited clean."""
    from marian_tpu_torch import obs
    from marian_tpu_torch.server.server import ServingApp, _make_tcp_handler
    from marian_tpu_torch.serving import metrics as msm
    obs_reset()
    mport = free_port()
    dump = WORK / "flight_brownout"
    shutil.rmtree(dump, ignore_errors=True)
    reg = msm.Registry()
    app = ServingApp(serve_options(
        "--brownout", "--brownout-hold", "0.5", "--brownout-cool", "1",
        "--brownout-cap-factor", str(BROWNOUT_CAP_FACTOR), "--trace-dump",
        str(dump), "--metrics-port", str(mport), model=SERVE_CUT_MODEL),
        registry=reg)
    sched, engine, ladder = app.scheduler, app.scheduler.engine, app.brownout
    tr = app.service.translator
    check(engine.device.type == "cuda" and ladder is not None
          and ladder.headroom_fn is not None,
          f"brownout serve: engine on {engine.device}, ladder {ladder}")
    default_floor = ladder.headroom_floor
    # the cap each row joined with, and the scale live at its join
    joined = {}
    join_features = engine._join_features

    def record_join(key, text, res, meta):
        got = join_features(key, text, res, meta)
        if not isinstance(got, str):
            joined[text] = (got[2], engine._cap_scale)
        return got
    engine._join_features = record_join
    sents = iter(unique_sentences(seed + 11, 40000))
    done = []           # (lane, texts, reply, t_send, t_reply, level)
    timeline = []       # (t, level, headroom)
    stop = asyncio.Event()

    async def client(port, lane: int, lines: int, warm: bool = False):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            while not stop.is_set():
                texts = [next(sents) for _ in range(lines)]
                body = f"#priority:{lane}\n" + "\n".join(texts)
                payload = body.encode("utf-8")
                t0 = time.perf_counter()
                writer.write(b"MTPU %d\n" % len(payload) + payload)
                await writer.drain()
                header = await reader.readline()
                check(header.startswith(b"MTPU "), f"reply header {header!r}")
                reply = (await reader.readexactly(
                    int(header.split()[1]))).decode("utf-8")
                done.append((lane, texts, reply, t0, time.perf_counter(),
                             ladder.level(), warm))
                if warm:
                    return
                if reply.startswith("!!SERVER-OVERLOADED"):
                    await asyncio.sleep(BROWNOUT_BACKOFF_S)
        finally:
            writer.close()

    async def sampler(t0: float):
        while True:
            level = ladder.level()
            timeline.append((time.perf_counter() - t0, level,
                             obs.PERF.headroom()))
            if stop.is_set() and level == 0:
                return
            await asyncio.sleep(0.05)

    async def serve():
        loop = asyncio.get_event_loop()
        app.start()
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        got = {}
        try:
            await asyncio.gather(*[client(port, 2, 1, warm=True)
                                   for _ in range(4)])
            before = dict(engine.counters)
            ev0 = sched.m_brownout_evictions.value
            engine.sync_debug = "error"            # the rounds' sync guard
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            watch = asyncio.ensure_future(sampler(t0))
            clients = [asyncio.ensure_future(client(port, 0, 1))
                       for _ in range(BROWNOUT_FLOOD)]
            clients += [asyncio.ensure_future(
                client(port, 2, BROWNOUT_HIGH_LINES))
                for _ in range(BROWNOUT_HIGH)]
            top_s, t_prev, calibrated = 0.0, t0, None
            while True:
                await asyncio.sleep(0.05)
                now = time.perf_counter()
                level = ladder.level()
                if level == 3:
                    top_s += now - t_prev
                    if "sloz" not in got:
                        got["sloz"] = await loop.run_in_executor(
                            None, http_get, mport, "/sloz")
                t_prev = now
                if calibrated is None and level == 0 and now - t0 > 3.0:
                    # the flood did not bring the gauge to the floor: set
                    # it just above what the gauge reads under the flood
                    reads = [h for t, _, h in timeline if t > 1.0]
                    calibrated = (min(reads), max(reads))
                    ladder.headroom_floor = round(max(reads) + 0.05, 3)
                at_top = [d for d in done if d[5] == 3 and not d[6]]
                high = sum(d[0] == 2 and not d[2].startswith("!!")
                           for d in at_top)
                sheds = sum(d[2].startswith("!!SERVER-OVERLOADED")
                            for d in at_top)
                evicted = sched.m_brownout_evictions.value - ev0
                if top_s >= BROWNOUT_TOP_S and high and sheds and evicted:
                    break
                check(now - t0 < BROWNOUT_TIMEOUT_S,
                      f"brownout serve: the ladder did not hold level 3 "
                      f"with a shed, an eviction and a served priority-2 "
                      f"request within {BROWNOUT_TIMEOUT_S} s (level "
                      f"{level}, {top_s:.1f} s at 3, {sheds} sheds and "
                      f"{high} priority-2 replies there, {evicted} "
                      f"evictions, floor {ladder.headroom_floor}, last "
                      f"headroom {timeline[-1][2]:.4f})")
            t_stop = time.perf_counter() - t0
            stop.set()
            await asyncio.gather(*clients)
            while engine.active_rows():
                await asyncio.sleep(0.01)
            torch.cuda.synchronize()
            counts = read_counts()
            after = dict(engine.counters)
            engine.sync_debug = None
            # the ladder cools back to 0 once the traffic is gone
            dl = time.perf_counter() + 30.0
            while ladder.level() > 0:
                check(time.perf_counter() < dl, "brownout serve: the "
                      "ladder did not cool to 0 within 30 s")
                await asyncio.sleep(0.05)
            await watch
            got["scale_after"] = engine._cap_scale
            got["metrics"] = await loop.run_in_executor(
                None, http_get, mport, "/metrics")
        finally:
            stop.set()
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return got, counts, {k: after[k] - before.get(k, 0)
                             for k in after}, t_stop, calibrated
    t_phase = time.perf_counter()
    got, counts, run, t_stop, calibrated = asyncio.run(serve())
    engine._join_features = join_features
    traffic = [d for d in done if not d[6]]
    # the ladder: one rung at a time, up to 3 and back to 0
    moves = [lvl for i, (_, lvl, _) in enumerate(timeline)
             if i == 0 or lvl != timeline[i - 1][1]]
    check(moves[0] == 0 and moves[-1] == 0 and max(moves) == 3
          and all(abs(a - b) == 1 for a, b in zip(moves, moves[1:])),
          f"brownout serve: ladder moves {moves}")
    ups = sum(b > a for a, b in zip(moves, moves[1:]))
    downs = len(moves) - 1 - ups
    m = got["metrics"][1]
    check(gauge(m, 'marian_brownout_transitions_total{direction="up"}')
          == ups and gauge(m, 'marian_brownout_transitions_total'
                              '{direction="down"}') == downs
          and gauge(m, "marian_brownout_level") == 0,
          f"brownout serve: /metrics transitions, {ups} up and {downs} "
          f"down seen")
    check(got["scale_after"] == 1.0, f"brownout serve: cap scale "
          f"{got['scale_after']} after the ladder cooled")
    sloz = json.loads(got["sloz"][1])["brownout"]
    check(sloz["enabled"] and sloz["level"] == 3 and sloz["name"] == "shed",
          f"brownout serve: /sloz at level 3 read {sloz}")
    # the replies
    retry = [d for d in traffic if d[2].startswith("!!SERVER-RETRY")]
    shed = [d for d in traffic if d[2].startswith("!!SERVER-OVERLOADED")]
    ok = [d for d in done if not d[2].startswith("!!")]
    check(len(ok) + len(retry) + len(shed) == len(done),
          "brownout serve: replies " + str(sorted(
              {d[2][:40] for d in done if d[2].startswith("!!")})))
    evictions = sched.m_brownout_evictions.value
    check(retry and all(d[0] == 0 and "under brownout" in d[2]
                        for d in retry) and len(retry) == evictions,
          f"brownout serve: {len(retry)} !!SERVER-RETRY replies, "
          f"{evictions} brownout evictions")
    n_shed = reg.get("marian_serving_shed_total").labels("brownout").value
    check(shed and all(d[0] == 0 and "brownout level 3" in d[2]
                       for d in shed) and len(shed) == n_shed,
          f"brownout serve: {len(shed)} !!SERVER-OVERLOADED replies, "
          f"{n_shed} brownout sheds")
    high_top = [d for d in ok if d[0] == 2 and d[5] == 3]
    check(high_top, "brownout serve: no priority-2 request served at "
          "level 3")
    # every joined row's cap: the engine's rule at the scale of its join
    engine.set_cap_scale(1.0)
    scaled = 0
    for text, (cap, scale) in joined.items():
        base = engine.decode_cap(len(tr.src_vocab.encode(text)))
        check(scale in (1.0, BROWNOUT_CAP_FACTOR)
              and cap == max(8, round(base * scale)),
              f"brownout serve: a row joined with cap {cap} at scale "
              f"{scale} (base {base})")
        scaled += scale < 1.0
    check(scaled > 0, "brownout serve: no row joined at a scaled cap")
    texts = [t for d in ok for t in d[1]]
    lines = [ln for d in ok for ln in d[2].split("\n")]
    check(len(texts) == len(lines) and all(t in joined for t in texts),
          "brownout serve: a served sentence never joined")
    caps = [joined[t][0] for t in texts]
    dense = dense_greedy_texts(tr, engine, texts, caps)
    bad = [i for i, (a, b) in enumerate(zip(lines, dense)) if a != b]
    check(not bad, f"brownout serve: {len(bad)} of {len(lines)} replies "
          f"differ from the dense greedy decode at their caps (first "
          f"{texts[bad[0]][:40] if bad else ''!r})")
    cut = sum(len(ln.split()) < len(t.split()) for t, ln in zip(texts, lines))
    # the launches: every step's paged read, every encode's packed one
    depth = engine.model.cfg.dec_depth
    want = {name: 0 for name in counts}
    want["paged_decode_attention"] = depth * run["steps"]
    want["packed_attention"] = engine.model.cfg.enc_depth * run["encodes"]
    check(counts == want, f"brownout serve launches {counts}, expected "
          f"{want}")
    check(engine.idle() and engine.pool.claims() == {}
          and engine.pool.free_pages() == engine.pool.usable_pages
          and engine.audit() == [],
          f"brownout serve: pool after the run {engine.pool.claims()}")
    # one flight file an escalation, each with the ladder's state
    wait_until(lambda: len([n for n in os.listdir(dump)
                            if n.endswith("-brownout.json")]) >= ups,
               "brownout flight files", timeout=30.0)
    files = sorted(n for n in os.listdir(dump) if n.endswith("-brownout.json"))
    levels = []
    for n in files:
        with open(dump / n, encoding="utf-8") as fh:
            payload = json.load(fh)
        check(payload["reason"] == "brownout"
              and payload["brownout"]["enabled"], f"flight file {n}")
        levels.append(payload["brownout"]["level"])
    check(len(files) == ups and min(levels) >= 1,
          f"brownout serve: flight files {files} for {ups} escalations")
    obs_reset()
    lat = {lane: np.percentile(
        np.array([d[4] - d[3] for d in ok if d[0] == lane and not d[6]])
        * 1e3, [50, 99]) for lane in (0, 2)}
    steps = [f"{t:.2f} s -> {lvl}" for i, (t, lvl, _) in enumerate(timeline)
             if i and lvl != timeline[i - 1][1]]
    heads = [h for t, _, h in timeline if t < t_stop]
    cfg = engine.model.cfg
    print(f"brownout serve ({smi}): transformer {cfg.enc_depth}+"
          f"{cfg.dec_depth}, dim {cfg.dim_emb}, copying weights, greedy, "
          f"{SERVE_ROWS} slots, {BROWNOUT_FLOOD} priority-0 clients and "
          f"{BROWNOUT_HIGH} priority-2 clients of {BROWNOUT_HIGH_LINES} "
          f"sentences for {t_stop:.2f} s; headroom gauge under the traffic "
          f"min {min(heads):.4f} max {max(heads):.4f}; floor "
          + (f"{default_floor} (the default) reached by the gauge"
             if calibrated is None else
             f"{default_floor} (the default) never reached (the gauge read "
             f"{calibrated[0]:.4f}-{calibrated[1]:.4f} under the flood): "
             f"--brownout-headroom set to {ladder.headroom_floor}")
          + f"; ladder {' '.join(steps)} ({ups} up, {downs} down, counted "
          f"in /metrics; /sloz at level 3 {sloz['name']}); "
          f"{len(joined)} rows joined, {scaled} at cap factor "
          f"{BROWNOUT_CAP_FACTOR}, {cut} served replies cut by it; "
          f"{len(retry)} brownout evictions = {len(retry)} priority-0 "
          f"!!SERVER-RETRY; {len(shed)} brownout sheds = {len(shed)} "
          f"priority-0 !!SERVER-OVERLOADED; {len(high_top)} priority-2 "
          f"requests served at level 3")
    print(f"brownout serve: latency p50/p99 priority 0 {lat[0][0]:.1f}/"
          f"{lat[0][1]:.1f} ms, priority 2 {lat[2][0]:.1f}/{lat[2][1]:.1f} "
          f"ms over {len(ok)} served requests ({len(lines)} sentences, each "
          f"the dense greedy decode at its cap); {len(files)} flight files; "
          f"cap scale back to 1.0; pool empty, audit clean; "
          f"{run['rounds']} rounds, {run['steps']} steps; phase "
          f"{time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts


def phase_fleet_serve(seed: int, smi: str) -> dict:
    """Multi-tenant fleet serving through ``server._serve``, the
    reference's transport choice (``HAVE_WS``: WebSocket where the
    ``websockets`` package is installed, else TCP; the clients speak the
    one ``_serve`` announced), request mode at beam 12: tenant ``a`` the
    6+6 serve model, tenant ``b`` the 2+2 cut of a second weight set
    (--seed + 1), ``--fleet-default-tenant a`` and a
    ``--fleet-hbm-budget-mb`` halfway between the larger tenant's
    estimate and the two estimates' sum, so every warm of one tenant
    evicts the other. FLEET_SENTENCES traced one-line requests from
    SERVE_CLIENTS clients in three waves (a tagged and untagged, then b,
    then a) and FLEET_UNKNOWN with an unknown tag. Held: every reply
    Translate.run of its tenant's model on the card, its #trace: line
    naming the tenant's version (an untagged request's ``a``), each
    tenant's executor decoding exactly its requests; the unknown tags
    answered !!SERVER-ERROR; the fleet's cold-start and eviction counters
    equal to /fleetz, /metrics and the warms and evictions seen; at least
    one warm on demand and one eviction; every eviction giving back the
    tenant's parameter bytes on the card; the marian_fleet_* series
    through promlint; decode_attention dec_depth x steps and
    packed_attention enc_depth x searches of the tenants' searches.
    Prints each warm's estimate beside the bytes the card allocated."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.common.options import Options
    from marian_tpu_torch.models import transformer as T
    from marian_tpu_torch.server import server as srv
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.serving.fleet import HBM_OVERHEAD
    from marian_tpu_torch.serving.promlint import lint_metrics_text
    obs_reset()
    t_phase = time.perf_counter()
    opts = Options(BASE)
    small, cut = depth_cut(random_weights(opts, seed + 1), opts)
    mio.save_model(str(WORK / FLEET_B_MODEL), serve_weights(
        small, T.config_from_options(cut, VOCAB, VOCAB)), cut.as_yaml())
    del small
    models = {"a": "serve.npz", "b": FLEET_B_MODEL}
    est = {t: int(os.path.getsize(WORK / m) * HBM_OVERHEAD)
           for t, m in models.items()}
    budget_mb = (max(est.values()) + sum(est.values())) / 2 / (1 << 20)
    sents = serve_sentences(seed + 13, FLEET_SENTENCES)
    # three waves: a (two tagged to one untagged), b, a (every fourth
    # untagged), and the unknown tags in the first
    cut1, cut2 = FLEET_SENTENCES * 3 // 8, FLEET_SENTENCES * 11 // 16
    waves, tenant_of = [], []
    for w, (lo, hi) in enumerate(((0, cut1), (cut1, cut2),
                                  (cut2, FLEET_SENTENCES))):
        wave = []
        for i in range(lo, hi):
            tag = "b" if w == 1 else "a"
            untagged = tag == "a" and i % (3 if w == 0 else 4) == 0
            tenant_of.append(tag)
            head = f"#trace:fleet-{i:03d}\n" + ("" if untagged
                                                else f"#model:{tag}\n")
            wave.append((i, head + sents[i]))
        if w == 0:
            wave += [(-1 - k, f"#trace:fleet-x{k}\n#model:zz\n{sents[k]}")
                     for k in range(FLEET_UNKNOWN)]
        waves.append(wave)
    # the references: Translate.run of each tenant's model on the card
    refs = {}
    for tag, name in models.items():
        ref_app = ServingApp(request_options("--perf-accounting", "false",
                                             model=name))
        idx = [i for i, t in enumerate(tenant_of) if t == tag]
        ref = ref_app.service.translator.run([sents[i] for i in idx],
                                             io.StringIO())
        refs.update(zip(idx, ref))
        ref_app.close_nowait()
        del ref_app
    gc.collect()
    torch.cuda.empty_cache()
    same = sum(refs[i] == sents[i] for i in range(FLEET_SENTENCES))
    mport = free_port()
    options = parse_options(
        ["--vocabs", str(WORK / "vocab.yml"), str(WORK / "vocab.yml"),
         "--fleet", f"a={WORK / models['a']},b={WORK / models['b']}",
         "--fleet-default-tenant", "a", "--fleet-hbm-budget-mb",
         repr(budget_mb), "--mini-batch", str(REQUEST_MINI_BATCH),
         "--max-length", "128", "--max-length-factor-translate", "3",
         "--metrics-port", str(mport), "--port", "0", "--quiet"],
        mode="server")
    apps, warms, evicts, searches, served = [], [], [], [], {}
    state = {"room": 0, "boot": True}

    class Instrumented(ServingApp):
        """The server _serve builds, with the fleet's warms, evictions
        and executors observed (allocated bytes around each, the
        executors' searches and lines)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apps.append(self)
            fleet = self.fleet
            state["golden"] = set(fleet.golden)
            warm, room, evict = fleet._warm, fleet._make_room, fleet.evict
            factory = fleet.executor_factory

            def _make_room(need, exclude):
                room(need, exclude)
                torch.cuda.synchronize()
                state["room"] = torch.cuda.memory_allocated()

            def _warm(t):
                t0 = time.perf_counter()
                warm(t)
                torch.cuda.synchronize()
                warms.append((t.spec.tag, t.resident_bytes,
                              torch.cuda.memory_allocated() - state["room"],
                              time.perf_counter() - t0, state["boot"]))

            def _evict(tag, reason="admin"):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                ok = evict(tag, reason)
                torch.cuda.synchronize()
                evicts.append((tag, reason, before
                               - torch.cuda.memory_allocated()))
                return ok

            def _factory(bundle_dir, manifest):
                ex = factory(bundle_dir, manifest)
                tr = ex.__self__.translator
                tag = "a" if os.path.basename(bundle_dir) == models["a"] \
                    else "b"
                lines = served.setdefault(tag, [])
                cfg = tr.model.cfg
                params = sum(v.numel() * v.element_size()
                             for v in tr.params.values())
                searches.append((tag, cfg.enc_depth, cfg.dec_depth,
                                 tr.search.steps, params))

                def translate(batch):
                    lines.extend(batch)
                    return ex(batch)
                return translate
            fleet._warm, fleet._make_room = _warm, _make_room
            fleet.evict, fleet.executor_factory = _evict, _factory

    announced = []

    def info(msg, *a):
        announced.append(msg.format(*a))
        log_info(msg, *a)

    async def wave_traffic(port, wave, transport):
        replies = {}

        async def request(i, text):
            if transport == "websocket":
                import websockets
                async with websockets.connect(
                        f"ws://127.0.0.1:{port}") as ws:
                    await ws.send(text)
                    replies[i] = await ws.recv()
                return
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            try:
                payload = text.encode("utf-8")
                writer.write(b"MTPU %d\n" % len(payload) + payload)
                await writer.drain()
                header = await reader.readline()
                check(header.startswith(b"MTPU "), f"reply {header!r}")
                replies[i] = (await reader.readexactly(
                    int(header.split()[1]))).decode("utf-8")
            finally:
                writer.close()

        async def client(c):
            for i, text in wave[c::SERVE_CLIENTS]:
                await request(i, text)
        await asyncio.gather(*[client(c) for c in range(SERVE_CLIENTS)])
        return replies

    async def main():
        loop = asyncio.get_event_loop()
        ready = loop.create_future()
        task = asyncio.ensure_future(srv._serve(options, ready=ready))
        port = await asyncio.wait_for(ready, 300)
        transport = "websocket" if srv.HAVE_WS else "tcp"
        try:
            state["boot"] = False
            marks = {id(s): len(s[3]) for s in searches}
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            replies = {}
            for wave in waves:
                replies.update(await wave_traffic(port, wave, transport))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            scrape = {p: await loop.run_in_executor(None, http_get, mport, p)
                      for p in ("/fleetz", "/metrics")}
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        return replies, secs, counts, scrape, marks, transport

    log_info = srv.log.info
    srv.ServingApp, srv.log.info = Instrumented, info
    try:
        replies, secs, counts, scrape, marks, transport = asyncio.run(main())
    finally:
        srv.ServingApp, srv.log.info = ServingApp, log_info
    app = apps[0]
    heard = [a for a in announced if "listening on port" in a]
    check(len(heard) == 1 and f"({transport}" in heard[0],
          f"fleet serve: _serve announced {heard} ({transport})")
    # replies: the tenant's Translate.run, its version in the #trace line
    for i in range(FLEET_SENTENCES):
        head, _, body = replies[i].partition("\n")
        tag = tenant_of[i]
        check(head.startswith(f"#trace:fleet-{i:03d} outcome=ok ")
              and head.endswith(f" model_version={tag}:{tag}:boot")
              and body == refs[i],
              f"fleet serve: request {i} (tenant {tag}) got {replies[i]!r}, "
              f"Translate.run {refs[i]!r}")
    for k in range(FLEET_UNKNOWN):
        body = replies[-1 - k].partition("\n")[2]
        check(body.startswith("!!SERVER-ERROR unknown model tag 'zz'"),
              f"fleet serve: unknown tag answered {body!r}")
    for tag in models:
        mine = sorted(sents[i] for i, t in enumerate(tenant_of) if t == tag)
        got = sorted(ln for ln in served.get(tag, [])
                     if ln not in state["golden"])
        check(got == mine, f"fleet serve: tenant {tag}'s executors decoded "
              f"{len(got)} lines, its requests hold {len(mine)}")
    # the counters: the fleet's own, /fleetz, /metrics and the warms seen
    fleetz = json.loads(scrape["/fleetz"][1])
    metrics = scrape["/metrics"][1]
    rows = {r["tenant"]: r for r in fleetz["tenants"]}
    for tag in models:
        n = sum(w[0] == tag for w in warms)
        check(rows[tag]["cold_starts"] == n
              == gauge(metrics,
                       f'marian_fleet_cold_starts_total{{tenant="{tag}"}}'),
              f"fleet serve: tenant {tag} cold starts /fleetz "
              f"{rows[tag]['cold_starts']}, warms seen {n}")
    n_ev = gauge(metrics,
                 'marian_fleet_evictions_total{reason="hbm_pressure"}')
    on_demand = [w for w in warms if not w[4]]
    check(n_ev == len(evicts) >= 1 and on_demand,
          f"fleet serve: {n_ev} evictions counted, {len(evicts)} seen, "
          f"{len(on_demand)} warms on demand")
    check(fleetz["hbm_resident_bytes"] <= fleetz["hbm_budget_bytes"]
          and sum(r["resident"] for r in rows.values()) == 1,
          f"fleet serve: /fleetz {fleetz}")
    params = {s[0]: s[4] for s in searches}
    for tag, _, freed in evicts:
        check(freed >= params[tag], f"fleet serve: evicting {tag} gave "
              f"back {freed} bytes, its parameters hold {params[tag]}")
    fleet_text = "\n".join(ln for ln in metrics.splitlines()
                           if "marian_fleet_" in ln) + "\n"
    problems = lint_metrics_text(fleet_text)
    check(not problems, f"fleet serve: promlint {problems[:4]}")
    # the launches: every tenant search since the counts were reset
    want = {name: 0 for name in counts}
    for s in searches:
        start = marks.get(id(s), 0)
        want["decode_attention"] += s[2] * sum(s[3][start:])
        want["packed_attention"] += s[1] * (len(s[3]) - start)
    check(counts == want, f"fleet serve launches {counts}, expected {want}")
    obs_reset()
    del app, apps
    gc.collect()
    torch.cuda.empty_cache()
    if transport == "websocket":
        import websockets
        heard[0] += f" (websockets {websockets.__version__})"
    print(f"fleet serve ({smi}): _serve announced {heard[0]!r}; tenants a "
          f"(transformer 6+6, {models['a']}) and b (2+2 cut of --seed + 1, "
          f"{FLEET_B_MODEL}), copying weights, request mode, beam 12; budget "
          f"{budget_mb:.1f} MB between the estimates a {est['a']} and b "
          f"{est['b']} bytes (file x {HBM_OVERHEAD}); {FLEET_SENTENCES} "
          f"traced requests in three waves (a, b, a) and {FLEET_UNKNOWN} "
          f"unknown tags from {SERVE_CLIENTS} clients in {secs:.3f} s; "
          f"replies equal each tenant's Translate.run ({same} of "
          f"{FLEET_SENTENCES} equal their source), untagged ones on a")
    for tag, est_b, alloc, dt, boot in warms:
        print(f"fleet serve ({smi}): warm of {tag} "
              f"({'boot' if boot else 'on demand'}) {dt:.2f} s: estimate "
              f"{est_b} bytes, allocated on the card {alloc} bytes "
              f"(estimate / allocated {est_b / max(alloc, 1):.3f}; the "
              f"parameters {params[tag]} bytes)")
    print(f"fleet serve: evictions "
          + ", ".join(f"{tag} ({why}) gave back {freed} bytes"
                      for tag, why, freed in evicts)
          + f"; /fleetz cold starts a {rows['a']['cold_starts']}, b "
          f"{rows['b']['cold_starts']}, evictions {n_ev}; marian_fleet_* "
          f"pass promlint; phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    return counts


def phase_fused_pressure(seed: int) -> dict:
    """The fused merge on a pool that holds its rows at their caps but not
    the rounds' worst-case preclaim: PRESSURE_ROWS slots (two sentences),
    --kv-pool-bytes for PRESSURE_ROWS full-cap rows (the host merge's
    default pool: it can never run dry) and PRESSURE_STEPS steps a round
    (a preclaim of up to 41 pages a sentence). Rounds fall back to one
    host-merge step, no sentence is evicted, and every reply is still the
    dense search's."""
    page_bytes = 2 * SERVE_CUT_DEPTH * BASE["dim-emb"] * 16 * 4
    pages = PRESSURE_ROWS * -(-128 // 16)
    return beam_serve_run(
        "fused beam pressure", seed,
        serve_sentences(seed, SERVE_SENTENCES)[:PRESSURE_SENTENCES],
        beam_serve_options("--iteration-steps", str(PRESSURE_STEPS),
                           "--iteration-rows", str(PRESSURE_ROWS),
                           "--kv-pool-bytes", str(pages * page_bytes),
                           merge=None),
        "packed_attention", pressured=True)


def phase_beam_serve_card_vs_cpu(seed: int, *extra: str, merge="host",
                                 what: str = "beam serve") -> None:
    """SERVE_BEAM_CUT of the served sentences through the beam engine on
    the card and on the CPU: identical texts."""
    from marian_tpu_torch.server.server import ServingApp
    sents = serve_sentences(seed, SERVE_BEAM_CUT)
    texts = {}
    for name, dev in (("cuda", None), ("cpu", "cpu")):
        engine = ServingApp(beam_serve_options(*extra, merge=merge),
                            device=dev).scheduler.engine
        check(engine.device.type == name, f"{name} run resolved "
              f"{engine.device}")
        t0 = time.perf_counter()
        texts[name] = engine.decode_texts(sents)
        print(f"{what} card vs cpu: {name} engine ({engine.merge} merge, "
              f"{engine.steps_per_round} steps a round), {len(sents)} "
              f"sentences: {time.perf_counter() - t0:.2f} s, "
              f"{engine.counters['rounds']} rounds")
    check(texts["cuda"] == texts["cpu"], f"{what}: texts differ between "
          "the card and the CPU")
    print(f"{what} card vs cpu: {len(sents)} texts identical "
          f"({sum(len(t.split()) for t in texts['cpu'])} words)")


def decoding(engine, text: str) -> bool:
    """Whether a row of ``text`` (a scheduler unit's) is decoding past its
    first round: read from the event loop while the device worker runs
    rounds, so a read that races a change retries."""
    for _ in range(8):
        try:
            if hasattr(engine, "_sents"):
                return any(s.key.text == text and s.t > 0
                           for s in list(engine._sents.values()))
            return any(s is not None and s.key.text == text and s.pos > 0
                       for s in list(engine._slots))
        except RuntimeError:
            continue
    return False


async def prefix_traffic(port: int, sents, engine, clients: int):
    """Each of ``sents`` sent twice by one of ``clients`` concurrent
    clients, its sentences one after another: an even-numbered sentence's
    repeat goes out while the first copy decodes (past its first round),
    an odd one's after the first reply. Returns the (first, repeat)
    replies in sentence order and the request latencies (s)."""
    out, lat = [None] * len(sents), []

    async def send(text):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            payload = text.encode("utf-8")
            t0 = time.perf_counter()
            writer.write(b"MTPU %d\n" % len(payload) + payload)
            await writer.drain()
            header = await reader.readline()
            check(header.startswith(b"MTPU "), f"reply header {header!r}")
            body = await reader.readexactly(int(header.split()[1]))
            lat.append(time.perf_counter() - t0)
            return body.decode("utf-8")
        finally:
            writer.close()

    async def sentence(i):
        first = asyncio.ensure_future(send(sents[i]))
        if i % 2:
            out[i] = (await first, await send(sents[i]))
            return
        while not first.done() and not decoding(engine, sents[i]):
            await asyncio.sleep(0.002)
        repeat = await send(sents[i])
        out[i] = (await first, repeat)

    async def client(c):
        for i in range(c, len(sents), clients):
            await sentence(i)
    await asyncio.gather(*[client(c) for c in range(clients)])
    return out, lat


def phase_prefix_serve_main_path(seed: int) -> dict:
    """--prefix-cache on the serve path, greedy (beam 1) and the fused
    beam engine (beam SERVE_BEAM), FUSED_STEPS steps a round: the first
    PREFIX_SENTENCES of the served sentences, each sent twice
    (``prefix_traffic``). Every reply, cold or warm, must equal the dense
    decode (greedy_decode cut at its cap and EOS; the dense beam search's
    best); the greedy engine forks repeats from live leaders, both replay
    finished sentences; both engines' step loops run under the sync
    guard; launches as on the other serve paths; after ``drop_all`` the
    pool is empty and its audit clean."""
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.translator.greedy import greedy_decode
    sents = serve_sentences(seed, SERVE_SENTENCES)[:PREFIX_SENTENCES]
    all_counts = []
    for what, flags in (
            ("prefix serve, greedy", serve_options(
                "--prefix-cache", "--iteration-steps", str(FUSED_STEPS),
                model=SERVE_CUT_MODEL)),
            ("prefix serve, beam", beam_serve_options(
                "--prefix-cache", "--iteration-steps", str(FUSED_STEPS),
                merge=None))):
        app = ServingApp(flags)
        engine = app.scheduler.engine
        check(engine.device.type == "cuda" and engine.prefix is not None,
              f"{what}: engine on {engine.device}, cache {engine.prefix}")
        pairs, lat, secs, counts, run = serve_counted(
            app, sents, serve_sentences(seed + 1, 4),
            lambda: {**engine.counters, **engine.prefix.counters},
            on_warm=lambda: setattr(engine, "sync_debug", "error"),
            traffic=lambda port: prefix_traffic(port, sents, engine,
                                                SERVE_CLIENTS))
        engine.sync_debug = None
        tr = app.service.translator
        ids, src, mask = source_batch(tr, sents, engine.device)
        caps = [engine.decode_cap(len(x)) for x in ids]
        if hasattr(engine, "beam_size"):
            want = [tr.trg_vocab.decode(d["tokens"], ignore_eos=True)
                    for d in dense_beam_best(tr, sents, caps, engine)]
            forks_ok = True
        else:
            dense = greedy_decode(tr.model, tr.params, src, mask, max(caps))
            want = []
            for i, cap in enumerate(caps):
                toks = list(dense[i, :cap])
                want.append(tr.trg_vocab.decode(
                    toks[:toks.index(0)] if 0 in toks else toks))
            forks_ok = run["forks"] > 0
        differ = [i for i, ((a, b), w) in enumerate(zip(pairs, want))
                  if not a == b == w]
        check(not differ, f"{what}: {len(differ)} cold or warm replies "
              f"differ from the dense decode (sentences {differ[:8]})")
        check(forks_ok and run["replays"] > 0
              and run["prefix_hits"] == run["hits"],
              f"{what}: {run['forks']} forks, {run['replays']} replays, "
              f"{run['prefix_hits']} hits")
        cfg = engine.model.cfg
        want_counts = {name: 0 for name in counts}
        want_counts["paged_decode_attention"] = cfg.dec_depth * run["steps"]
        want_counts["packed_attention"] = cfg.enc_depth * run["encodes"]
        check(counts == want_counts, f"{what} launches {counts}, expected "
              f"{want_counts}")
        entries = engine.prefix.entries()
        held = engine.prefix.held_pages()
        engine.prefix.drop_all(engine.pool)
        check(engine.idle() and engine.pool.free_pages()
              == engine.pool.usable_pages and engine.pool.claims() == {},
              f"{what}: pages held after drop_all: {engine.pool.claims()}")
        bad = engine.audit()
        check(bad == [], f"{what}: pool audit after the run: {bad}")
        lat_ms = np.percentile(np.array(lat) * 1e3, [50, 99])
        print(f"{what} main path: transformer {cfg.enc_depth}+"
              f"{cfg.dec_depth}, copying weights, beam "
              f"{getattr(engine, 'beam_size', 1)}, {engine.steps_per_round} "
              f"steps a round, {engine.max_rows} slots, pool "
              f"{engine.pool.usable_pages} pages: {len(sents)} sentences "
              f"twice from {SERVE_CLIENTS} clients in {secs:.3f} s "
              f"({2 * len(sents) / secs:.2f} requests/s); {run['rounds']} "
              f"rounds, {run['steps']} steps, {run['encodes']} encoder "
              f"calls; cache hits {run['hits']} "
              f"({run['prefix_hits'] - run['replays']} live forks, "
              f"{run['replays']} replays), {run['misses']} misses, "
              f"{run['tokens_saved']} decode steps and {run['pages_reused']} "
              f"pages not recomputed, {run['evictions']} evictions, "
              f"{entries} entries holding {held} pages at the end; latency "
              f"p50 {lat_ms[0]:.1f} ms p99 {lat_ms[1]:.1f} ms; launches "
              f"{counts}")
        print(f"{what} main path: every cold and warm reply equals the "
              f"dense decode, step loops under the sync guard; after "
              f"drop_all the pool is empty, audit clean")
        all_counts.append(counts)
    return add_counts(*all_counts)


def write_lex(seed: int) -> str:
    """lex.s2t over the 32,000 words from ``seed``: each word's own copy
    at probability 0.9, then LEX_RANDOM random targets at 0.5 / rank
    (the copying serve model's replies stay inside any union)."""
    rng = np.random.RandomState(seed + 11)
    targets = rng.randint(2, VOCAB, size=(VOCAB - 2, LEX_RANDOM))
    lines = []
    for i in range(2, VOCAB):
        lines.append(f"w{i} w{i} 0.9")
        lines += [f"w{i} w{t} {0.5 / (j + 1):.5f}"
                  for j, t in enumerate(targets[i - 2])]
    path = WORK / "lex.s2t"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def dense_hyps(tr, text: str, cap: int, beam: int, shortlist_gen=None,
               forced=(), n_best: int = 1, normalize: float = 0.0):
    """The port's dense beam search of ``text`` alone on the card at decode
    cap ``cap``: its n-best dicts, over the sentence's own shortlist
    (``shortlist_gen``) or with the target prefix ``forced``."""
    from marian_tpu_torch.translator.beam_search import (BeamConfig,
                                                         BeamSearch,
                                                         beam_search)
    ids, src, mask = source_batch(tr, [text], tr.device)
    sl = pfx = None
    if shortlist_gen is not None:
        sl = torch.from_numpy(shortlist_gen.generate(
            np.unique(ids[0])).indices).long().to(tr.device)
    if forced:
        pfx = torch.full((1, cap), -1, dtype=torch.long, device=tr.device)
        pfx[0, :len(forced)] = torch.tensor(forced)
    cfg = BeamConfig(beam_size=beam, normalize=normalize, max_length=cap,
                     n_best=n_best)
    with torch.inference_mode():
        res = beam_search(tr.model, tr.params, cfg, src, mask, sl, pfx)
    return BeamSearch._collect(*(x.cpu().numpy() for x in res[:4]), cfg)[0]


def surface_engine_cap(engine, tr, text: str, forced=()) -> int:
    """A served sentence's decode cap, its forced trunk covered."""
    cap = engine.decode_cap(len(tr.src_vocab.encode(text)))
    return min(engine.max_length_cap, max(cap, len(forced) + 8)) \
        if forced else cap


async def stream_client(port: int, text: str):
    """One ``#stream:1`` request: (its #partial: frames, the final reply)."""
    from marian_tpu_torch.server.server import PARTIAL_PREFIX
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        payload = ("#stream:1\n" + text).encode("utf-8")
        writer.write(b"MTPU %d\n" % len(payload) + payload)
        await writer.drain()
        partials = []
        while True:
            header = await reader.readline()
            check(header.startswith(b"MTPU "), f"reply header {header!r}")
            frame = (await reader.readexactly(
                int(header.split()[1]))).decode("utf-8")
            if not frame.startswith(PARTIAL_PREFIX):
                return partials, frame
            partials.append(frame[len(PARTIAL_PREFIX):])
    finally:
        writer.close()


def surface_serve(what: str, seed: int, sents, flags, guard: bool = False):
    """``sents`` through a ServingApp built from ``flags`` (a counted
    serve run, serve_counted); the engine's step loops under the sync
    guard when ``guard``. Returns (app, replies, counts)."""
    from marian_tpu_torch.server.server import ServingApp
    app = ServingApp(flags)
    engine = app.scheduler.engine
    check(engine.device.type == "cuda" and engine.features is not None,
          f"{what}: engine on {engine.device}, plane {engine.features}")

    def arm():
        engine.sync_debug = "error" if guard else None
    replies, _, secs, counts, run = serve_counted(
        app, sents, serve_sentences(seed + 1, 2),
        lambda: dict(engine.counters), on_warm=arm)
    engine.sync_debug = None
    check(engine.idle() and engine.pool.free_pages()
          == engine.pool.usable_pages and engine.audit() == [],
          f"{what}: pool not empty or audit failed after the run")
    cfg = engine.model.cfg
    want = {name: 0 for name in counts}
    want["paged_decode_attention"] = cfg.dec_depth * run["steps"]
    want["packed_attention"] = cfg.enc_depth * run["encodes"]
    check(counts == want, f"{what} launches {counts}, expected {want}")
    print(f"decode surface: {what}: {engine.features.describe()}, "
          f"{getattr(engine, 'merge', 'greedy')}, {engine.steps_per_round} "
          f"steps a round{' under the sync guard' if guard else ''}: "
          f"{len(sents)} sentences in {secs:.3f} s, {run['rounds']} rounds, "
          f"{run['steps']} steps; launches paged "
          f"{want['paged_decode_attention']}, packed "
          f"{want['packed_attention']}")
    return app, replies, counts


def per_row_logit_times(tr) -> None:
    """The per-row shortlisted logits at the serve shape (SERVE_ROWS rows,
    K 1,024, the serve model's table) in both forms, each held to the
    other, timed beside one batch-wide [K] slice and the full product;
    the bytes each form moves (``per_row_gather_bytes``) and the form
    the port takes."""
    from marian_tpu_torch.models import transformer as T
    cfg, params = tr.model.cfg, tr.params
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(SERVE_ROWS, cfg.dim_emb, generator=gen).to(tr.device)
    sl = torch.stack([torch.randperm(VOCAB, generator=gen)[:1024].sort().values
                      for _ in range(SERVE_ROWS)]).to(tr.device)
    itemsize = params["Wemb"].element_size()
    gathered_b, full_b = T.per_row_gather_bytes(SERVE_ROWS, 1024, VOCAB,
                                                cfg.dim_emb, itemsize)
    plain = T.per_row_gather_bytes
    out, ms = {}, {}
    try:
        for form, pick in (("gathered", (0, 1)), ("full", (1, 0))):
            T.per_row_gather_bytes = lambda *a, _p=pick: _p
            with torch.inference_mode():
                out[form] = T.output_logits(cfg, params, x, sl)
                ms[form] = time_ms(lambda: T.output_logits(cfg, params, x,
                                                           sl))
    finally:
        T.per_row_gather_bytes = plain
    with torch.inference_mode():
        ms["slice"] = time_ms(lambda: T.output_logits(cfg, params, x, sl[0]))
        ms["none"] = time_ms(lambda: T.output_logits(cfg, params, x))
    err = (out["gathered"] - out["full"]).abs().max().item()
    check(err <= 1e-3, f"the per-row logit forms differ by {err}")
    taken = "gathered" if gathered_b <= full_b else "full"
    print(f"decode surface: per-row shortlisted logits, {SERVE_ROWS} rows, K "
          f"1024, table [{VOCAB}, {cfg.dim_emb}] f32: gathered [R, K, D] "
          f"{gathered_b / 2**20:.1f} MiB, {ms['gathered']:.4f} ms; full "
          f"product + gather {full_b / 2**20:.1f} MiB, {ms['full']:.4f} ms "
          f"(the port takes '{taken}'); forms agree within {err:.2g}; one "
          f"[K] slice {ms['slice']:.4f} ms, no shortlist {ms['none']:.4f} ms")


def phase_decode_surface(seed: int) -> dict:
    """The decode surface on the serve model's 2+2-layer cut
    (SERVE_CUT_MODEL, ``serve_weights`` of the base cut's weights: depth
    cut for time), with a lex table from ``seed`` (``write_lex``): the
    dense search and the
    paged engines with --shortlist, --force-decode, --output-sampling,
    --n-best, --word-scores and #stream:1 (see each check's line).
    Counted: the dense shortlisted beam-6 decode (decode_attention, the
    packed encoder) and the greedy and fused beam serves with the
    shortlist (paged_decode_attention, the packed encoder).

    Host parsing is cut for the run's time: the text lex table is parsed
    once and written with the port's ``save_binary`` (its shortlists
    held equal to the text's for the phase's sentences), and the phase's
    decoders and servers read that binary table and ``vocab.json``, the
    same map as vocab.yml (every other phase keeps reading the YAML)."""
    from marian_tpu_torch.data.shortlist import LexicalShortlistGenerator
    from marian_tpu_torch.data.vocab import DefaultVocab
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.translator.beam_search import (gumbel_noise,
                                                         noise_bits)
    from marian_tpu_torch.translator.translator import Translate
    t_host = time.perf_counter()
    (WORK / "vocab.json").write_text(json.dumps(vocab_map(VOCAB)))
    vocab = DefaultVocab.load(str(WORK / "vocab.json"))
    text_gen = LexicalShortlistGenerator(write_lex(seed), vocab, vocab,
                                         first=100, best=20)
    lex = str(WORK / "lex.npz")
    text_gen.save_binary(lex)
    bin_gen = LexicalShortlistGenerator(lex, vocab, vocab, first=100,
                                        best=20)
    sl = ("--shortlist", lex, "100", "20")
    sents = serve_sentences(seed, SURFACE_SENTENCES)
    cut = sents[:SURFACE_CUT]
    for text in sents:
        ids = np.unique(vocab.encode(text))
        check(np.array_equal(text_gen.generate(ids).indices,
                             bin_gen.generate(ids).indices),
              "the binary lex table's shortlist differs from the text's")
    print(f"decode surface: lex table parsed once from text, written and "
          f"reloaded as {Path(lex).name} (equal shortlists for "
          f"{len(sents)} sentences); vocab.json beside vocab.yml: "
          f"{time.perf_counter() - t_host:.2f} s")
    del text_gen, bin_gen
    V = "vocab.json"

    def dec(*flags):
        return decoder_options(SERVE_CUT_MODEL, *flags, vocab=V)

    def srv(*flags):
        return serve_options(*flags, model=SERVE_CUT_MODEL, vocab=V)

    def bsrv(*flags):
        return beam_serve_options(*flags, merge=None, model=SERVE_CUT_MODEL,
                                  vocab=V)
    all_counts = []

    # the noise: bits equal on the card and the CPU, values within 1 ulp
    coords = torch.arange(32000)[None, :]
    lanes, steps = torch.arange(64)[:, None] * 7 + 3, torch.arange(64)[:, None]
    cpu_bits = noise_bits(1234, lanes, steps, coords)
    dev = torch.device("cuda")
    bits = noise_bits(1234, lanes.to(dev), steps.to(dev), coords.to(dev))
    check(torch.equal(bits.cpu(), cpu_bits), "noise bits differ between the "
          "card and the CPU")
    g_cpu = gumbel_noise(1234, lanes, steps, coords)
    g = gumbel_noise(1234, lanes.to(dev), steps.to(dev), coords.to(dev)).cpu()
    ulps = int((g.view(torch.int32) - g_cpu.view(torch.int32)).abs().max())
    check(ulps <= 1, f"gumbel noise differs by {ulps} ulps card vs CPU")

    # the dense search, beam 6, the shortlist (one a batch): counted, and
    # equal to the CPU's; --word-scores sum to the raw scores
    tr, hyps, secs, counts = decode_run(SERVE_CUT_MODEL, cut, *sl,
                                        "--word-scores", vocab=V)
    check_decode_counts(tr, counts, 1, "packed_attention")
    all_counts.append(counts)
    worst = 0.0
    for h in hyps:
        ws = [float(x) for x in h[2].split()[1:]]
        worst = max(worst, abs(sum(ws) - float(h[3].split()[1])))
    check(worst < 1e-3, f"word scores sum off their raw score by {worst}")
    decode_card_vs_cpu(f"{len(cut)} sentences, serve model, --shortlist "
                       f"100 20", SERVE_CUT_MODEL, cut, *sl, vocab=V)
    print(f"decode surface: dense beam {BEAM} with --shortlist lex.npz 100 "
          f"20 on {len(cut)} sentences: {secs:.3f} s, steps "
          f"{tr.search.steps}; --word-scores sum to the raw score within "
          f"{worst:.2g}")

    # greedy (the dense search at beam 1): with the shortlist as without
    # it; the copy head's top-1 margin over the full vocabulary (a lower
    # bound of the shortlisted margin)
    def dense_lines(*flags):
        t = Translate(dec("--beam-size", "1", *flags))
        return t, t.run(sents, io.StringIO())
    tr1, with_sl = dense_lines(*sl)
    _, without = dense_lines()
    check(with_sl == without, "greedy with the shortlist differs from the "
          "full-vocabulary decode")
    _, src, mask = source_batch(tr1, sents, tr1.device)
    forced = torch.zeros((len(sents), max(len(r.split()) for r in with_sl)
                          + 1), dtype=torch.long, device=tr1.device)
    for i, r in enumerate(with_sl):
        ids = tr1.trg_vocab.encode(r)
        forced[i, :len(ids)] = torch.tensor(ids)
    logits = dense_step_logits(tr1.model, tr1.params, src, mask, forced)
    top2 = logits.topk(2, dim=-1).values
    margin = min(float((top2[i, :len(r.split()) + 1, 0]
                        - top2[i, :len(r.split()) + 1, 1]).min())
                 for i, r in enumerate(with_sl))
    print(f"decode surface: greedy with the shortlist equals the full-"
          f"vocabulary greedy decode on {len(sents)} sentences; smallest "
          f"top-1 margin {margin:.3f}")
    gen = tr1.shortlist_gen

    per_row_logit_times(tr1)

    # iteration greedy and the fused beam (FUSED_STEPS a round, under the
    # sync guard) with the shortlist: each reply the dense shortlisted
    # decode of its sentence alone
    for what, flags, beam in (
            ("iteration greedy", srv(*sl, "--iteration-steps",
                                     str(FUSED_STEPS)), 1),
            ("fused beam", bsrv(*sl, "--iteration-steps", str(FUSED_STEPS)),
             SERVE_BEAM)):
        app, replies, counts = surface_serve(what, seed, sents, flags,
                                             guard=True)
        all_counts.append(counts)
        engine = app.scheduler.engine
        check(engine.features.k_static == 1024, "static K")
        t = app.service.translator
        for text, reply in zip(sents, replies):
            best = dense_hyps(t, text, surface_engine_cap(engine, t, text),
                              beam, gen,
                              normalize=getattr(engine, "normalize", 0.0))[0]
            check(reply == t.trg_vocab.decode(best["tokens"]),
                  f"{what}: a shortlisted reply differs from the dense "
                  f"shortlisted decode of its sentence")
        print(f"decode surface: {what}: every reply equals the dense "
              f"shortlisted decode of its sentence alone")

    # force-decode: a trunk of 3 words of another sentence; request mode
    # reads a prefix file (marian-decoder), iteration mode TAB lines
    trunks = [" ".join(sents[(i + 1) % len(cut)].split()[:3])
              for i in range(len(cut))]
    (WORK / "fd.src").write_text("\n".join(cut) + "\n")
    (WORK / "fd.pfx").write_text("\n".join(trunks) + "\n")
    trf = Translate(dec("--force-decode", "--input", str(WORK / "fd.src"),
                        str(WORK / "fd.pfx")))
    out = io.StringIO()
    trf.run(stream=out)
    request_replies = out.getvalue().splitlines()
    app = ServingApp(bsrv("--force-decode", "--iteration-steps",
                          str(FUSED_STEPS)))
    engine = app.scheduler.engine
    iteration_replies, _, _, _, _ = serve_counted(
        app, [f"{s}\t{p}" for s, p in zip(cut, trunks)], [], dict)
    for text, trunk, a, b in zip(cut, trunks, request_replies,
                                 iteration_replies):
        forced = trf.trg_vocab.encode(trunk, add_eos=False)
        cap = surface_engine_cap(engine, trf, text, forced)
        best = dense_hyps(trf, text, cap, SERVE_BEAM, forced=forced,
                          normalize=engine.normalize)[0]
        want = trf.trg_vocab.decode(best["tokens"])
        check(a.startswith(trunk) and b.startswith(trunk) and a == want
              and b == want, f"force-decode: {a!r} / {b!r} against the "
              f"dense forced decode {want!r} (trunk {trunk!r})")
    print(f"decode surface: force-decode, request mode (prefix file) and "
          f"iteration fused beam (TAB lines) on {len(cut)} sentences: every "
          f"reply starts with its trunk and equals the dense forced decode")

    # sampling: topk 1 is the unsampled decode; topk 10 0.8 replays at one
    # seed (a fresh engine, a fresh search)
    stream_app = ServingApp(srv())
    plain = stream_app.scheduler.engine.decode_texts(sents)
    app = ServingApp(srv("--output-sampling", "topk", "1"))
    check(app.scheduler.engine.decode_texts(sents) == plain,
          "iteration greedy at --output-sampling topk 1 differs from the "
          "unsampled decode")
    trs = Translate(dec("--beam-size", "1", "--output-sampling", "topk",
                        "1"))
    check(trs.run(sents, io.StringIO()) == without, "the dense search at "
          "--output-sampling topk 1 differs from the unsampled decode")
    app = ServingApp(srv("--output-sampling", "topk", "10", "0.8", "--seed",
                         "5"))
    runs = [app._build_engine().decode_texts(cut) for _ in range(2)]
    trs = Translate(dec("--output-sampling", "topk", "10", "0.8", "--seed",
                        "5"))
    dense_runs = []
    for _ in range(2):
        trs.search._sample_calls = 0
        dense_runs.append(trs.run(cut, io.StringIO()))
    check(runs[0] == runs[1] and dense_runs[0] == dense_runs[1],
          "a sampled decode did not replay at its seed")
    changed = sum(a != b for a, b in zip(runs[0], plain))
    print(f"decode surface: --output-sampling topk 1 equals the unsampled "
          f"decode (iteration greedy, {len(sents)} sentences; dense beam "
          f"1); topk 10 0.8 at seed 5 replays (iteration greedy and dense "
          f"beam {BEAM}, {len(cut)} sentences, {changed} differ from the "
          f"unsampled)")

    # iteration n-best (the fused beam at beam SERVE_BEAM) against request
    # mode's n-best block of each sentence at the engine's cap
    app = ServingApp(bsrv("--n-best", "--iteration-steps", str(FUSED_STEPS)))
    engine = app.scheduler.engine
    check(engine.prefix is None and engine.features.n_best, "n-best engine")
    blocks, _, _, _, _ = serve_counted(app, cut, [], dict)
    t = app.service.translator
    worst = 0.0
    for text, block in zip(cut, blocks):
        want = engine.features.printer.line(0, dense_hyps(
            t, text, surface_engine_cap(engine, t, text), SERVE_BEAM,
            n_best=SERVE_BEAM, normalize=engine.normalize))
        got_l = [l.split(" ||| ") for l in block.split("\n")]
        want_l = [l.split(" ||| ") for l in want.split("\n")]
        check([g[:2] for g in got_l] == [w[:2] for w in want_l],
              f"n-best: the iteration block differs from request mode's for "
              f"{text[:40]!r}")
        worst = max([worst] + [abs(float(g[2].split()[1])
                                   - float(w[2].split()[1]))
                               for g, w in zip(got_l, want_l)])
    check(worst <= SERVE_BEAM_SCORE_TOL, f"n-best scores differ by {worst}")
    print(f"decode surface: iteration --n-best ({len(cut)} sentences x "
          f"{SERVE_BEAM}) equals request mode's blocks; scores max |diff| "
          f"{worst:.3g} (tolerance {SERVE_BEAM_SCORE_TOL})")

    # one #stream:1 client: greedy partials are prefixes of the final
    # reply, which equals the unstreamed one
    text = "\n".join(cut[:4])
    got = {}

    async def client(port):
        got["partials"], got["final"] = await stream_client(port, text)
        return [got["final"]], []
    serve_counted(stream_app, [], [], dict, traffic=client)
    lines = got["final"].split("\n")
    check(lines == plain[:4] and got["partials"], "the streamed reply "
          "differs from the unstreamed one, or carried no partials")
    for frame in got["partials"]:
        idx, _, partial = frame.partition(" ")
        check(lines[int(idx)].startswith(partial), f"partial {frame!r} is "
              f"not a prefix of its final reply")
    print(f"decode surface: #stream:1: {len(got['partials'])} partial frames, "
          f"each a prefix of its final reply; the final reply equals the "
          f"unstreamed one")
    return add_counts(*all_counts)


# ---------------------------------------------------------------------------
# checkpoint bundles and the zero-downtime model lifecycle
# ---------------------------------------------------------------------------

def model_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


class _OptimizerArrays:
    """Stands in for a GraphGroup at a restore: records the optimizer
    arrays."""

    def __init__(self):
        self.arrays = None

    def load_optimizer_arrays(self, arrays):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}


def phase_train_bundles() -> None:
    """The base train path's saves as bundles: ``train.npz.bundles``
    holds one committed bundle a save (two: the warm-up run's and the
    counted run's, under the default keep of 3), each validates, the
    top-level ``train.npz`` is the newest bundle's model member byte for
    byte; a copy whose newest model member is truncated restores (what
    a resume loads) from the bundle before it. (The timing of one such
    commit beside the same files written flat, 3.2-4.5 s against
    1.1-1.5 in PERF.md, is no longer repeated: it wrote 2.4 GB a run.)"""
    import filecmp
    import shutil
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.training import bundle as bdl
    from marian_tpu_torch.training import checkpoint as ckpt
    model = WORK / "train.npz"
    root = Path(bdl.bundle_root(str(model)))
    names = bdl.list_bundles(str(root))
    saves = 2
    check(names == [f"bundle-{i:08d}" for i in range(1, min(saves, 3) + 1)],
          f"train.npz.bundles holds {names} after {saves} saves")
    # the newest validates here, the one before it in the crash copy's
    # restore below (which hashes every member of each bundle it takes)
    ok, why, manifest = bdl.validate_bundle(str(root / names[-1]))
    check(ok, f"bundle {names[-1]}: {why}")
    newest = root / names[-1]
    check(filecmp.cmp(newest / "train.npz", model, shallow=False),
          "the top-level train.npz differs from the newest bundle's member")
    members = sorted(manifest["members"])
    # a crash copy (hardlinks; the newest model member cut to its first
    # 4 KiB)
    crash = WORK / "crash"
    shutil.rmtree(crash, ignore_errors=True)
    crash.mkdir()
    shutil.copytree(root, crash / root.name, copy_function=os.link)
    victim = crash / root.name / names[-1] / "train.npz"
    with open(victim, "rb") as fh:
        head = fh.read(4096)
    victim.unlink()
    victim.write_bytes(head)
    opt = _OptimizerArrays()
    params, config, state = ckpt.load_checkpoint(str(crash / "train.npz"),
                                                 opt)
    want, _ = mio.load_model(str(root / names[-2] / "train.npz"))
    check(state.batches == WARM_UPDATES
          and sorted(params) == sorted(want)
          and all(np.array_equal(params[k], want[k]) for k in want)
          and opt.arrays is not None,
          f"the crash copy restored update {state.batches}, not the bundle "
          f"before the truncated one")
    shutil.rmtree(crash)
    print(f"bundles: train.npz.bundles holds {names} after {saves} saves, "
          f"each validates ({len(members)} members: {members}; the older "
          f"one in the restore); train.npz is "
          f"{names[-1]}'s member byte for byte; with its model member "
          f"truncated the restore falls back to {names[-2]} (update "
          f"{WARM_UPDATES}, parameters equal)")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str, method: str = "GET"):
    """(status, body) of one request to the metrics port."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as fh:
            return fh.status, fh.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def commit_copy(model: Path, src_bundle: str, state=None) -> str:
    """Commit a bundle of ``src_bundle``'s model member under ``model``
    through the port's save_checkpoint (the trainer's commit)."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.training import checkpoint as ckpt
    from marian_tpu_torch.training.training_state import TrainingState
    params, config = mio.load_model(src_bundle)
    ckpt.save_checkpoint(str(model), params, config,
                         state=state or TrainingState())
    from marian_tpu_torch.training import bundle as bdl
    return os.path.join(bdl.bundle_root(str(model)),
                        bdl.list_bundles(bdl.bundle_root(str(model)))[-1])


async def closed_loop(port: int, sents, clients: int, until):
    """``clients`` clients, each sending its share of ``sents`` one
    request after another (the next once the reply is in), and on from
    the start of its share until ``until()`` holds: (sentence, reply,
    start, end) of every request, in the order they ended."""
    out = []

    async def client(c):
        mine = sents[c::clients]
        i = 0
        while i < len(mine) or not until():
            text = mine[i % len(mine)]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            try:
                payload = text.encode("utf-8")
                t0 = time.perf_counter()
                writer.write(b"MTPU %d\n" % len(payload) + payload)
                await writer.drain()
                header = await reader.readline()
                check(header.startswith(b"MTPU "), f"reply header {header!r}")
                body = await reader.readexactly(int(header.split()[1]))
                out.append((text, body.decode("utf-8"), t0,
                            time.perf_counter()))
            finally:
                writer.close()
            i += 1
    await asyncio.gather(*[client(c) for c in range(clients)])
    return out


def latency_classes(done, warm, swap) -> str:
    """Served p50/p99 of the requests that ended before the candidate's
    warmup, overlapped it (load + golden decode), and started after the
    swap."""
    groups = {"before the warmup": [d for d in done if d[3] < warm[0]],
              "during the warmup": [d for d in done
                                    if d[2] < warm[1] and d[3] > warm[0]],
              "after the swap": [d for d in done if d[2] >= swap]}
    parts = []
    for name, ds in groups.items():
        if ds:
            p = np.percentile([1e3 * (d[3] - d[2]) for d in ds], [50, 99])
            parts.append(f"{name} {len(ds)} requests p50 {p[0]:.1f} ms "
                         f"p99 {p[1]:.1f} ms")
        else:
            parts.append(f"{name} no request")
    return "; ".join(parts)


def watch_lifecycle(app, times: dict) -> None:
    """Wraps the app's SwapController: into ``times`` go the times each
    ingest (compat check, load, golden decode, install) started and
    ended and each swap happened, by bundle name."""
    ctrl = app.lifecycle
    ingest, swap = ctrl.ingest, ctrl._swap_to_live

    def timed_ingest(bundle_dir, manifest):
        name = os.path.basename(bundle_dir)
        times[name, "ingest"] = time.perf_counter()
        try:
            return ingest(bundle_dir, manifest)
        finally:
            times[name, "done"] = time.perf_counter()

    def timed_swap(v):
        swap(v)
        times[v.name, "swap"] = time.perf_counter()
    ctrl.ingest, ctrl._swap_to_live = timed_ingest, timed_swap
    app.watcher.on_bundle = timed_ingest


def wait_until(pred, what: str, timeout: float = 120.0) -> None:
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout, f"timed out: {what}")
        time.sleep(0.01)


def phase_lifecycle_serve(seed: int) -> dict:
    """The model lifecycle in request mode (the server's default, beam
    12) at full width, with --model-watch 0.2 and --metrics-port, on the
    copying weights' 2+2-layer cut (SERVE_CUT_MODEL; depth cut for time)
    committed as bundle A of ``life.npz``:

    - /readyz answers 503 while the server boots (its --warmup-on-boot
      golden decode) and 200 once it serves;
    - swap under load: the port's marian_train, in this process, trains
      2 updates on life.npz (resuming from A) and commits B, while 16
      clients send 256 sentences one request after another (and on until
      B has served a while); zero failures, every reply equals
      Translate.run of A or of B on the card, and once /lifecyclez shows
      B live every reply is B's (the outcome series by version);
    - canary rollback at --canary-fraction 0.5 --canary-min-batches 8: a
      candidate C (B's weights, committed again) whose executor the
      phase wraps to raise after its golden decode is rolled back with
      zero client failures, counted in /metrics; the card's allocated
      bytes rise by C's model while it is canary and fall back when it
      is released;
    - compat refusal: a bundle D whose manifest has another vocabulary
      hash is refused with nothing loaded (allocated bytes unchanged);
    - POST /admin/rollback returns live to A.
    The swap runs with the canary fraction at 0 (an immediate swap)."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.server.server import ServingApp, _make_tcp_handler
    from marian_tpu_torch.training import bundle as bdl
    from marian_tpu_torch.training import checkpoint as ckpt
    from marian_tpu_torch.training.training_state import TrainingState
    from marian_tpu_torch.training.graph_group import GraphGroup
    from marian_tpu_torch.training.train import Train
    from marian_tpu_torch.common import io as mio
    import shutil
    model = WORK / "life.npz"
    for f in WORK.glob("life*"):
        shutil.rmtree(f) if f.is_dir() else f.unlink()
    # A: the copying weights under the trainer's own config (its geometry
    # and vocabularies: the compat block B's commit will carry)
    params, _ = mio.load_model(str(WORK / SERVE_CUT_MODEL))
    tconfig = parse_options(train_argv("life.npz", 0, *LIFE_DEPTH),
                            mode="training").as_yaml()
    ckpt.save_checkpoint(str(model), params, tconfig, state=TrainingState())
    mport = free_port()
    opts = request_options("--models", str(model), "--model-watch", "0.2",
                           "--metrics-port", str(mport),
                           "--canary-fraction", "0.5",
                           "--canary-min-batches", "8", "--warmup-on-boot")
    sents = serve_sentences(seed, SERVE_SENTENCES)
    torch.cuda.synchronize()
    reset_counts()
    t_phase = time.perf_counter()
    # B: the trainer's own commit, in this process. It loads its data and
    # A's bundle while the server boots, and takes its first update once
    # the server serves (``serving``), so its commit lands under load
    serving, train_err = threading.Event(), []
    update = GraphGroup.update

    def gated(gg, *args, **kw):
        serving.wait(120)
        return update(gg, *args, **kw)

    def train_b():
        try:
            # no EMA: B's commit holds what the server loads (the model
            # member) and the optimizer state, not a smoothed copy that
            # no check reads
            Train(parse_options(train_argv("life.npz", 2, "--overwrite",
                                           "--exponential-smoothing", "0",
                                           *LIFE_DEPTH),
                                mode="training")).run()
        except BaseException as e:  # noqa: BLE001
            train_err.append(e)
    GraphGroup.update = gated
    trainer = threading.Thread(target=train_b, daemon=True)
    trainer.start()
    app = ServingApp(opts)
    ctrl = app.lifecycle
    check(ctrl is not None and ctrl.live_version_name() == "bundle-00000001",
          f"boot did not adopt bundle A: {ctrl and ctrl.status()}")
    ctrl.canary_fraction = 0.0
    times = {}
    ready_codes = []
    stop_poll = threading.Event()

    def poll_ready():
        while not stop_poll.is_set():
            try:
                ready_codes.append(http_get(mport, "/readyz")[0])
            except OSError:
                pass                      # not listening yet
            if ready_codes and ready_codes[-1] == 200:
                return
            time.sleep(0.005)
    poller = threading.Thread(target=poll_ready, daemon=True)
    poller.start()
    model_b = model_bytes(app.service.translator.params)
    res = {}

    async def serve():
        app.start()
        watch_lifecycle(app, times)
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_event_loop()
        try:
            await loop.run_in_executor(None, poller.join, 30)

            def until():
                t = times.get(("bundle-00000002", "swap"))
                return t is not None and time.perf_counter() - t > 1.0
            serving.set()
            done = await closed_loop(port, sents, SERVE_CLIENTS, until)
            await loop.run_in_executor(None, trainer.join, 120)
            GraphGroup.update = update
            check(not train_err, f"training B failed: {train_err}")
            code, body = await loop.run_in_executor(
                None, http_get, mport, "/lifecyclez")
            status = json.loads(body)
            check(code == 200 and status["live"] == "bundle-00000002"
                  and status["rollback_target"] == "bundle-00000001",
                  f"/lifecyclez after the swap: {status}")
            res["swap"] = done
            # post-swap: 32 more, every reply B's
            outs = app.registry.get("marian_serving_request_outcomes_total")
            b_ok = outs.labels("ok", "bundle-00000002").value
            post = sents[:32]
            res["post"], _ = await serve_traffic(port, post, SERVE_CLIENTS)
            check(outs.labels("ok", "bundle-00000002").value - b_ok == 32,
                  "post-swap requests not resolved under B's version")
            # C: a canary that fails every batch after its golden decode
            ctrl.canary_fraction = 0.5
            real = ctrl.executor_factory

            def factory(bundle_dir, manifest):
                ex = real(bundle_dir, manifest)
                if int(manifest["seq"]) != 3:
                    return ex
                calls = [0]

                def failing(lines):
                    calls[0] += 1
                    if calls[0] > 1:
                        raise RuntimeError("candidate C fails its batches")
                    return ex(lines)
                return failing
            ctrl.executor_factory = factory
            gc.collect()
            mem0 = torch.cuda.memory_allocated()
            b_member = os.path.join(bdl.bundle_root(str(model)),
                                    "bundle-00000002", "life.npz")
            await loop.run_in_executor(None, commit_copy, model, b_member)
            await loop.run_in_executor(
                None, wait_until,
                lambda: ctrl.status()["canary"] == "bundle-00000003",
                "C canary")
            mem1 = torch.cuda.memory_allocated()
            short = [" ".join(s.split()[:4]) for s in sents[:16]]
            canary = []
            for text in short:
                canary.append(await serve_traffic(port, [text], 1))
            gc.collect()
            mem2 = torch.cuda.memory_allocated()
            res["canary"] = [(t, r[0][0]) for t, r in zip(short, canary)]
            res["mem"] = (mem0, mem1, mem2)
            code, metrics = await loop.run_in_executor(
                None, http_get, mport, "/metrics")
            res["metrics"] = metrics
            # D: another vocabulary's hash in its manifest
            manifest = bdl.validate_bundle(os.path.dirname(b_member))[2]
            bad = json.loads(json.dumps(manifest["compat"]))
            bad["vocabs"][0]["sha256"] = "0" * 64
            gc.collect()
            mem_d = torch.cuda.memory_allocated()
            await loop.run_in_executor(
                None, lambda: bdl.write_bundle(
                    str(model), {"life.npz": lambda p: os.link(b_member, p)},
                    compat=bad))
            await loop.run_in_executor(
                None, wait_until,
                lambda: any(r["version"] == "bundle-00000004"
                            and r["state"] == "rejected"
                            for r in ctrl.status()["versions"]), "D refused")
            gc.collect()
            res["mem_d"] = (mem_d, torch.cuda.memory_allocated())
            # the admin verb
            code, body = await loop.run_in_executor(
                None, http_get, mport, "/admin/rollback", "POST")
            res["admin"] = (code, json.loads(body))
            res["after_admin"], _ = await serve_traffic(port, sents[:4], 4)
            res["status"] = ctrl.status()
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
    asyncio.run(serve())
    stop_poll.set()
    torch.cuda.synchronize()
    counts = read_counts()
    secs = time.perf_counter() - t_phase
    tr = app.service.translator
    # the references: Translate.run of A (the boot service) and of B
    ref_a = tr.run(sents, io.StringIO())
    done = res["swap"]
    warm = (times[("bundle-00000002", "ingest")],
            times[("bundle-00000002", "swap")])
    # B answers nothing that ended before its warmup began
    late_sents = sorted({t for t, _, _, t1 in done if t1 >= warm[0]}
                        | set(sents[:32]))
    short = [t for t, _ in res["canary"]]
    svc_b = app._bundle_service(os.path.join(
        bdl.bundle_root(str(model)), "bundle-00000002"))
    got_b = svc_b.translator.run(late_sents + short, io.StringIO())
    del svc_b
    ref_b = dict(zip(late_sents, got_b))
    ref_short = got_b[len(late_sents):]
    ref = {s: (a, ref_b.get(s)) for s, a in zip(sents, ref_a)}
    bad = [(t, r) for t, r, _, _ in done if r not in ref[t]]
    check(not bad, f"swap under load: {len(bad)} replies equal neither A's "
          f"nor B's Translate.run ({bad[:2]})")
    swap_t = times[("bundle-00000002", "swap")]
    late = [(t, r) for t, r, t0, _ in done if t0 >= swap_t
            and r != ref[t][1]]
    check(not late and all(r == ref[t][1] for t, r in
                           zip(sents[:32], res["post"])),
          f"replies after the swap that are not B's: {late[:2]}")
    check(not [t for t, r, _, t1 in done if t1 < warm[0] and r != ref[t][0]],
          "a reply that ended before B's warmup is not A's")
    check(ready_codes and ready_codes[0] == 503 and ready_codes[-1] == 200,
          f"/readyz while booting and serving: {ready_codes[:3]} ... "
          f"{ready_codes[-1:]}")
    st = res["status"]
    states = {r["version"]: r["state"] for r in st["versions"]}
    check(states.get("bundle-00000003") == "failed"
          and "marian_lifecycle_rollbacks_total 1" in res["metrics"]
          and [r for _, r in res["canary"]] == ref_short,
          f"canary C: {states}, replies {res['canary'][:2]}")
    mem0, mem1, mem2 = res["mem"]
    check(mem1 - mem0 >= 0.9 * model_b and abs(mem2 - mem0) < model_b / 4,
          f"canary bytes: {mem0} before, {mem1} while C is canary, {mem2} "
          f"after its release (one model {model_b})")
    check(states.get("bundle-00000004") == "rejected"
          and res["mem_d"][0] == res["mem_d"][1],
          f"D: {states.get('bundle-00000004')}, allocated {res['mem_d']}")
    code, body = res["admin"]
    check(code == 200 and body["live"] == "bundle-00000001"
          and st["live"] == "bundle-00000001"
          and res["after_admin"] == ref_a[:4],
          f"POST /admin/rollback: {code} {body}, live {st['live']}")
    check(all(counts[k] > 0 for k in ("decode_attention", "packed_attention",
                                      "packed_attention_bwd", "fused_ce_fwd",
                                      "fused_ce_dx", "fused_ce_dw")),
          f"lifecycle serve launches {counts}")
    cfg = tr.model.cfg
    print(f"lifecycle serve: request mode, beam 12, copying transformer "
          f"{cfg.enc_depth}+{cfg.dec_depth}, dim {cfg.dim_emb}, vocab "
          f"{len(tr.trg_vocab)} ({model_b / 1e9:.3f} GB of weights), "
          f"--model-watch 0.2: /readyz "
          f"{ready_codes[0]} while booting ({len(ready_codes)} polls), then "
          f"200; B committed by marian_train (2 updates, in this process) "
          f"under load: {len(done)} requests from {SERVE_CLIENTS} clients, "
          f"zero failures, each reply A's or B's Translate.run; B warmed "
          f"(load + golden decode) in {warm[1] - warm[0]:.3f} s and swapped "
          f"in; {latency_classes(done, warm, swap_t)}; 32 after the swap all "
          f"B's")
    print(f"lifecycle serve: canary C rolled back after "
          f"{len(res['canary'])} requests with zero failures (rollbacks "
          f"counted in /metrics); allocated {mem0 / 2**30:.3f} GiB before "
          f"C, {mem1 / 2**30:.3f} GiB while C is canary (+"
          f"{(mem1 - mem0) / 2**30:.3f} GiB), {mem2 / 2**30:.3f} GiB after "
          f"its release; D refused for its vocabulary hash, allocated bytes "
          f"unchanged; POST /admin/rollback -> live {body['live']}; phase "
          f"{secs:.1f} s; launches {counts}")
    return counts


def dense_greedy_texts(tr, engine, sents, caps=None) -> list:
    """The dense greedy decode of each of ``sents`` on ``tr``'s model,
    cut at its cap (``caps``, else its ``engine`` cap) and EOS, 256
    sentences a batch."""
    from marian_tpu_torch.translator.greedy import greedy_decode
    if caps is None:
        caps = [engine.decode_cap(len(tr.src_vocab.encode(t)))
                for t in sents]
    out = []
    for i in range(0, len(sents), 256):
        chunk, ccaps = sents[i:i + 256], caps[i:i + 256]
        _, src, mask = source_batch(tr, chunk, engine.device)
        dense = greedy_decode(tr.model, tr.params, src, mask, max(ccaps))
        for j, cap in enumerate(ccaps):
            toks = list(dense[j, :cap])
            toks = toks[:toks.index(0)] if 0 in toks else toks
            out.append(tr.trg_vocab.decode(toks))
    return out


def phase_lifecycle_iteration(seed: int) -> dict:
    """The model lifecycle in iteration mode, through the scheduler's
    quiesce protocol, on the copying weights' 2+2-layer cut
    (SERVE_CUT_MODEL) committed as bundle A of ``iter.npz``:

    - greedy at 64 slots with --quiesce-deadline 0.5: B (the same
      weights, committed again) is committed while 16 clients send 256
      sentences one request after another; every reply is A's dense
      greedy decode, B's, or !!SERVER-RETRY, the retries equal
      marian_serving_quiesce_evictions_total, the old engine's pool
      audits clean with every page free, the new engine's too after the
      traffic; a third commit retires A out of the rollback slot, and
      its engine and KV pool leave the card (A's weights stay: the boot
      model the server rebuilds from);
    - the fused beam at beam 6, FUSED_STEPS steps a round, on 8
      sentences with the live engine's rounds under
      torch.cuda.set_sync_debug_mode("error"): a commit swaps in (its
      load and golden decode on the watcher thread never overlap a
      guarded round), every reply the dense beam search's best or
      !!SERVER-RETRY, the retries the quiesce evictions, the sync-debug
      mode back to its default."""
    import shutil
    import weakref
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.server.server import ServingApp, _make_tcp_handler
    from marian_tpu_torch.serving import metrics as msm
    from marian_tpu_torch.training import bundle as bdl
    from marian_tpu_torch.training import checkpoint as ckpt
    from marian_tpu_torch.training.training_state import TrainingState
    model = WORK / "iter.npz"
    for f in WORK.glob("iter*"):
        shutil.rmtree(f) if f.is_dir() else f.unlink()
    params, config = mio.load_model(str(WORK / SERVE_CUT_MODEL))
    ckpt.save_checkpoint(str(model), params, config, state=TrainingState())
    a_member = os.path.join(bdl.bundle_root(str(model)), "bundle-00000001",
                            "iter.npz")
    sents = serve_sentences(seed, SERVE_SENTENCES)
    torch.cuda.synchronize()
    reset_counts()
    t_phase = time.perf_counter()
    reg = msm.Registry()
    app = ServingApp(serve_options("--model-watch", "0.2",
                                   "--quiesce-deadline", "0.5",
                                   model="iter.npz"), registry=reg)
    sched, ctrl = app.scheduler, app.lifecycle
    check(ctrl.live_version_name() == "bundle-00000001", "boot did not "
          "adopt bundle A")
    eng_a = weakref.ref(sched.engine)
    pool_a = engine_pool_bytes(sched.engine)
    times, res = {}, {}

    async def serve():
        app.start()
        watch_lifecycle(app, times)
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_event_loop()
        try:
            async def commit_b():
                await asyncio.sleep(0.3)       # rows are decoding
                await loop.run_in_executor(None, commit_copy, model,
                                           a_member)

            def until():
                t = times.get(("bundle-00000002", "swap"))
                return t is not None and time.perf_counter() - t > 1.0
            committer = asyncio.ensure_future(commit_b())
            res["done"] = await closed_loop(port, sents, SERVE_CLIENTS,
                                            until)
            await committer
            old = eng_a()
            res["old_audit"] = (old.audit(), old.pool.free_pages()
                                == old.pool.usable_pages, old.idle())
            del old
            eng_b = sched.engine
            res["new_audit"] = (eng_b.audit(), eng_b.idle(),
                                eng_b is ctrl.live_version().executor.engine)
            del eng_b
            res["evictions"] = sched.m_quiesce_evictions.value
            res["quiesces"] = sched.m_quiesces.value
            # B2: A leaves the rollback slot, its engine and pool the card
            gc.collect()
            mem0 = torch.cuda.memory_allocated()
            await loop.run_in_executor(None, commit_copy, model, a_member)
            await loop.run_in_executor(
                None, wait_until,
                lambda: ctrl.live_version_name() == "bundle-00000003",
                "B2 live")
            gc.collect()
            res["mem"] = (mem0, torch.cuda.memory_allocated(),
                          model_bytes(ctrl.live_version().executor.engine
                                      .params))
            res["a_gone"] = eng_a() is None
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
    asyncio.run(serve())
    tr = app.service.translator
    done = res["done"]
    engine_b = ctrl.live_version().executor.engine
    ref_a = dense_greedy_texts(tr, engine_b, sents)
    svc_b = app._bundle_service(os.path.join(bdl.bundle_root(str(model)),
                                             "bundle-00000002"))
    ref_b = dense_greedy_texts(svc_b.translator, engine_b, sents)
    del svc_b
    ref = {s: (a, b) for s, a, b in zip(sents, ref_a, ref_b)}
    retries = [r for _, r, _, _ in done if r.startswith("!!SERVER-RETRY")]
    bad = [(t, r) for t, r, _, _ in done
           if r not in ref[t] and not r.startswith("!!SERVER-RETRY")]
    check(not bad, f"iteration swap: {len(bad)} replies are neither A's, "
          f"B's nor a retry ({bad[:2]})")
    check(len(retries) == res["evictions"] and res["quiesces"] == 1,
          f"{len(retries)} retries, {res['evictions']} quiesce evictions, "
          f"{res['quiesces']} quiesces")
    check(res["old_audit"] == ([], True, True) and res["new_audit"][0] == []
          and res["new_audit"][2], f"audits: old {res['old_audit']}, new "
          f"{res['new_audit']}")
    mem0, mem1, b2_bytes = res["mem"]
    check(res["a_gone"] and abs((mem1 - mem0) - b2_bytes) < pool_a / 2,
          f"A's engine {'freed' if res['a_gone'] else 'still held'}; "
          f"allocated {mem0} -> {mem1} over B2's load ({b2_bytes} bytes of "
          f"weights, A's pool {pool_a})")
    warm = (times[("bundle-00000002", "ingest")],
            times[("bundle-00000002", "swap")])
    counts_greedy = read_counts()
    print(f"lifecycle iteration: copying transformer "
          f"{engine_b.model.cfg.enc_depth}+{engine_b.model.cfg.dec_depth}, "
          f"greedy, {SERVE_ROWS} slots, "
          f"--quiesce-deadline 0.5: {len(done)} requests from "
          f"{SERVE_CLIENTS} clients while B was committed, warmed (load, "
          f"golden decode, {len(engine_b.row_buckets)} row buckets) and "
          f"swapped in through one quiesce: each reply A's or B's dense "
          f"greedy decode or one of {len(retries)} !!SERVER-RETRY (= "
          f"{int(res['evictions'])} quiesce evictions); ingest to swap "
          f"{warm[1] - warm[0]:.3f} s; {latency_classes(done, warm, warm[1])};"
          f" the old pool audited clean with every page free; a third "
          f"commit released A's engine and its {pool_a / 2**20:.1f} MiB "
          f"pool (allocated {mem0 / 2**30:.3f} -> {mem1 / 2**30:.3f} GiB "
          f"over B2's {b2_bytes / 2**30:.3f} GiB load)")
    del engine_b
    app = ctrl = sched = None
    gc.collect()

    # the fused beam, the live engine's rounds under the sync guard
    sents8 = sents[:8]
    reg = msm.Registry()
    app = ServingApp(beam_serve_options(
        "--iteration-steps", str(FUSED_STEPS), "--model-watch", "0.2",
        "--quiesce-deadline", "0.5", merge=None, model="iter.npz"),
        registry=reg)
    engine = app.scheduler.engine
    engine.sync_debug = "error"
    times = {}

    async def serve_beam():
        app.start()
        watch_lifecycle(app, times)
        server = await asyncio.start_server(_make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_event_loop()
        try:
            async def commit_b():
                await asyncio.sleep(0.3)
                await loop.run_in_executor(None, commit_copy, model,
                                           a_member)
            committer = asyncio.ensure_future(commit_b())
            replies, _ = await serve_traffic(port, sents8, len(sents8))
            await committer
            await loop.run_in_executor(
                None, wait_until,
                lambda: app.lifecycle.live_version_name()
                == "bundle-00000004", "the beam swap")
            return replies
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
    replies = asyncio.run(serve_beam())
    engine.sync_debug = None
    torch.cuda.synchronize()
    counts = read_counts()
    check(torch.cuda.get_sync_debug_mode() == 0, "the sync-debug mode was "
          "not handed back")
    tr = app.service.translator
    ids = [tr.src_vocab.encode(t) for t in sents8]
    caps = [engine.decode_cap(len(x)) for x in ids]
    best = dense_beam_best(tr, sents8, caps, engine)
    want = [tr.trg_vocab.decode(b["tokens"]) for b in best]
    retries = sum(r.startswith("!!SERVER-RETRY") for r in replies)
    check(all(r == w or r.startswith("!!SERVER-RETRY")
              for r, w in zip(replies, want))
          and retries == app.scheduler.m_quiesce_evictions.value
          and engine.audit() == []
          and engine.pool.free_pages() == engine.pool.usable_pages,
          f"fused beam swap: replies {replies[:2]}, {retries} retries, "
          f"{app.scheduler.m_quiesce_evictions.value} evictions")
    check(counts["paged_decode_attention"] > 0
          and counts["packed_attention"] > 0,
          f"lifecycle iteration launches {counts}")
    print(f"lifecycle iteration: fused beam {SERVE_BEAM}, {FUSED_STEPS} "
          f"steps a round, the live engine under the sync guard: 8 "
          f"sentences while a commit was warmed (on the watcher thread, "
          f"outside every guarded round) and swapped in: each reply the "
          f"dense beam search's best or one of {retries} !!SERVER-RETRY (= "
          f"the quiesce evictions); the old pool audited clean; sync-debug "
          f"mode back to default; phase {time.perf_counter() - t_phase:.1f}"
          f" s; launches {counts} (greedy part {counts_greedy})")
    return counts


def write_corpus(seed: int) -> None:
    """A synthetic parallel corpus from ``seed``: random words of the
    32,000-word vocabulary, 8-63 words a line on each side."""
    rng = np.random.RandomState(seed + 2)
    for side in ("src", "trg"):
        lens = rng.randint(8, 64, TRAIN_LINES)
        write_lines(f"train.{side}", lens, rng)


def write_lines(name: str, lens, rng, vocab: int = VOCAB) -> None:
    ids = rng.randint(2, vocab, int(lens.sum()))
    words = np.char.add("w", ids.astype(str))
    cuts = np.cumsum(lens)[:-1]
    (WORK / name).write_text(
        "\n".join(" ".join(l) for l in np.split(words, cuts)) + "\n")


def write_doc_corpus(seed: int, name: str, lines: int, lo: int, hi: int,
                     trg_lo: int, trg_hi: int, vocab: int = VOCAB) -> None:
    """A synthetic document-level corpus by bench.py's long-line rule
    (bench.py:109-130): source lengths uniform in [lo, hi] words, target
    lengths the source's times U(0.9, 1.1), clipped to [trg_lo, trg_hi]."""
    rng = np.random.RandomState(seed)
    n = rng.randint(lo, hi + 1, lines)
    m = np.clip((n * rng.uniform(0.9, 1.1, lines)).astype(int), trg_lo,
                trg_hi)
    write_lines(f"{name}.src", n, rng, vocab)
    write_lines(f"{name}.trg", m, rng, vocab)


def train_argv(model: str, updates: int, *extra: str, corpus: str = "train",
               vocab: str = "vocab.yml"):
    vocab = str(WORK / vocab)
    return [*TRAIN_FLAGS, "--train-sets", str(WORK / f"{corpus}.src"),
            str(WORK / f"{corpus}.trg"), "--vocabs", vocab, vocab, "--model",
            str(WORK / model), "--mini-batch-words", str(TRAIN_WORDS),
            "--after-batches", str(updates), *extra]


def doc_argv(model: str, updates: int, *extra: str):
    return train_argv(model, updates, *DOC_FLAGS, "--mini-batch-words",
                      str(DOC_WORDS), *extra, corpus="doc")


def recording_validators(valid: list):
    """A stand-in for the trainer's ``create_validators`` that wraps each
    validator's ``validate``: every call appends to ``valid`` a dict of
    the update, the metric, the value, its seconds and launches (the
    card synchronized around it), and for cross-entropy a copy of the
    parameters it validated."""
    from marian_tpu_torch.training import train as train_mod
    create = train_mod.create_validators

    def wrapped(*args, **kw):
        vals = create(*args, **kw)
        for v in vals:
            def validate(params, _v=v, _run=v.validate):
                torch.cuda.synchronize()
                before = read_counts()
                t0 = time.perf_counter()
                value = _run(params)
                torch.cuda.synchronize()
                after = read_counts()
                rec = {"update": _v.training_state.batches
                       if getattr(_v, "training_state", None) else None,
                       "metric": _v.name, "value": value,
                       "seconds": time.perf_counter() - t0,
                       "counts": {k: after[k] - before[k] for k in after}}
                if _v.name == "cross-entropy":
                    for earlier in valid:       # only the last is kept
                        earlier.pop("params", None)
                    rec["params"] = {k: t.detach().clone()
                                     for k, t in params.items()}
                valid.append(rec)
                return value
            v.validate = validate
        return vals
    return wrapped


def model_only_save(path, params, config_yaml, *args, suffix: str = "",
                    **kw) -> None:
    """A stand-in for the trainer's ``save_checkpoint`` that writes the
    parameters and their config only (what a later decode reads), for
    the paths whose bundles no check reads."""
    from marian_tpu_torch.common import io as mio
    from marian_tpu_torch.training.checkpoint import suffixed_path
    mio.save_model(suffixed_path(path, suffix) if suffix else path,
                   {k: v.detach().cpu().numpy() for k, v in params.items()},
                   config_yaml)


@contextlib.contextmanager
def trainer_saves(writer):
    """The trainer's checkpoint writes through ``writer`` (None: the
    trainer's own), each call recorded in the list this yields."""
    from marian_tpu_torch.training import train as train_mod
    calls, save = [], train_mod.save_checkpoint

    def recorded(path, *args, **kw):
        calls.append((path, kw.get("suffix", "")))
        return (writer or save)(path, *args, **kw)
    train_mod.save_checkpoint = recorded
    try:
        yield calls
    finally:
        train_mod.save_checkpoint = save


def train_main_path(what: str, argv, model: str, warm: int, counted: int,
                    per_update: dict, valid: Optional[list] = None,
                    warm_in_run: bool = False, saves="bundle") -> dict:
    """``warm`` updates through ``marian_train.main`` (which write the
    checkpoint), then ``counted`` updates through the trainer object
    ``main`` drives, resuming from it, with every launch count set to 0
    just before and read just after; prints the path's line and returns
    the counts. With ``warm_in_run`` the trainer object runs all
    ``warm + counted`` updates and the count starts at update ``warm +
    1``. ``saves``: "bundle" the trainer's checkpoints, "model" the
    parameters only (``model_only_save``: what a later decode reads),
    "none" nothing written (the trainer's save still reached). An update
    may take a list of micro-batches (--optimizer-delay). ``valid``: the
    counted run's validations are recorded there
    (``recording_validators``), and their launches and their time
    between the first and the last update (with what a caller adds to a
    record's seconds, as the keep-best saves) are not the updates'."""
    from marian_tpu_torch.cli import marian_train
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.training import train as train_mod
    from marian_tpu_torch.training.graph_group import GraphGroup
    from marian_tpu_torch.training.train import Train
    for f in WORK.glob(f"{model}*"):
        shutil.rmtree(f) if f.is_dir() else f.unlink()
    writer = {"bundle": None, "model": model_only_save,
              "none": lambda *a, **kw: None}[saves]
    t0 = time.perf_counter()
    if not warm_in_run:
        marian_train.main(argv(model, warm))
        check((WORK / f"{model}.optimizer.npz").exists(),
              "warm-up checkpoint")
    warm_s = time.perf_counter() - t0
    total = warm + counted
    tr = Train(parse_options(argv(model, total), mode="training"))
    check(tr.device.type == "cuda", f"trainer resolved {tr.device}")
    # each update's outputs, recorded as the trainer makes them (device
    # scalars, read after the run), and the host clock from the first
    # update's start to the last update's end
    outs, clock = [], {}
    update = GraphGroup.update
    create = train_mod.create_validators

    def recorded(gg, batches, step, *args, **kw):
        if step <= warm:            # a warm-up update of this run
            out = update(gg, batches, step, *args, **kw)
            if step == warm:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
            return out
        if not outs:
            torch.cuda.synchronize()
            clock["start"] = time.perf_counter()
            clock["valid"] = len(valid or ())
        out = update(gg, batches, step, *args, **kw)
        group = batches if isinstance(batches, list) else [batches]
        outs.append((out.loss_sum, out.labels,
                     sum(b["src_mask"].sum() for b in group)))
        if len(outs) == counted:
            torch.cuda.synchronize()
            clock["end"] = time.perf_counter()
            clock["valid_end"] = len(valid or ())
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    GraphGroup.update = recorded
    if valid is not None:
        train_mod.create_validators = recording_validators(valid)
    try:
        with trainer_saves(writer) as written:
            tr.run()
    finally:
        GraphGroup.update = update
        train_mod.create_validators = create
    check(any(not sfx for _, sfx in written), f"{what}: the trainer's "
          f"final save was not reached: {written}")
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    updates = len(outs)
    check(updates == counted and tr.state.batches == total,
          f"counted run did {updates} updates, state at {tr.state.batches}")
    side = {name: sum(v["counts"][name] for v in valid or ())
            for name in counts}
    want = {name: per_update.get(name, 0) * updates + side[name]
            for name in counts}
    check(counts == want, f"training launches {counts}, expected {want} "
          f"({per_update} per update, validations {side})")
    loss_sum, trg_tokens, src_tokens = (
        np.array([float(o[i]) for o in outs]) for i in range(3))
    costs = loss_sum / trg_tokens
    check(bool(np.isfinite(costs).all()), f"training losses {costs}")
    params = tr.graph_group.export_params()
    check(all(bool(torch.isfinite(p).all()) for p in params.values()),
          "non-finite parameters after training")
    # validations between the first and the last update are not updates
    secs = clock["end"] - clock["start"] - sum(
        v["seconds"] for v in (valid or [])[clock["valid"]:
                                            clock["valid_end"]])
    TRAIN_RUNS[model] = {"ms": 1e3 * secs / updates, "peak_gb": peak_gb}
    if valid is not None:
        TRAIN_RUNS[model]["trainer"] = tr     # the validation checks' own
    warm_line = (f"warm-up {warm} updates in the same run" if warm_in_run
                 else f"warm-up {warm} updates through marian_train.main in "
                 f"{warm_s:.2f} s")
    print(f"train main path: {what}: {warm_line}; saves: {saves}; "
          f"counted {updates} updates "
          f"in {secs:.3f} s, {1e3 * secs / updates:.2f} ms/update, "
          f"{src_tokens.sum() / secs:.1f} source tokens/s, "
          f"{trg_tokens.sum() / secs:.1f} target tokens/s; "
          f"peak memory {peak_gb:.2f} GB; mean CE first/last "
          f"{costs[0]:.4f}/{costs[-1]:.4f}; launches {counts}, per update "
          f"{ {k: (v - side[k]) // updates for k, v in counts.items() if v} }")
    return counts


def phase_train_main_path(seed: int) -> dict:
    write_corpus(seed)
    counts = train_main_path(
        f"transformer-base 6+6, dim 512, ffn 2048, 8 heads, vocab {VOCAB}, "
        f"f32, dropout 0.1, {TRAIN_WORDS} target words a batch",
        lambda model, updates: train_argv(model, updates, "--overwrite"),
        "train.npz", WARM_UPDATES, COUNTED_UPDATES, PER_UPDATE)
    # decode a few sentences on the card from the checkpoint just written
    from marian_tpu_torch.translator.translator import Translate
    src = (WORK / "train.src").read_text().splitlines()[:8]
    trn = Translate(decoder_options("train.npz", "--n-best"))
    hyps = [l.split(" ||| ") for s in trn.run(src, io.StringIO())
            for l in s.splitlines()]
    scores = np.array([float(h[2].split()[1]) for h in hyps])
    check(len(hyps) == BEAM * len(src) and bool(np.isfinite(scores).all()),
          f"decode of the trained checkpoint: {len(hyps)} hypotheses")
    print(f"train main path: decoded {len(src)} sentences from the trained "
          f"checkpoint on the card, {len(hyps)} hypotheses, best score "
          f"{scores.max():.3f}")
    return counts


def delay_argv(model: str, updates: int, *extra: str):
    """The delay + validation path's flags (see DELAY)."""
    dev = [str(WORK / "dev.src"), str(WORK / "dev.trg")]
    return train_argv(
        model, updates, "--mini-batch-words", str(TRAIN_WORDS // DELAY),
        "--optimizer-delay", str(DELAY), "--valid-sets", *dev,
        "--valid-freq", f"{VALID_FREQ}u", "--valid-metrics", *DELAY_METRICS,
        "--valid-mini-batch", str(DEV_LINES), "--beam-size", str(BEAM),
        "--keep-best", "--lr-decay", "0.5", "--lr-decay-strategy",
        "stalled", "--lr-decay-start", "1", *LIFE_DEPTH, "--overwrite",
        *extra)


def expected_bests(valid: list) -> dict:
    """metric -> the updates at which it improved, by the trainer's rule
    (the first validation always; then strictly better, epsilon 0)."""
    best, out = {}, {}
    for v in valid:
        m, x = v["metric"], v["value"]
        lower = m == "cross-entropy"
        if m not in best or (x < best[m] if lower else x > best[m]):
            best[m] = x
            out.setdefault(m, []).append(v["update"])
    return out


def dev_ce_recomputed(gg, params, vocab) -> float:
    """The dev set's mean cross-entropy (--cost-type ce-mean-words) from
    ``params``, one sentence a forward on the card: other batch shapes
    and padding than the validator's."""
    from marian_tpu_torch.data.batch_generator import make_batch
    from marian_tpu_torch.data.corpus import SentenceTuple
    from marian_tpu_torch.models.encoder_decoder import batch_to_arrays
    src = (WORK / "dev.src").read_text().splitlines()
    trg = (WORK / "dev.trg").read_text().splitlines()
    total = labels = 0.0
    with torch.no_grad():
        for i, (s, t) in enumerate(zip(src, trg)):
            batch = make_batch([SentenceTuple(i, [vocab.encode(s),
                                                  vocab.encode(t)])], 2)
            _, aux = gg.model.loss(params, batch_to_arrays(batch, gg.device),
                                   None, train=False)
            total += float(aux["ce_sum"])
            labels += float(aux["labels"])
    return total / labels


def phase_delay_train_main_path(seed: int) -> dict:
    """The delay + validation train main path: the 2+2 cut of
    transformer-base at full width (a depth cut for the run's writes and
    time) at --optimizer-delay 2 (two micro-batches of TRAIN_WORDS / 2
    words an update, the warm-up updates in the same run), validated every VALID_FREQ updates on the dev set
    (cross-entropy, bleu, chrf, translation: the packed encoder and
    decode_attention through the port's beam search), with --keep-best
    and stall-driven --lr-decay. Checks: twice PER_UPDATE's launches an
    update; validations at the updates --valid-freq names, their decodes
    through decode_attention and the packed forward; the dev
    cross-entropy of the last validation recomputed; bleu and chrf
    equal to corpus_bleu / corpus_chrf of Translate.run of their
    ``.best-*`` checkpoint on the card; the ``.best-*`` files written at
    the updates where their metric improved; the progress file's lr
    decay factor following the stall counts."""
    from marian_tpu_torch.data.vocab import create_vocab
    from marian_tpu_torch.training import train as train_mod
    from marian_tpu_torch.training.training_state import TrainingState
    from marian_tpu_torch.translator.metrics import corpus_bleu, corpus_chrf
    from marian_tpu_torch.translator.translator import Translate
    rng = np.random.RandomState(seed + 21)
    for side in ("src", "trg"):
        write_lines(f"dev.{side}", rng.randint(8, 64, DEV_LINES), rng)
    valid, saves = [], []
    save = train_mod.save_checkpoint

    def recorded_save(path, *args, suffix: str = "", **kw):
        if not suffix:
            return save(path, *args, **kw)
        # a keep-best save is its validation's time, not the updates'
        t0 = time.perf_counter()
        save(path, *args, suffix=suffix, **kw)
        valid[-1]["seconds"] += time.perf_counter() - t0
        saves.append((valid[-1]["update"], suffix))
    train_mod.save_checkpoint = recorded_save
    try:
        counts = train_main_path(
            f"transformer-base 2+2 (full width), dim 512, ffn 2048, 8 "
            f"heads, vocab {VOCAB}, f32, dropout 0.1, --optimizer-delay "
            f"{DELAY} x {TRAIN_WORDS // DELAY} target words, validated "
            f"every {VALID_FREQ} updates", delay_argv, "train_delay.npz",
            WARM_UPDATES, COUNTED_UPDATES,
            {k: DELAY * v for k, v in PER_UPDATE_2X2.items()}, valid,
            warm_in_run=True)
    finally:
        train_mod.save_checkpoint = save
    total = WARM_UPDATES + COUNTED_UPDATES
    fired = sorted({v["update"] for v in valid})
    check(fired == [u for u in range(WARM_UPDATES + 1, total + 1)
                    if u % VALID_FREQ == 0]
          and [v["metric"] for v in valid] == list(DELAY_METRICS)
          * len(fired), f"validations at {fired}: "
          f"{[(v['update'], v['metric']) for v in valid]}")
    decodes = [v["counts"] for v in valid if v["metric"] != "cross-entropy"]
    check(all(c["decode_attention"] > 0 and c["packed_attention"] > 0
              for c in decodes), f"validation decodes launched {decodes}")
    # the dev loss of the last validation, recomputed from its parameters
    last_ce = [v for v in valid if v["metric"] == "cross-entropy"][-1]
    vocab = create_vocab(str(WORK / "vocab.yml"))
    tr = TRAIN_RUNS["train_delay.npz"].pop("trainer")
    ce = dev_ce_recomputed(tr.graph_group, last_ce.pop("params"), vocab)
    ce_err = abs(ce - last_ce["value"]) / abs(ce)
    check(ce_err <= CE_REL_TOL, f"dev cross-entropy {last_ce['value']} "
          f"against {ce} recomputed: {ce_err:.3g} > {CE_REL_TOL}")
    bests = expected_bests(valid)
    check(sorted(saves) == sorted((u, f".best-{m}") for m, us in
                                  bests.items() for u in us),
          f".best-* saves {saves}, improvements {bests}")
    # the translation metrics against Translate.run of their checkpoint
    # (the smoothed parameters each validated: --exponential-smoothing)
    src = (WORK / "dev.src").read_text().splitlines()
    refs = (WORK / "dev.trg").read_text().splitlines()
    metric_checks = []
    for m, fn in (("bleu", corpus_bleu), ("chrf", corpus_chrf)):
        at = bests[m][-1]
        want = [v["value"] for v in valid
                if v["metric"] == m and v["update"] == at][0]
        path = WORK / f"train_delay.best-{m}.ema.npz"
        trn = Translate(decoder_options(
            path.name, "--mini-batch", str(DEV_LINES), "--maxi-batch", "1",
            "--max-length", "63"))
        got = fn(trn.run(src, io.StringIO()), refs)
        check(got == want, f"{m} {want} at update {at}, Translate.run of "
              f"{path.name}: {got}")
        metric_checks.append(f"{m} {got:.4f} (update {at})")
    state = TrainingState.load(str(WORK / "train_delay.npz.progress.yml"))
    stalls = _ce_stalls(valid)
    factor = 0.5 ** sum(s >= 1 for s in stalls)
    check(state.factor == factor
          and tr.graph_group.schedule.decay_factor == factor,
          f"lr decay factor {state.factor} (schedule "
          f"{tr.graph_group.schedule.decay_factor}), stalls {stalls}: "
          f"expected {factor}")
    n_params = sum(p.numel() for p in tr.graph_group.params.values())
    per_val = {v["metric"]: round(v["seconds"], 3) for v in valid[-4:]}
    print(f"delay train main path: validations at updates {fired}: "
          + "; ".join(f"up {u}: " + ", ".join(
              f"{v['metric']} {v['value']:.4f}" for v in valid
              if v["update"] == u) for u in fired)
          + f"; seconds of the last {per_val}, of all with the keep-best "
          f"saves {sum(v['seconds'] for v in valid):.2f}; dev cross-entropy "
          f"recomputed {ce:.6f} (relative {ce_err:.2g}, tolerance "
          f"{CE_REL_TOL}); {', '.join(metric_checks)} equal Translate.run "
          f"of their .best checkpoint; .best saves {sorted(saves)}; stalls "
          f"of cross-entropy {stalls}, lr factor {state.factor}; "
          f"ms/update {TRAIN_RUNS['train_delay.npz']['ms']:.2f}, peak "
          f"{TRAIN_RUNS['train_delay.npz']['peak_gb']:.2f} GB "
          f"({n_params} parameters, the 2+2 cut)")
    return counts


def _ce_stalls(valid: list) -> list:
    """The cross-entropy validator's stall count after each validation
    (the trainer's global count: --early-stopping-on first)."""
    best, stalled, out = None, 0, []
    for v in valid:
        if v["metric"] != "cross-entropy":
            continue
        if best is None or v["value"] < best:
            best, stalled = v["value"], 0
        else:
            stalled += 1
        out.append(stalled)
    return out


def write_doc_train_corpus(seed: int) -> None:
    """doc.src / doc.trg: DOC_LINES documents of 1,023-2,047 words."""
    write_doc_corpus(seed + 3, "doc", DOC_LINES, 1023, 2047, 4, 2047)


def phase_doc_train_main_path(seed: int) -> dict:
    """The doc-level training main path: the 2+2 cut of transformer-big
    at full width on the 2,048-token corpus, every attention through
    flash; the warm-up updates in the same run, its save the model file
    the doc decode reads."""
    write_doc_train_corpus(seed)
    return train_main_path(
        f"doc-level transformer-big 2+2 (full width), dim 1024, ffn 4096, "
        f"16 heads, vocab {VOCAB}, f32, dropout 0.1, lines of 1,023-2,047 "
        f"words, {DOC_WORDS} target words a batch",
        lambda model, updates: doc_argv(model, updates, *DOC_DEPTH),
        "doc.npz", DOC_WARM, DOC_COUNTED, DOC_PER_UPDATE_2X2,
        warm_in_run=True, saves="model")


def phase_doc_decode_main_path() -> dict:
    """The doc-level decode main path: the trained doc checkpoint decodes
    DOC_DOCS documents of its corpus at beam 6 with a cache of 0.5 x the
    source width (1,024 at width 2,048): the encoder through the flash
    forward, the cached self-attention through decode_attention."""
    docs = (WORK / "doc.src").read_text().splitlines()[:DOC_DOCS]
    tr, hyps, secs, counts = decode_run(
        "doc.npz", docs, "--max-length", "2048",
        "--max-length-factor-translate", "0.5")
    check_decode_counts(tr, counts, 1, "flash_attention_fwd")
    steps = list(tr.search.steps)
    scores = np.array([float(h[2].split()[1]) for h in hyps])
    print(f"doc decode main path: the trained doc-level transformer-big "
          f"2+2, "
          f"{len(docs)} documents of {[len(d.split()) for d in docs]} words "
          f"in 1 batch, beam {BEAM}, cache {tr.search.max_length_factor} x "
          f"width: steps {steps}, {secs:.3f} s, {len(docs) / secs:.3f} "
          f"sentences/s, {1e3 * secs / sum(steps):.3f} ms per decode step "
          f"(whole run / steps); {len(hyps)} hypotheses, scores finite, "
          f"best {scores.max():.3f}; launches {counts}")
    return counts


def parity_setup(argv, n_batches: int, corpus: str = "train",
                 vocab: str = "vocab.yml"):
    """A card-vs-CPU training cut from ``argv`` (the training flags),
    ``n_batches`` batches of it, initial parameters from seed 5, and as
    many sets of random gradients (seed 6) for the update tail alone.
    Returns (options, vocab size, batches, initial params, step
    gradients)."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.data.batch_generator import BatchGenerator
    from marian_tpu_torch.data.corpus import Corpus
    from marian_tpu_torch.data.vocab import create_vocab
    from marian_tpu_torch.models import transformer as T
    from marian_tpu_torch.models.encoder_decoder import create_model
    opts = parse_options(argv, mode="training")
    vocab = create_vocab(str(WORK / vocab))
    batches = []
    for batch in BatchGenerator(Corpus([str(WORK / f"{corpus}.src"),
                                        str(WORK / f"{corpus}.trg")],
                                       [vocab, vocab], opts), opts):
        batches.append(batch)
        if len(batches) == n_batches:
            break
    model = create_model(opts, len(vocab), len(vocab))
    init = T.init_params(model.cfg, 5)
    gen = torch.Generator().manual_seed(6)
    step_grads = [{k: torch.randn(torch.as_tensor(v).shape, generator=gen)
                   for k, v in init.items()} for _ in batches]
    return opts, len(vocab), batches, init, step_grads


def base_parity_setup(*extra: str, batches: int = 3):
    """The card-vs-CPU training cut of transformer-base: 2+2 layers
    without dropout, ``batches`` batches of about 2,048 target words and
    a constant learning rate of 2e-4 (no warm-up), so that the Adam
    updates move every parameter by about the rate; ``extra`` flags
    last."""
    return parity_setup(train_argv("cut.npz", batches, "--enc-depth", "2",
                                   "--dec-depth", "2",
                                   "--transformer-dropout", "0",
                                   "--mini-batch-words", "2048",
                                   "--lr-warmup", "0", *extra), batches)


def delay_parity_setup():
    """The base cut at --optimizer-delay 2: one update of two
    micro-batches."""
    return base_parity_setup("--optimizer-delay", str(DELAY),
                             batches=DELAY)


def doc_parity_setup(seed: int, *extra: str):
    """The doc-level card-vs-CPU cut: 2+2 layers, dim 256, 4 heads, a
    500-word vocabulary, without dropout, on documents of 1,200-1,400
    source and 1,100-1,500 target words (width 1,536 on both sides, so
    every attention takes flash), 2 batches of 3,072 target words, a
    constant rate of 2e-4; ``extra`` flags last."""
    write_doc_corpus(seed + 4, "doc_cut", 16, 1200, 1400, 1100, 1500,
                     VOCAB_CUT)
    return parity_setup(train_argv(
        "doc_cut_train.npz", 2, *DOC_CUT_FLAGS, "--transformer-dropout", "0",
        "--mini-batch-words", "3072", "--lr-warmup", "0", *extra,
        corpus="doc_cut", vocab="vocab_cut.yml"), 2, corpus="doc_cut",
        vocab="vocab_cut.yml")


def parity_run(opts, n_vocab: int, batches, init, step_grads,
               device: str) -> dict:
    """On ``device``, from the same initial parameters: the gradient of
    every leaf on the first batch; an update through the GraphGroup for
    each batch, or each group of --optimizer-delay batches (mean CE and
    global gradient norm of each); and the update tail alone
    (cost normalisation, clipping, Adam, EMA: ``finalize_update``) for 3
    steps on ``step_grads``, with each leaf's change over them. Tensors
    come back as float64 on the CPU."""
    from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                         create_model)
    from marian_tpu_torch.training.graph_group import (GraphGroup,
                                                       cost_denominator,
                                                       finalize_update)
    dev = torch.device(device)

    def graph_group():
        gg = GraphGroup(create_model(opts, n_vocab, n_vocab), opts, dev)
        gg.initialize(init)
        return gg
    gg = graph_group()
    arrays = [batch_to_arrays(b, dev) for b in batches]
    names = list(gg.params)
    total, _ = gg.model.loss(gg.params, arrays[0], None, train=True)
    grads = torch.autograd.grad(total, [gg.params[k] for k in names],
                                allow_unused=True)
    grads = {k: (torch.zeros_like(gg.params[k]) if g is None else g)
             .detach().cpu().double() for k, g in zip(names, grads)}
    groups = [arrays[i:i + gg.delay]
              for i in range(0, len(arrays), gg.delay)]
    outs = [gg.update(g, i + 1) for i, g in enumerate(groups)]
    tail = graph_group()
    for i, (batch, g) in enumerate(zip(batches, step_grads)):
        labels = torch.tensor(float(batch.words), device=dev)
        finalize_update(tail.opt_cfg, tail.opt_state, tail.params,
                        {k: v.to(dev) for k, v in g.items()},
                        tail.schedule(i + 1), labels,
                        cost_denominator(tail.cost_type, labels, batch.size))
    return {"loss": [float(o.loss_sum) / float(o.labels) for o in outs],
            "norm": [float(o.grad_norm) for o in outs], "grad": grads,
            "update": {k: tail.params[k].detach().cpu().double()
                       - torch.as_tensor(init[k]).double() for k in names}}


def parity_readings(got: dict, ref: dict) -> dict:
    """Card (``got``) against CPU (``ref``): {reading: (value, where)},
    each a relative difference, the worst over its parts:

    - ``loss``: per-update mean CE and global gradient norm of the 3
      updates. Adam steps each element by about the rate times the sign
      of its gradient, so an element whose gradient is near 0 may step
      the other way on the other device, and the trajectories part: this
      reading catches only gross faults;
    - ``grad``: a leaf's gradient, |g_card - g_cpu| / |g_cpu| (Frobenius
      norms). One ReLU whose input rounds to the other side of 0 adds an
      outer product of about 1/sqrt(tokens x width) of the FFN gradient,
      so this reading has a floor of some 1e-4;
    - ``grad_norm``: |(|g_card| - |g_cpu|)| / |g_cpu| per leaf, which such
      orthogonal noise barely moves and a scaled gradient moves fully;
    - ``update``: a leaf's change over the 3 steps of the update tail on
      the same gradients, |d_card - d_cpu| / |d_cpu|.

    The attention key biases (``*_bk``) are left out of the gradient
    readings: a bias added to every key moves a row of scores by one
    constant, which softmax ignores, so their gradient is 0 in exact
    arithmetic and rounding noise in f32."""
    a = np.array(got["loss"] + got["norm"])
    b = np.array(ref["loss"] + ref["norm"])

    def worst(part, norms=False):
        x, y = got[part], ref[part]
        errs = {}
        for k in y:
            if part == "grad" and k.endswith("_bk"):
                continue
            ny = float(y[k].norm())
            diff = (abs(float(x[k].norm()) - ny) if norms
                    else float((x[k] - y[k]).norm()))
            errs[k] = diff / max(ny, 1e-30)
        k = max(errs, key=errs.get)
        return errs[k], k
    return {"loss": (float(np.max(np.abs(a - b) / np.abs(b))),
                     "mean CE and gradient norm"),
            "grad": worst("grad"), "grad_norm": worst("grad", norms=True),
            "update": worst("update")}


def parity_holds(readings: dict, limits: dict = PARITY_LIMITS) -> bool:
    return all(readings[k][0] <= limits[k] for k in readings)


def batch_words(batches) -> list:
    return [int(b.words) for b in batches]


def train_card_vs_cpu(what: str, setup, limits: dict = PARITY_LIMITS,
                      cpu: dict = None) -> None:
    """A training cut run on the card (kernels) and on the CPU (plain
    versions) from the same parameters on the same batches; held to
    ``limits``. ``cpu``: the CPU's run, made already by the child
    process (``cpu_references``) on its own copy of the same data."""
    res = {}
    n = len(setup[2])
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if name == "cpu" and cpu is not None:
            check(cpu["words"] == batch_words(setup[2]), f"{what}: the "
                  f"child's batches {cpu['words']} are not the card's")
            res[name] = loaded_run(cpu["run"], setup[3])
            took = f"{cpu['seconds']:.2f} s in the child process"
        else:
            res[name] = parity_run(*setup, name)
            took = f"{time.perf_counter() - t0:.2f} s"
        print(f"train card vs cpu: {what}: {name} "
              f"{len(res[name]['loss'])} updates of {n} batches, "
              f"{sum(b.words for b in setup[2])} target words, and {n} steps "
              f"of the update tail: {took}; mean CE {res[name]['loss']}"
              f"; gradient norm {res[name]['norm']}")
    check(bool(np.isfinite(res["cuda"]["loss"] + res["cuda"]["norm"]).all()),
          "non-finite card losses")
    readings = parity_readings(res["cuda"], res["cpu"])
    text = "; ".join(f"{k} {v:.3g} ({where}, limit {limits[k]})"
                     for k, (v, where) in readings.items())
    check(parity_holds(readings, limits),
          f"card vs cpu training, {what}: {text}")
    print(f"train card vs cpu: {what}: {text}")


def phase_train_card_vs_cpu() -> None:
    train_card_vs_cpu("2+2 cut of transformer-base", base_parity_setup())


def phase_delay_card_vs_cpu(ref: dict) -> None:
    """The base cut at --optimizer-delay 2 (one update of two
    micro-batches) on the card against the CPU's run in the child
    process, held to the unchanged f32 PARITY_LIMITS."""
    train_card_vs_cpu(f"2+2 cut of transformer-base, --optimizer-delay "
                      f"{DELAY}", delay_parity_setup(), PARITY_LIMITS,
                      ref["delay"])


def phase_doc_card_vs_cpu(seed: int) -> None:
    """The doc-level cut on card and CPU: decoding a document past 1,024
    tokens with a cache past the old 442-position cap (0.3 x width 1,536
    = 461 positions), and training (every attention through flash, the
    kernels on the card and their plain versions on the CPU)."""
    setup = doc_parity_setup(seed)
    doc = (WORK / "doc_cut.src").read_text().splitlines()[:1]
    decode_card_vs_cpu(f"a document of {len(doc[0].split())} words, doc "
                       f"cut (2+2, dim 256, vocab {VOCAB_CUT}), cache 0.3 x "
                       f"width", "doc_cut.npz", doc, "--max-length", "2048",
                       "--max-length-factor-translate", "0.3",
                       vocab="vocab_cut.yml")
    widths = sorted({(b.src.ids.shape[1], b.trg.ids.shape[1])
                     for b in setup[2]})
    check(all(min(w) > 1024 for w in widths), f"doc cut widths {widths}")
    reset_counts()
    train_card_vs_cpu(f"doc-level 2+2 cut, dim 256, 4 heads, widths "
                      f"{widths}", setup)
    counts = read_counts()
    check(counts["flash_attention_dkv"] > 0 and counts["packed_attention"]
          == 0, f"doc cut launches {counts}")


def phase_bf16_train_main_path() -> dict:
    """transformer-base training at --precision bfloat16 float32 on the
    base corpus (written by the f32 path): the fused CE through its bf16
    instantiations, one forward, dx and dw launch an update."""
    return train_main_path(
        f"transformer-base 6+6, dim 512, ffn 2048, 8 heads, vocab {VOCAB}, "
        f"bf16 compute from f32 master weights, dropout 0.1, {TRAIN_WORDS} "
        f"target words a batch",
        lambda model, updates: train_argv(model, updates, *BF16_FLAGS),
        "train_bf16.npz", BF16_WARM, BF16_COUNTED, PER_UPDATE_BF16,
        warm_in_run=True, saves="none")


def phase_bf16_decode_main_path(lines) -> dict:
    """The base decode main path at --precision bfloat16: bf16 weights,
    caches through decode_attention's bf16 path, f32 logits."""
    tr, _, secs, counts = decode_run("base.npz", lines, *BF16_FLAGS)
    check(tr.model.cfg.compute_dtype == torch.bfloat16
          and tr.params["Wemb"].dtype == torch.bfloat16,
          f"bf16 decode computes in {tr.model.cfg.compute_dtype}")
    check_decode_counts(tr, counts, N_BATCHES, "packed_attention_bf16_tc")
    steps = list(tr.search.steps)
    print(f"bf16 decode main path: transformer-base 6+6 in bf16, vocab "
          f"{VOCAB}, beam {BEAM}, {len(lines)} sentences x {SRC_LEN} tokens "
          f"in {N_BATCHES} batches of {BATCH}: steps {steps}, {secs:.3f} s, "
          f"{len(lines) / secs:.2f} sentences/s, "
          f"{1e3 * secs / sum(steps):.3f} ms per decode step (whole run / "
          f"steps); launches {counts}")
    return counts


def bf16_translator(name: str, model: str, *extra: str,
                    threads: int = 8):
    """A bf16 decoder of ``model`` (BF16_FLAGS) on ``name``'s device."""
    from marian_tpu_torch.translator.translator import Translate
    dev = () if name == "cuda" else ("--cpu-threads", str(threads))
    tr = Translate(decoder_options(model, "--n-best", *BF16_FLAGS, *extra,
                                   *dev))
    check(tr.device.type == name and tr.model.cfg.compute_dtype
          == torch.bfloat16, f"{name} bf16 decode: {tr.device}, "
          f"{tr.model.cfg.compute_dtype}")
    return tr


def nbest_score(fields) -> float:
    """The raw score of one n-best line's fields (after ``WordScores=``
    under --word-scores)."""
    return float(next(f for f in fields if f.startswith("Score="))
                 .split()[1])


def best_hypotheses(tr, sents, full: bool = False) -> list:
    """``tr``'s beam decode of ``sents``: the best hypothesis of each
    (``full``: its n-best fields)."""
    hyps = [[l.split(" ||| ") for l in s.splitlines()]
            for s in tr.run(sents, io.StringIO())]
    best = [max(h, key=nbest_score) for h in hyps]
    return best if full else [b[1] for b in best]


def bf16_decode_reading(model: str, sents, *extra: str,
                        cpu_best: list = None, counts: dict = None,
                        fields: list = None) -> dict:
    """The card's bf16 beam decode of ``sents`` (``model``, BF16_FLAGS),
    then both devices' steps on the card's best hypotheses (teacher
    forcing): {"decode": (largest |logit diff| over the largest |logit|,
    where), "identical": best hypotheses equal to the CPU's decode}.
    ``cpu_best``: the CPU's best hypotheses, decoded already by the child
    process. ``counts``: the card decode's launches are added to it (the
    counts set to 0 just before it); ``fields``: the card's best n-best
    fields are appended to it."""
    trs, best = {}, {}
    for name in ("cuda", "cpu"):
        trs[name] = tr = bf16_translator(name, model, *extra)
        if name == "cpu" and cpu_best is not None:
            best[name] = cpu_best
            continue
        if name == "cuda" and counts is not None:
            torch.cuda.synchronize()
            reset_counts()
        full = best_hypotheses(tr, sents, full=True)
        if name == "cuda" and counts is not None:
            torch.cuda.synchronize()
            for k, v in read_counts().items():
                counts[k] = counts.get(k, 0) + v
        if name == "cuda" and fields is not None:
            fields.extend(full)
        best[name] = [f[1] for f in full]
    # the forced decodes' lines carry their prefix after a TAB
    sents = [s.partition("\t")[0] for s in sents]
    tokens = [trs["cuda"].trg_vocab.encode(t) for t in best["cuda"]]
    forced = torch.zeros((len(tokens), max(map(len, tokens))),
                         dtype=torch.long)
    for i, t in enumerate(tokens):
        forced[i, :len(t)] = torch.tensor(t)
    logits = {}
    for name, tr in trs.items():
        _, src, mask = source_batch(tr, sents, tr.device)
        logits[name] = dense_step_logits(tr.model, tr.params, src, mask,
                                         forced.to(tr.device),
                                         fused=True).cpu()
    ref = logits["cpu"]
    err = float((logits["cuda"] - ref).abs().max() / ref.abs().max())
    same = sum(a == b for a, b in zip(best["cuda"], best["cpu"]))
    return {"decode": (err, f"{forced.shape[1]} forced steps of "
                       f"{len(sents)} sentences"), "identical": same}


def cpu_references(seed: int) -> None:
    """The CPU halves of phase_bf16_card_vs_cpu, in a child process
    (--cpu-references) while the parent builds the kernels and runs the
    kernel phases: the same
    data from ``seed`` in CPU_WORK, then on CPU_REF_THREADS threads the
    bf16 beam decode of the 2+2 base cut (its best hypotheses) and the
    CPU runs of the base and doc-level bf16 training cuts, saved to
    CPU_WORK/cpu_references.pt for the parent."""
    global WORK
    WORK = CPU_WORK
    torch.set_num_threads(CPU_REF_THREADS)
    lines = write_model(seed, cuts_only=True)
    write_corpus(seed)
    write_extras_data(seed, vectors=False)
    t0 = time.perf_counter()
    tr = bf16_translator("cpu", "base_2x2.npz", threads=CPU_REF_THREADS)
    out = {"decode_best": best_hypotheses(tr, lines[:8]),
           "decode_seconds": time.perf_counter() - t0}
    write_lex(seed)
    for name, (sents, extra) in surface_bf16_cases(lines).items():
        tr = bf16_translator("cpu", "base_2x2.npz", *extra,
                             threads=CPU_REF_THREADS)
        out[f"surface_{name}"] = best_hypotheses(tr, sents)
    out["decode_seconds"] = time.perf_counter() - t0
    cuts = [("base", lambda: base_parity_setup(*BF16_FLAGS)),
            ("doc", lambda: doc_parity_setup(seed, *BF16_FLAGS)),
            ("delay", delay_parity_setup)]
    cuts += [(f"extras_{name}",
              lambda name=name: base_parity_setup(*extras_cut_flags(name)))
             for name in EXTRAS_CUTS]
    for cut, setup in cuts:
        args = setup()
        t0 = time.perf_counter()
        out[cut] = {"run": stored_run(parity_run(*args, "cpu"), args[3]),
                    "seconds": time.perf_counter() - t0,
                    "words": batch_words(args[2])}
    torch.save(out, CPU_WORK / "cpu_references.pt")


def stored_run(run: dict, init) -> dict:
    """A ``parity_run`` result in half the bytes, for the child's file:
    its gradients (f32 values) as f32, and its update as the f32
    parameters it ended at (``loaded_run`` restores both exactly)."""
    return {**run, "grad": {k: v.float() for k, v in run["grad"].items()},
            "update": {k: (v + torch.as_tensor(init[k]).double()).float()
                       for k, v in run["update"].items()}}


def loaded_run(run: dict, init) -> dict:
    """``stored_run`` undone: the float64 gradients and update."""
    return {**run, "grad": {k: v.double() for k, v in run["grad"].items()},
            "update": {k: v.double() - torch.as_tensor(init[k]).double()
                       for k, v in run["update"].items()}}


def start_cpu_references(seed: int):
    """The child process of ``cpu_references``, its output to
    CPU_WORK/log.txt."""
    CPU_WORK.mkdir(parents=True, exist_ok=True)
    (CPU_WORK / "cpu_references.pt").unlink(missing_ok=True)
    with open(CPU_WORK / "log.txt", "w") as log:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seed",
             str(seed), "--cpu-references"], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)


def collect_cpu_references(child) -> dict:
    """Waits for the child and loads what it saved."""
    rc = child.wait(timeout=900)
    if rc != 0:
        fail(f"the CPU references' child process exited {rc}: "
             f"{(CPU_WORK / 'log.txt').read_text()[-3000:]}")
    ref = torch.load(CPU_WORK / "cpu_references.pt")
    print(f"cpu references (child process, {CPU_REF_THREADS} threads): bf16 "
          f"decodes of 8 sentences (plain, shortlisted, forced) "
          f"{ref['decode_seconds']:.2f} s, base cut "
          f"{ref['base']['seconds']:.2f} s, doc cut "
          f"{ref['doc']['seconds']:.2f} s, f32 delay cut "
          f"{ref['delay']['seconds']:.2f} s, train extras cuts "
          + ", ".join(f"{name} {ref[f'extras_{name}']['seconds']:.2f} s"
                      for name in EXTRAS_CUTS))
    return ref


def surface_bf16_cases(lines) -> dict:
    """The bf16 decode-surface readings' inputs: 8 sentences through the
    lex table in WORK (``--shortlist lex.s2t 100 20 --word-scores``),
    and the same sentences with one forced prefix, the first one's
    first 3 source words, as ``source<TAB>prefix`` lines
    (``--force-decode``; the decoder refuses the pair together)."""
    sents = lines[:8]
    forced = [f"{s}\t" for s in sents]
    forced[0] += " ".join(sents[0].split()[:3])
    return {"shortlist": (sents, ("--shortlist", str(WORK / "lex.s2t"),
                                  "100", "20", "--word-scores")),
            "forced": (forced, ("--force-decode",))}


def phase_bf16_decode_surface(lines, ref: dict) -> dict:
    """The decode surface in bf16 (``surface_bf16_cases``) on the 2+2
    base cut at beam BEAM, each held as the bf16 decode is held
    (bf16_decode_reading: card against the CPU's decode from the child,
    by the step logits on the card's own tokens, PARITY_LIMITS_BF16's
    decode limit); the word scores sum to each best hypothesis's raw
    score, the forced sentence's best hypothesis starts with its prefix.
    Returns the card decodes' launches (rows 1b, 2b)."""
    counts = {}
    limit = PARITY_LIMITS_BF16["decode"]
    for name, (sents, extra) in surface_bf16_cases(lines).items():
        fields = []
        got = bf16_decode_reading("base_2x2.npz", sents, *extra,
                                  cpu_best=ref[f"surface_{name}"],
                                  counts=counts, fields=fields)
        err, where = got["decode"]
        check(err <= limit, f"bf16 {name} decode card vs cpu: {err:.3g} "
              f"({where}) > {limit}")
        extra_check = ""
        if name == "shortlist":
            gaps = [abs(sum(float(x) for x in f[2].split()[1:])
                        - nbest_score(f)) for f in fields]
            check(max(gaps) <= 1e-3, f"bf16 word scores against the raw "
                  f"scores: {gaps}")
            extra_check = (f"; word scores sum to the raw scores within "
                           f"{max(gaps):.3g}")
        else:
            prefix = sents[0].partition("\t")[2]
            check(fields[0][1].startswith(prefix), f"bf16 forced decode "
                  f"{fields[0][1][:40]!r} does not start with {prefix!r}")
            extra_check = f"; sentence 0 starts with its prefix {prefix!r}"
        print(f"bf16 decode surface: {name} ({' '.join(extra)}), 8 "
              f"sentences, 2+2 base cut, beam {BEAM}: step logits within "
              f"{err:.3g} of the largest ({where}, limit {limit}); best "
              f"hypotheses identical on card and CPU: {got['identical']} "
              f"of 8{extra_check}")
    check(counts["decode_attention"] > 0
          and counts["packed_attention_bf16_tc"] > 0,
          f"bf16 decode surface launches {counts}")
    print(f"bf16 decode surface: launches {counts}")
    return counts


def phase_bf16_card_vs_cpu(lines, seed: int, ref: dict) -> dict:
    """bf16 on the card against bf16 on the CPU, held to
    PARITY_LIMITS_BF16: the 2+2 base training cut, the doc-level cut
    (flash forward, dq and dkv in bf16) and the 2+2 base decode compared
    by its step logits on the card's own tokens. ``ref``: the CPU halves,
    from the child process. Returns the doc cut's launch counts (the
    bf16 flash kernels' path)."""
    got = bf16_decode_reading("base_2x2.npz", lines[:8],
                              cpu_best=ref["decode_best"])
    err, where = got["decode"]
    limit = PARITY_LIMITS_BF16["decode"]
    check(err <= limit, f"bf16 decode card vs cpu: {err:.3g} ({where}) > "
          f"{limit}")
    print(f"bf16 card vs cpu: decode of 8 sentences, 2+2 base cut, beam "
          f"{BEAM}: step logits within {err:.3g} of the largest ({where}, "
          f"limit {limit}); best hypotheses identical on card and CPU: "
          f"{got['identical']} of 8")
    train_card_vs_cpu("2+2 cut of transformer-base, bf16",
                      base_parity_setup(*BF16_FLAGS),
                      PARITY_LIMITS_BF16["base"], ref["base"])
    setup = doc_parity_setup(seed, *BF16_FLAGS)
    reset_counts()
    train_card_vs_cpu("doc-level 2+2 cut, dim 256, 4 heads, bf16", setup,
                      PARITY_LIMITS_BF16["doc"], ref["doc"])
    counts = read_counts()
    check(counts["flash_attention_fwd_bf16_tc"] == DOC_CUT_FLASH
          and counts["flash_attention_dkv_bf16_tc"] == DOC_CUT_FLASH
          and counts["flash_attention_dq_bf16_tc"] == DOC_CUT_FLASH
          and counts["flash_attention_fwd"] == 0
          and counts["flash_attention_dq"] == 0
          and counts["flash_attention_dkv"] == 0
          and counts["fused_ce_dx_bf16_tc"] > 0
          and counts["fused_ce_fwd_bf16_tc"] > 0
          and counts["fused_ce_dx_bf16"] == counts["fused_ce_dx"] == 0,
          f"bf16 doc cut launches {counts}: expected {DOC_CUT_FLASH} flash "
          f"forwards, dq and dkv on the tensor cores, none on the CUDA "
          f"cores")
    print(f"bf16 card vs cpu: the doc cut's flash launches by route: "
          f"forward {counts['flash_attention_fwd_bf16_tc']}, dq "
          f"{counts['flash_attention_dq_bf16_tc']} and dkv "
          f"{counts['flash_attention_dkv_bf16_tc']} on the tensor cores")
    return counts


# ---------------------------------------------------------------------------
# the test hooks (fault points, the lock-order and ownership witnesses)
# and the trainer's observability plane
# ---------------------------------------------------------------------------

def drill_rounds(engine, pending, until=None, rounds: int = 1) -> None:
    """Up to ``rounds`` admit+step rounds of ``engine`` joining what fits
    of ``pending`` [(key, text)] (taken off the list), or until
    ``until()``."""
    for _ in range(rounds):
        joins = [(k, t, {"sid": 0, "stream": False})
                 for k, t in pending[:engine.free_slots()]]
        taken = set(engine.admit_and_step(joins).accepted)
        pending[:] = [(k, t) for k, t in pending if k not in taken]
        if until is not None and until():
            break


def drill(what: str, engine, spec: str, needles, pending,
          rounds: int = 1, settle: bool = False) -> str:
    """One armed drill on a serving ``engine``: ``spec`` armed for the
    next rounds (up to ``rounds``, or until the point fired), disarmed
    (with ``settle``, rounds until the engine is idle), then the
    engine's audit must name one of ``needles``. Returns the audit line
    printed."""
    from marian_tpu_torch.common import faultpoints as fp
    name = spec.split("=")[0]
    fp.activate(spec)
    try:
        drill_rounds(engine, pending, until=lambda: fp.hits(name) >= 1,
                     rounds=rounds)
        fired = fp.hits(name)
    finally:
        fp.deactivate()
    check(fired >= 1, f"{what}: {name} was never crossed")
    if settle:
        drill_rounds(engine, pending, until=engine.idle, rounds=256)
    v = engine.audit()
    check(any(n in x for x in v for n in needles), f"{what}: the audit did "
          f"not name the corruption ({needles}): {v[:4]}")
    line = f"{what} ({spec}): {v[0]}" + (f" (+{len(v) - 1} more)"
                                         if len(v) > 1 else "")
    print(f"pool drills: {line}")
    return line


def phase_pool_drills(seed: int, smi: str) -> dict:
    """The corruption drills and the witnesses on the 2+2 cut at full
    width (SERVE_CUT_MODEL), with MARIAN_OWNWIT=1 and MARIAN_LOCKDEP=1
    set before its engines and pools are made (removed after, so no
    later phase pays for them). Each drill is armed once, in turn, on an
    engine serving rows that an unarmed round left audit-clean:
    pool.double_free, pool.table_corrupt and pool.release_drop on the
    greedy engine; pool.refcount_corrupt and beam.diff_corrupt on the
    fused beam engine at FUSED_STEPS steps a round, the step loop under
    the sync guard (a drill that synced the card there would raise);
    tenant.page_leak on a greedy engine serving two tenants' rows. Each
    corruption is named by the auditor the JAX package proves it
    against: the engine's audit, KVPool.audit() and, for the tenant
    leak, audit_tenants alone (the pool's audit stays clean); the
    ownership witness names the dropped release. Then
    serving.translate=hang:S at S = 2x --dispatch-stall-timeout trips the
    iteration-mode watchdog once, and the following requests are served.
    The witnessed locks show no acquisition-order cycle."""
    from marian_tpu_torch.common import faultpoints as fp
    from marian_tpu_torch.common import lockdep, ownwit
    from marian_tpu_torch.server.server import ServingApp
    from marian_tpu_torch.serving.fleet import accounting as acc
    os.environ[ownwit.ENV_VAR] = "1"
    os.environ[lockdep.ENV_VAR] = "1"
    lockdep.reset()
    ownwit.reset()
    torch.cuda.synchronize()
    reset_counts()
    lines = []
    sents = serve_sentences(seed + 12, 12)
    try:
        greedy = ServingApp(serve_options("--iteration-steps",
                                          str(FUSED_STEPS),
                                          model=SERVE_CUT_MODEL))
        check(greedy.scheduler.engine.pool._ownwit, "the pool is not "
              "witnessed")

        def serving(app, n: int = 8):
            """A fresh engine of ``app`` with ``n`` rows decoding after an
            unarmed round that audits clean."""
            engine = app._build_engine()
            pending = [(f"r{i}", t) for i, t in enumerate(sents[:n])]
            drill_rounds(engine, pending)
            check(engine.active_rows() > 0 and engine.audit() == []
                  and engine.pool.audit() == [],
                  f"an unarmed round audits {engine.audit()}")
            return engine, [(f"j{i}", t) for i, t in enumerate(sents[n:])]

        eng, more = serving(greedy)
        # the re-freed pages go back out to the round's joins
        lines.append(drill("greedy", eng, "pool.double_free=fail@1",
                           ("double-free", "refcount drift"), more))
        eng, more = serving(greedy)
        lines.append(drill("greedy", eng, "pool.table_corrupt=fail@1",
                           ("does not match its claim",), more))
        # the dropped release: a fresh witness, rows until one leaves,
        # then until every row has left
        ownwit.reset()
        eng, _ = serving(greedy, 4)
        lines.append(drill(
            "greedy", eng, "pool.release_drop=fail@1",
            ("has no active row",), [], rounds=64, settle=True))
        leaks = ownwit.check_balanced("kv-pages")
        check(len(leaks) == 1 and "iteration.py::_claim_pages" in leaks[0],
              f"the ownership witness: {leaks}")
        print(f"pool drills: ownership witness: {leaks[0]}")
        lines.append(f"witness: {leaks[0]}")

        beam = ServingApp(beam_serve_options("--iteration-steps",
                                             str(FUSED_STEPS), merge=None))
        for spec, needle, rounds in (
                ("pool.refcount_corrupt=fail@1", ("refcount",), 1),
                ("beam.diff_corrupt=fail@1", ("does not match its claim",),
                 16)):
            eng, more = serving(beam, 2)
            eng.sync_debug = "error"
            lines.append(drill(f"fused beam, {FUSED_STEPS} steps a round, "
                               f"sync guard", eng, spec, needle, more,
                               rounds=rounds))
            eng.sync_debug = None

        eng = greedy._build_engine()
        pending = [(f"{'ab'[i % 2]}/{i}", t) for i, t in enumerate(sents[:8])]
        drill_rounds(eng, pending)
        expected = {t: row["refs"] for t, row in
                    acc.tenant_page_sums(eng.pool.claims()).items()}
        check(set(expected) == {"a", "b"} and acc.audit_tenants(
            eng.pool, expected) == [], f"two tenants' rows: {expected}")
        lines.append(tenant_leak(eng, expected))
        del eng, greedy, beam
        gc.collect()

        # serving.translate=hang: the iteration watchdog trips once
        app = ServingApp(serve_options("--dispatch-stall-timeout",
                                       str(DRILL_STALL_S),
                                       model=SERVE_CUT_MODEL))
        spec = f"serving.translate=hang:{2 * DRILL_STALL_S}@1"
        t0 = time.perf_counter()
        stalled, mode, _, replies = stall_traffic(
            app, serve_sentences(seed + 1, 2), serve_sentences(seed + 9, 1)[0],
            serve_sentences(seed + 10, STALL_FOLLOWING),
            on_warm=lambda: fp.activate(spec))
        fp.deactivate()
        check_stall("pool drills: serving.translate hang", app, stalled,
                    mode, replies)
        line = (f"{spec} at --dispatch-stall-timeout {DRILL_STALL_S}: one "
                f"!!SERVER-RETRY, 1 watchdog trip, {len(replies)} following "
                f"requests served ({time.perf_counter() - t0:.2f} s)")
        print(f"pool drills: {line}")
        lines.append(line)
        del app
        cycles = lockdep.observed_cycles()
        nodes, edges = lockdep.observed_nodes(), lockdep.observed_edges()
        check(cycles == [], f"lock-order cycles: {cycles}")
        check(nodes <= lockdep.declared_names(), f"undeclared lock names "
              f"{nodes - lockdep.declared_names()}")
    finally:
        fp.reset_for_tests()
        os.environ.pop(ownwit.ENV_VAR, None)
        os.environ.pop(lockdep.ENV_VAR, None)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["paged_decode_attention"] > 0
          and counts["packed_attention"] > 0, f"drill launches {counts}")
    print(f"pool drills: lockdep witnessed {len(nodes)} locks "
          f"({', '.join(sorted(nodes))}), {len(edges)} acquisition edges, "
          f"no cycle; serve model {SERVE_CUT_DEPTH}+{SERVE_CUT_DEPTH} cut, "
          f"dim 512, vocab {VOCAB}; launches paged "
          f"{counts['paged_decode_attention']}, packed "
          f"{counts['packed_attention']}; {smi}")
    obs_reset()
    torch.cuda.empty_cache()
    return counts


def tenant_leak(engine, expected: dict) -> str:
    """The tenant.page_leak drill on ``engine``'s pool (two tenants'
    rows): KVPool.audit() stays clean, audit_tenants names the leak."""
    from marian_tpu_torch.common import faultpoints as fp
    from marian_tpu_torch.serving.fleet import accounting as acc
    with fp.active("tenant.page_leak=fail@1"):
        engine.pool.chaos_tenant_leak()
    pool_v = engine.pool.audit()
    bad = acc.audit_tenants(engine.pool, expected)
    check(pool_v == [] and any("under by 1" in b for b in bad)
          and any("over by 1" in b for b in bad),
          f"tenant leak: KVPool.audit() {pool_v}, audit_tenants {bad}")
    line = (f"two tenants (tenant.page_leak=fail@1): KVPool.audit() clean; "
            f"audit_tenants: {'; '.join(bad)}")
    print(f"pool drills: {line}")
    return line


def run_trainer(argv):
    """The trainer object marian_train.main drives, in this process."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.training.train import Train
    tr = Train(parse_options(argv, mode="training"))
    check(tr.device.type == "cuda", f"trainer resolved {tr.device}")
    tr.run()
    return tr


def chaos_harness():
    """scripts/torch_chaos.py as a module (stdlib and numpy only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_chaos", ROOT / "scripts" / "torch_chaos.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the processes this script starts beside its phases (stopped at exit)
STARTED = []


def start_chaos_runs() -> dict:
    """The chaos phase's processes, on the card, started to run beside
    the doc card-vs-CPU phase (its readings are no timing): the fixed
    round's killed trainer (CHAOS_FIXED, with --trace-dump), a
    ``marian_train`` process of the harness's config on a copy of its
    corpus, and the harness itself for its kill schedule (whose
    uninterrupted run, the same config on the same data, is the fixed
    round's reference too), --swap and --swap --iteration, each writing
    its report to a log."""
    chaos = chaos_harness()
    from marian_tpu_torch.common import faultpoints as fp
    root = WORK / "chaos"
    shutil.rmtree(root, ignore_errors=True)
    fixed = root / "fixed"
    (fixed / "kill").mkdir(parents=True)
    src, vocab = chaos.write_data(str(fixed), "base")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    env.pop(fp.ENV_SPEC, None)
    runs = {"t0": time.perf_counter(), "root": root, "chaos": chaos,
            "dump": fixed / "flight"}
    cfg = chaos.make_config(str(fixed / "kill"), src, vocab, False, "base",
                            cpu=False)
    runs["cfg"] = cfg
    with open(fixed / "kill.log", "w") as fh:
        runs["kill"] = subprocess.Popen(
            chaos._module_argv("marian_train",
                               {**cfg, "trace-dump": str(runs["dump"])}),
            env={**env, fp.ENV_SPEC: CHAOS_FIXED}, cwd=str(ROOT), stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True)
    STARTED.append(runs["kill"])
    script = str(ROOT / "scripts" / "torch_chaos.py")
    for name, work, extra in (
            ("kill schedule", "kill", ["--width", "base", "--rounds",
                                       str(CHAOS_KILL_ROUNDS), "--seed",
                                       str(CHAOS_KILL_SEED)]),
            ("--swap", "swap", ["--swap", "--rounds", "1", "--seed",
                                str(CHAOS_SWAP_SEED)]),
            ("--swap --iteration", "swap_iteration",
             ["--swap", "--iteration", "--rounds", "1", "--seed",
              str(CHAOS_SWAP_SEED)])):
        with open(root / f"{work}.log", "w") as fh:
            # a session of its own: stopping it stops its trainers and
            # servers too
            runs[name] = subprocess.Popen(
                [sys.executable, script, "--workdir", str(root / work),
                 *extra], env=env, cwd=str(ROOT), stdout=fh,
                stderr=subprocess.STDOUT, start_new_session=True)
        runs[f"{name} log"] = root / f"{work}.log"
        STARTED.append(runs[name])
    return runs


def stop(proc) -> None:
    """Kill ``proc`` and, when it leads a session of its own, every
    process of that session."""
    import signal
    try:
        if os.getpgid(proc.pid) == proc.pid:
            os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _waited(proc, timeout: float) -> int:
    try:
        return proc.wait(timeout=timeout)
    finally:
        stop(proc)


def phase_chaos_harness(runs: dict, smi: str) -> dict:
    """Crash safety on the card, the harness's contract: never torn,
    resumable, bit-exact.

    The fixed round (``start_chaos_runs``): the killed trainer exits 117
    at the second commit; one committed bundle, valid, and no staging
    directory listed as one; the kill's flight file holds the
    faultpoints member and the fault.fire event of ckpt.commit; a
    restart in this process (counted: the phase's launches) resumes from
    the bundle and ends with the uninterrupted run's parameters,
    optimizer state and progress, by the harness's digest, bit for bit.
    Then the harness's own reports: each kill round exits 117, validates
    every bundle and resumes bit-exact (an async round and a
    ckpt.async.worker round among them); the swap rounds' servers die at
    their armed point and restart clean on the newest bundle, iteration
    mode with no leaked page and no audit failure."""
    from marian_tpu_torch.common import faultpoints as fp
    from marian_tpu_torch.training import bundle as bdl
    chaos = runs["chaos"]
    fixed = runs["root"] / "fixed"
    rc = _waited(runs["kill"], 600)
    kill_s = time.perf_counter() - runs["t0"]
    log = (fixed / "kill.log").read_text()
    check(rc == fp.FAULT_EXIT_CODE, f"the killed trainer exited {rc}: "
          f"{log[-2000:]}")
    check("FAULTPOINT ckpt.commit hit 2: killing process" in log,
          "the kill's line is missing")
    model = fixed / "kill" / "model.npz"
    root = bdl.bundle_root(str(model))
    names = bdl.list_bundles(root)
    check(len(names) == 1, f"committed bundles after the kill: {names}")
    torn = chaos.validate_bundles(str(model))
    for n in names:
        ok, why, _ = bdl.validate_bundle(os.path.join(root, n))
        check(ok and not torn, f"bundle {n}: {why}; {torn}")
    stray = sorted(n for n in os.listdir(root) if n not in names)
    check(all(n.startswith(".staging-") for n in stray),
          f"the bundle directory holds {stray}")
    flights = sorted(runs["dump"].glob("flight-*fault-kill.json"))
    check(len(flights) == 1, f"flight files of the kill: {flights}")
    payload = json.loads(flights[0].read_text())
    fires = [e["args"]["point"] for e in payload["trace"]["traceEvents"]
             if e.get("name") == "fault.fire"]
    check(payload["faultpoints"]["spec"] == CHAOS_FIXED
          and payload["faultpoints"]["hits"].get("ckpt.commit") == 2
          and fires == ["ckpt.commit"], f"the flight file's fault plane: "
          f"{payload.get('faultpoints')}, fault.fire {fires}")
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    argv = chaos._module_argv("marian_train", runs["cfg"])[3:]
    resumed = run_trainer(argv)
    resume_s = time.perf_counter() - t1
    check(resumed.state.batches == CHAOS_UPDATES, "the resumed run ended at "
          f"update {resumed.state.batches}")
    del resumed
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: PER_UPDATE_2X2.get(k, 0) * (CHAOS_UPDATES - CHAOS_SAVE_FREQ)
            for k in counts}
    check(counts == want, f"the fixed round's resume launched {counts}, "
          f"expected {want}")
    # the harness's schedules; its kill schedule's uninterrupted run is
    # the fixed round's reference
    reports = {}
    for name in ("kill schedule", "--swap", "--swap --iteration"):
        reports[name] = _waited(runs[name], CHAOS_WAIT_S)
    bad = chaos.digest_violations(
        chaos.final_digest(str(model)),
        chaos.final_digest(str(runs["root"] / "kill" / "ref" / "model.npz")))
    check(not bad, f"the fixed round's resume: {bad}")
    print(f"chaos harness: [fixed] {CHAOS_FIXED} async=False: the 2+2 cut of "
          f"transformer-base (dim 512, vocab {VOCAB}, f32), "
          f"{CHAOS_UPDATES} updates, a save every {CHAOS_SAVE_FREQ}: kill run "
          f"exit {rc} ({kill_s:.2f} s after its start, beside the doc "
          f"card-vs-CPU phase), {len(names)} committed bundle(s) valid, "
          f"{len(stray)} staging director{'y' if len(stray) == 1 else 'ies'} "
          f"left unlisted, a flight file with the fault plane; resumed in "
          f"this process in {resume_s:.2f} s; digest BIT-EXACT against the "
          f"harness's uninterrupted run (parameters, optimizer state, "
          f"progress)")
    for name, rc in reports.items():
        text = runs[f"{name} log"].read_text()
        check(rc == 0, f"torch_chaos.py {name} exited {rc}: {text[-3000:]}")
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("[") or line.startswith(("kill run exit",
                                                         "ok:")) \
                    or "committed bundle(s)" in line \
                    or line.startswith(("restart live", "chaos")):
                print(f"chaos harness: {name}: {line}")
    kill = runs["kill schedule log"].read_text()
    check("async=True" in kill and "ckpt.async.worker=kill@" in kill
          and kill.count("ok: never torn, resumed bit-exact")
          == CHAOS_KILL_ROUNDS, f"the kill schedule's rounds: {kill[-2000:]}")
    check("restart live on bundle seq 2 (newest)" in
          runs["--swap log"].read_text()
          and "pool clean" in runs["--swap --iteration log"].read_text(),
          "the swap rounds' restarts")
    print(f"chaos harness: every round killed as armed, never torn, resumed "
          f"bit-exact or restarted clean on the newest bundle, "
          f"{time.perf_counter() - runs['t0']:.2f} s from the start of its "
          f"processes; {smi}")
    return counts


def phase_train_obs(seed: int, smi: str) -> dict:
    """The trainer's observability plane on the base train path, twice:
    without and with --trace-sync-phases, each OBS_TRAIN_UPDATES updates
    with --disp-freq OBS_DISP (four display windows), --metrics-port,
    --trace, --perf-accounting and a profiler window over updates 3 and
    4. A scrape of /metrics at the second display passes promlint and
    holds the six trainer series, the phase gauge and the two train
    gauges; marian_train_mfu lies in (0, 1] (f32, against the card's
    67 TFLOP/s f32 peak); chip-seconds per token x each window's labels
    is the window's logged time within 5%; /tracez holds the
    train.data, train.dispatch and train.host spans; the profiler trace
    names the port's own kernels of the packed attention and the fused
    CE. Prints the MFU and the ms per update of the last window (clean
    of the profiler) and the phase shares of each run, over the run and
    over the last window (its train.* spans)."""
    import re
    from marian_tpu_torch import obs
    from marian_tpu_torch.common import logging as mlog
    from marian_tpu_torch.serving import metrics as msm
    from marian_tpu_torch.serving.promlint import lint_metrics_text
    from marian_tpu_torch.training.scheduler import Scheduler
    series = ("marian_train_cost", "marian_train_words_per_second",
              "marian_train_learn_rate", "marian_train_updates_total",
              "marian_train_labels_total",
              "marian_train_updates_skipped_total",
              "marian_train_chip_seconds_per_token", "marian_train_mfu",
              "marian_step_phase_seconds")
    time_re = re.compile(r": Time ([0-9.]+)s :")
    torch.cuda.synchronize()
    reset_counts()
    runs = {}
    for sync in (False, True):
        obs_reset()
        for f in WORK.glob("obs.npz*"):
            shutil.rmtree(f) if f.is_dir() else f.unlink()
        prof = WORK / f"train_profile_{'sync' if sync else 'async'}"
        shutil.rmtree(prof, ignore_errors=True)
        port = free_port()
        windows, scraped = [], {}
        display, info = Scheduler._display, mlog.info

        def logged(msg, *args):
            line = msg.format(*args) if args else msg
            m = time_re.search(line)
            if m and windows and "time" not in windows[-1]:
                windows[-1]["time"] = float(m.group(1))
            return info(msg, *args)

        def displayed(sched):
            windows.append({"labels": sched._label_sum})
            display(sched)
            windows[-1]["at"] = time.perf_counter()
            windows[-1]["cspt"] = msm.REGISTRY.get(
                "marian_train_chip_seconds_per_token").value
            windows[-1]["mfu"] = msm.REGISTRY.get("marian_train_mfu").value
            if len(windows) == 2:
                t = time.perf_counter()
                scraped["metrics"] = http_get(port, "/metrics")[1]
                scraped["tracez"] = json.loads(http_get(port, "/tracez")[1])
                # the scrape is this check's, not the next window's
                sched._timer += time.perf_counter() - t

        Scheduler._display = displayed
        mlog.info = logged
        try:
            # the run's save is reached and writes nothing: no check
            # reads it
            with trainer_saves(lambda *a, **kw: None) as saved:
                tr = run_trainer(train_argv(
                    "obs.npz", OBS_TRAIN_UPDATES, "--disp-freq",
                    str(OBS_DISP), "--metrics-port", str(port), "--trace",
                    "--perf-accounting", "--profile", str(prof),
                    "--profile-start", "3", "--profile-updates", "2",
                    "--overwrite",
                    *(["--trace-sync-phases"] if sync else [])))
        finally:
            Scheduler._display = display
            mlog.info = info
        check(len(saved) == 1, f"the observability run's saves: {saved}")
        if tr.metrics_server is not None:
            tr.metrics_server.close()
        what = "with" if sync else "without"
        text = scraped.get("metrics", "")
        check(lint_metrics_text(text) == [], f"{what} sync: promlint "
              f"{lint_metrics_text(text)[:3]}")
        missing = [n for n in series if f"\n{n}" not in "\n" + text]
        check(not missing, f"{what} sync: /metrics lacks {missing}")
        names = {e["name"] for e in scraped["tracez"]["traceEvents"]}
        check({"train.data", "train.dispatch", "train.host"} <= names,
              f"{what} sync: /tracez spans {sorted(names)[:12]}")
        check(len(windows) == OBS_TRAIN_UPDATES // OBS_DISP
              and all("time" in w for w in windows), f"{what} sync: "
              f"display windows {windows}")
        for w in windows:
            check(abs(w["cspt"] * w["labels"] - w["time"])
                  <= 0.05 * w["time"], f"{what} sync: chip-seconds/token "
                  f"{w['cspt']:.4g} x {w['labels']:.0f} labels against the "
                  f"logged {w['time']} s")
        mfu = windows[-1]["mfu"]
        check(0.0 < mfu <= 1.0, f"{what} sync: marian_train_mfu {mfu}")
        traces = sorted(prof.glob("*.json"))
        check(len(traces) == 1, f"{what} sync: profiler traces {traces}")
        kernels = {e["name"] for e in json.loads(traces[0].read_text())
                   ["traceEvents"] if e.get("cat") == "kernel"}
        absent = [row for row, subs in TRACE_KERNELS.items()
                  if not any(sub in k for k in kernels for sub in subs)]
        check(not absent, f"{what} sync: the profiler trace lacks the "
              f"kernels of rows {absent}; its kernels of the port: "
              f"{sorted(k for k in kernels if 'packed' in k or 'fce' in k)}; "
              f"{len(kernels)} kernel names in all")
        # the whole run's shares start with the first update's one-time
        # costs (the first run's the process's first); the last window's
        # come from its train.* spans, clean of them and of the profiler
        last = {}
        for sp in obs.TRACER.snapshot()[0]:
            if sp.name.startswith("train.") and sp.start >= windows[-2]["at"]:
                last[sp.name[6:]] = last.get(sp.name[6:], 0.0) \
                    + sp.duration()
        phases = tr.step_phases
        total, last_total = sum(phases.values()), sum(last.values())
        # the window's seconds unrounded: the gauge x its labels
        runs[what] = (mfu, {k: v / total for k, v in phases.items()},
                      {k: v / last_total for k, v in last.items()},
                      1e3 * windows[-1]["cspt"] * windows[-1]["labels"]
                      / OBS_DISP)
        del tr
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: PER_UPDATE.get(k, 0) * 2 * OBS_TRAIN_UPDATES for k in counts}
    check(counts == want, f"train observability launches {counts}, "
          f"expected {want}")
    for what, (mfu, shares, last, ms) in runs.items():
        print(f"train observability: transformer-base 6+6, dim 512, vocab "
              f"{VOCAB}, f32, {what} --trace-sync-phases: marian_train_mfu "
              f"{mfu:.4f} (f32, 67 TFLOP/s peak, TF32 off); phase shares "
              f"of the run "
              + ", ".join(f"{k} {100 * v:.1f}%" for k, v in
                          sorted(shares.items()))
              + ", of the last window "
              + ", ".join(f"{k} {100 * v:.1f}%" for k, v in
                          sorted(last.items()))
              + f"; {ms:.2f} ms/update (the last window); {smi}")
    print(f"train observability: /metrics at the second display linted "
          f"clean with the trainer series, the phase gauge and the train "
          f"gauges; chip-seconds/token x labels within 5% of each window's "
          f"logged time; /tracez with train.data/dispatch/host; the "
          f"profiler trace names {', '.join(TRACE_KERNELS)}")
    obs_reset()
    return counts


def phase_recipe_train(seed: int, smi: str) -> dict:
    """Marian's standard recipe, ``--task transformer-base`` (RECIPE_FLAGS:
    the bundle's 6+6, dim 512, tied 32,000-word vocabulary, max-length
    100, --mini-batch-fit, dropout 0.1, label smoothing, the inverse-sqrt
    schedule and the EMA), in this process on a synthetic corpus of 1-99
    words a line. The fit searches under a memory fraction of
    RECIPE_HBM_GIB: every probe and its verdict, at least one out of
    memory, the card's allocated bytes back where they were (the
    parameters and optimizer state restored); then RECIPE_UPDATES updates
    with --mini-batch-warmup (each batch within the budget in force when
    its window was read, the budget ramping from a quarter to the whole),
    --mini-batch-track-lr (the lr's reference at the fitted budget) and
    --dynamic-gradient-scaling 2 log: every loss and gradient norm
    finite, ``gstat:n`` in the saved optimizer state equal to the update
    count. Counts the tiled packed backward (past 64 tokens) and the
    fused CE at its token counts."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.data.batch_generator import BatchGenerator
    from marian_tpu_torch.ops.kernels import packed_attention as pa
    from marian_tpu_torch.training import batch_fit
    from marian_tpu_torch.training.graph_group import GraphGroup
    from marian_tpu_torch.training.train import Train
    rng = np.random.RandomState(seed + 5)
    for side in ("src", "trg"):
        write_lines(f"recipe.{side}", rng.randint(1, 100, RECIPE_LINES), rng)
    for f in WORK.glob("recipe.npz*"):
        shutil.rmtree(f) if f.is_dir() else f.unlink()
    vocab = str(WORK / "vocab.yml")
    argv = [*RECIPE_FLAGS, "--train-sets", str(WORK / "recipe.src"),
            str(WORK / "recipe.trg"), "--vocabs", vocab, vocab, "--model",
            str(WORK / "recipe.npz")]
    probes, fit, windows, outs = [], {}, [], []
    try_budget, fit_words = batch_fit._try_budget, batch_fit.fit_mini_batch_words
    split, update = BatchGenerator._split_maxi, GraphGroup.update

    def probed(gg, words, max_len, vocab_size):
        t = time.perf_counter()
        ok = try_budget(gg, words, max_len, vocab_size)
        probes.append((words, ok, time.perf_counter() - t))
        return ok

    def allocated() -> int:
        """The card's allocated bytes without the cuBLAS workspaces, which
        a thread's first product allocates and keeps (the backward's
        thread makes its first in the fit when no training ran before)."""
        torch.cuda.synchronize()
        gc.collect()
        getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
        return torch.cuda.memory_allocated()

    def fitted(gg, opts, vocab_size, cap=None):
        fit["before"] = allocated()
        t = time.perf_counter()
        words = fit_words(gg, opts, vocab_size, cap)
        fit.update(after=allocated(), words=words,
                   seconds=time.perf_counter() - t, counts=read_counts(),
                   tiled=pa.packed_attention_bwd.launches_tiled)
        return words

    def windowed(bg, buf, state):
        batches = split(bg, buf, state)
        windows.append((float(bg.budget_scale()), len(batches)))
        return batches

    def recorded(gg, batches, step, *args, **kw):
        if "words" not in fit:          # a probe of the fit
            return update(gg, batches, step, *args, **kw)
        if not outs:
            torch.cuda.synchronize()
            fit["start"] = time.perf_counter()
        out = update(gg, batches, step, *args, **kw)
        trg = batches[0]["trg_ids"] if isinstance(batches, list) \
            else batches["trg_ids"]
        outs.append((tuple(trg.shape), out.loss_sum, out.labels,
                     out.grad_norm))
        if len(outs) == RECIPE_UPDATES:
            torch.cuda.synchronize()
            fit["end"] = time.perf_counter()
        return out

    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(
        min(1.0, RECIPE_HBM_GIB * 2**30 / total))
    batch_fit._try_budget, batch_fit.fit_mini_batch_words = probed, fitted
    BatchGenerator._split_maxi, GraphGroup.update = windowed, recorded
    reset_counts()
    pa.packed_attention_bwd.launches_tiled = 0
    try:
        tr = Train(parse_options(argv, mode="training"))
        check(tr.device.type == "cuda", f"trainer resolved {tr.device}")
        tr.run()
    finally:
        batch_fit._try_budget, batch_fit.fit_mini_batch_words = \
            try_budget, fit_words
        BatchGenerator._split_maxi, GraphGroup.update = split, update
        torch.cuda.set_per_process_memory_fraction(1.0)
    torch.cuda.synchronize()
    counts = read_counts()
    # the updates' launches: the run's less the fit's probes'
    trained = {k: v - fit["counts"][k] for k, v in counts.items()}
    tiled = pa.packed_attention_bwd.launches_tiled - fit["tiled"]
    opts = tr.options
    words = fit["words"]
    check(any(not ok for _, ok, _ in probes) and words > 0,
          f"the fit crossed no out-of-memory probe: {probes}")
    check(abs(fit["after"] - fit["before"]) <= RECIPE_MEM_SLACK,
          f"allocated {fit['before']} bytes before the fit, "
          f"{fit['after']} after; probes {probes}")
    check(int(opts.get("max-length")) == 100
          and int(opts.get("mini-batch-words")) == words
          and int(opts.get("mini-batch-words-ref")) == words
          and tr.graph_group.opt_cfg.ref_mb_words == words,
          f"the recipe's options: max-length {opts.get('max-length')}, "
          f"mini-batch-words {opts.get('mini-batch-words')}, "
          f"mini-batch-words-ref {opts.get('mini-batch-words-ref')}")
    check(len(outs) == RECIPE_UPDATES == tr.state.batches,
          f"{len(outs)} updates recorded, state at {tr.state.batches}")
    # each update's batch came from a window; its budget was the fitted
    # one times the window's scale
    budgets = [int(words * sc) for sc, n in windows for _ in range(n)]
    shapes = [o[0] for o in outs]
    check(all(r <= max(8, b // w // 8 * 8)
              for (r, w), b in zip(shapes, budgets)),
          f"batches {shapes} past their budgets {budgets[:len(shapes)]}")
    check(budgets[0] == int(words / RECIPE_WARMUP)
          and budgets[:RECIPE_UPDATES] == sorted(budgets[:RECIPE_UPDATES])
          and words in budgets[:RECIPE_UPDATES],
          f"the budgets of updates 1-{RECIPE_UPDATES} {budgets} do not ramp "
          f"from a quarter of {words} to it")
    losses = np.array([float(o[1]) / float(o[2]) for o in outs])
    norms = np.array([float(o[3]) for o in outs])
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"losses {losses}, gradient norms {norms}")
    with np.load(str(WORK / "recipe.npz.optimizer.npz")) as z:
        gstat = (float(z["gstat:n"]), float(z["gstat:avg"]), float(z["t"]))
    check(gstat[0] == RECIPE_UPDATES == gstat[2] and np.isfinite(gstat[1]),
          f"gstat:n {gstat[0]}, gstat:avg {gstat[1]}, t {gstat[2]}")
    want = {k: PER_UPDATE.get(k, 0) * RECIPE_UPDATES for k in counts}
    check(trained == want, f"the recipe's updates launched {trained}, "
          f"expected {want}")
    tokens = [r * w for r, w in shapes]
    check(tiled > 0 and max(tokens) > 16384, f"tiled backward launches "
          f"{tiled}, fused CE tokens {tokens}")
    ms = 1e3 * (fit["end"] - fit["start"]) / RECIPE_UPDATES
    print("recipe train: --task transformer-base (6+6, dim 512, vocab "
          f"{VOCAB}, f32, max-length 100): the fit under "
          f"{RECIPE_HBM_GIB} GiB of the card's memory: probes "
          + ", ".join(f"{w} {'fits' if ok else 'OOM'} ({s:.2f} s)"
                      for w, ok, s in probes)
          + f"; fitted mini-batch-words={words} in {fit['seconds']:.2f} s; "
          f"allocated {fit['before']} bytes before the search, "
          f"{fit['after']} after; the probes' launches "
          f"{ {k: v for k, v in fit['counts'].items() if v} }, "
          f"{fit['tiled']} of them the tiled packed backward")
    print(f"recipe train: {RECIPE_UPDATES} updates, "
          f"--mini-batch-warmup {RECIPE_WARMUP} (budgets "
          f"{budgets[:RECIPE_UPDATES]}; windows read at scales "
          f"{[sc for sc, _ in windows]}), rows x width "
          + ", ".join(f"{r}x{w}" for r, w in shapes)
          + f"; mean CE {', '.join(f'{x:.4f}' for x in losses)}; gradient "
          f"norms {', '.join(f'{x:.4f}' for x in norms)}; gstat:n "
          f"{gstat[0]:.0f}, gstat:avg {gstat[1]:.4f}; {ms:.2f} ms/update; "
          f"the updates' launches "
          f"{ {k: v for k, v in trained.items() if v} }, of them {tiled} of "
          f"the tiled packed backward (past 64 tokens) and "
          f"{trained['fused_ce_fwd']} of the fused CE forward at "
          f"{min(tokens)}-{max(tokens)} tokens; {smi}")
    return counts


# -- the rest of the training slice ------------------------------------------

def write_extras_data(seed: int, vectors: bool = True) -> None:
    """The side files of the train extras phase beside the training
    corpus (``write_corpus``): ``train.tsv``, the corpus as one
    tab-separated file; ``train.align``, each target word aligned to a
    random source word with probability 0.8 (Pharaoh format);
    ``train.weights``, a word weight for each target token and its EOS
    from {1, 0.5, -0.5, -1}; and with ``vectors``, ``src.vec`` and
    ``trg.vec``, word2vec text vectors (with the 'n dim' header) of the
    vocabulary's first EXTRAS_VEC_WORDS words."""
    rng = np.random.RandomState(seed + 9)
    src = (WORK / "train.src").read_text().splitlines()
    trg = (WORK / "train.trg").read_text().splitlines()
    (WORK / "train.tsv").write_text(
        "".join(f"{a}\t{b}\n" for a, b in zip(src, trg)))
    align, weights = [], []
    for a, b in zip(src, trg):
        n, m = len(a.split()), len(b.split())
        pts = rng.randint(0, n, m)
        keep = rng.rand(m) < 0.8
        align.append(" ".join(f"{s}-{t}" for t, s in enumerate(pts)
                              if keep[t]))
        weights.append(" ".join(
            str(w) for w in rng.choice([1.0, 0.5, -0.5, -1.0], m + 1)))
    (WORK / "train.align").write_text("\n".join(align) + "\n")
    (WORK / "train.weights").write_text("\n".join(weights) + "\n")
    if not vectors:
        return
    dim = int(BASE["dim-emb"])
    for name in ("src.vec", "trg.vec"):
        vecs = rng.randn(EXTRAS_VEC_WORDS, dim).astype(np.float32) * 0.05
        (WORK / name).write_text(
            f"{EXTRAS_VEC_WORDS} {dim}\n" + "".join(
                f"w{i + 2} " + " ".join(f"{x:.6f}" for x in row) + "\n"
                for i, row in enumerate(vecs)))


def extras_cut_flags(name: str) -> tuple:
    """The flags of a card-vs-CPU cut of the train extras phase, on the
    base cut's flags (``base_parity_setup``), with this process's WORK."""
    return {"guided": ("--guided-alignment", str(WORK / "train.align"),
                       "--gradient-checkpointing", "--output-omit-bias",
                       "--transformer-depth-scaling"),
            "compress": ("--quantize-bits", "8",
                         "--gradient-dropping-rate", "0.9"),
            "unlikelihood": ("--unlikelihood-loss", "--data-weighting",
                             str(WORK / "train.weights"),
                             "--data-weighting-type", "word")}[name]


EXTRAS_CUTS = ("guided", "compress", "unlikelihood")


def extras_run(what: str, model: str, *extra: str, loaded=None) -> tuple:
    """marian_train.main (the command line's entry point) on the training
    corpus at the base width for EXTRAS_UPDATES updates with ``extra``
    flags, its one save the model file only (``model_only_save``), every
    launch count set to 0 just before and read just after. Returns
    (counts, the updates' outputs, seconds). ``loaded``: a dict that
    gets the embedding tables as the trainer loaded them."""
    from marian_tpu_torch.cli import marian_train
    from marian_tpu_torch.training import train as train_mod
    from marian_tpu_torch.training.graph_group import GraphGroup
    for f in WORK.glob(f"{model}*"):
        shutil.rmtree(f) if f.is_dir() else f.unlink()
    outs = []
    update, load = GraphGroup.update, train_mod.load_embedding_vectors

    def recorded(gg, batches, step, *args, **kw):
        out = update(gg, batches, step, *args, **kw)
        outs.append(out)
        return out

    def loading(opts, params, vocabs):
        load(opts, params, vocabs)
        if loaded is not None:
            loaded.update({k: v.clone() for k, v in params.items()
                           if k.endswith("Wemb")})
    argv = train_argv(model, EXTRAS_UPDATES, "--overwrite", *extra)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    GraphGroup.update = recorded
    train_mod.load_embedding_vectors = loading
    try:
        with trainer_saves(model_only_save) as written:
            marian_train.main(argv)
    finally:
        GraphGroup.update = update
        train_mod.load_embedding_vectors = load
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check(len(outs) == EXTRAS_UPDATES and len(written) == 1,
          f"{what}: {len(outs)} updates, saves {written}")
    costs = np.array([float(o.loss_sum) / float(o.labels) for o in outs])
    check(bool(np.isfinite(costs).all()), f"{what}: costs {costs}")
    return counts, outs, secs


def mean_ces(outs) -> str:
    return ", ".join(f"{float(o.loss_sum) / float(o.labels):.4f}"
                     for o in outs)


def phase_train_extras(seed: int, smi: str, cpu: dict) -> dict:
    """The rest of the training slice on the card:

    - run A, ``marian_train`` at the base width (6+6, untied) from the
      corpus's TSV copy with --guided-alignment, --gradient-checkpointing,
      --output-omit-bias, --transformer-depth-scaling and
      --embedding-vectors src.vec trg.vec with --embedding-fix-src, f32,
      dropout 0.1: finite costs and guided costs; the saved source table
      byte-equal to the table as loaded, its vector rows the file's;
      no output bias in the saved model; the launches of every update:
      the packed forward 12 for the encoder (6 layers, each recomputed),
      11 for the decoder's self-attention and 10 for its cross-attention
      (the last layer, guided alignment's, neither recomputed nor, for
      its cross-attention, on the kernel), the packed backward 17, the
      fused CE 1 each; the saved model decodes on the card;
    - run B, the tied base model with --right-left, --quantize-bits 8 and
      --gradient-dropping-rate 0.9: at most 255 values in each quantized
      matrix of the saved model (biases and norms are not quantized);
      the checkpoint decodes on the card to the CPU's n-best tokens;
    - the 2+2 base cut on the card against the CPU (the child process's
      run in ``cpu``; a cut it lacks runs on the CPU here) within the
      unchanged PARITY_LIMITS, for guided alignment with
      checkpointing, omit-bias and depth scaling; for compression; and
      for the unlikelihood loss on word weights of both signs, with no
      fused CE launch (the dense logits, as the reference);
    - --gradient-checkpointing at the base width: one gradient pass at
      dropout 0.1 with and without, the loss and every gradient
      bit-identical and the dropout generator left in one state; then
      EXTRAS_AB_UPDATES updates each way on the same batch: the
      parameters after them bit-identical, the peak memory, ms/update and
      the packed forward's launches (those without plus
      EXTRAS_RECOMPUTED an update) printed beside ``smi``.

    Returns the launch counts of runs A and B, the phase's main path."""
    from marian_tpu_torch.common import io as mio
    write_extras_data(seed)
    vocab = str(WORK / "vocab.yml")
    untied = ("--tied-embeddings-all", "false")
    loaded = {}
    a_counts, a_outs, a_secs = extras_run(
        "run A", "extras_a.npz", *untied, "--tsv", "--train-sets",
        str(WORK / "train.tsv"), "--vocabs", vocab, vocab,
        "--guided-alignment", str(WORK / "train.align"),
        "--gradient-checkpointing", "--output-omit-bias",
        "--transformer-depth-scaling", "--embedding-vectors",
        str(WORK / "src.vec"), str(WORK / "trg.vec"), "--embedding-fix-src",
        loaded=loaded)
    guided = np.array([float(o.guided) for o in a_outs])
    check(bool(np.isfinite(guided).all() and (guided > 0).all()),
          f"run A: guided costs {guided}")
    params, _ = mio.load_model(str(WORK / "extras_a.npz"))
    check("decoder_ff_logit_out_b" not in params
          and "decoder_ff_logit_out_W" in params,
          f"run A: output layer keys "
          f"{sorted(k for k in params if 'logit' in k)}")
    start = loaded["encoder_Wemb"].numpy()
    file_rows = np.array([l.split()[1:] for l in (WORK / "src.vec")
                          .read_text().splitlines()[1:]], np.float32)
    check(np.array_equal(params["encoder_Wemb"], start)
          and np.array_equal(start[2:2 + EXTRAS_VEC_WORDS], file_rows)
          and not np.array_equal(params["decoder_Wemb"],
                                 loaded["decoder_Wemb"].numpy()),
          "run A: the fixed source table moved, or was not the vectors "
          "loaded, or the target table did not train")
    per_update = {"packed_attention": 33, "packed_attention_bwd": 17,
                  "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
    want = {k: per_update.get(k, 0) * EXTRAS_UPDATES for k in a_counts}
    check(a_counts == want, f"run A launches {a_counts}, expected {want}")
    src = (WORK / "train.src").read_text().splitlines()[:4]
    tr, hyps, _, dec_counts = decode_run("extras_a.npz", src)
    check(dec_counts["decode_attention"] > 0
          and dec_counts["packed_attention"] > 0,
          f"run A's model decode launches {dec_counts}")
    print(f"train extras: run A (6+6 base width, untied, f32, dropout 0.1, "
          f"--tsv, --guided-alignment, --gradient-checkpointing, "
          f"--output-omit-bias, --transformer-depth-scaling, "
          f"--embedding-vectors with --embedding-fix-src): "
          f"{EXTRAS_UPDATES} updates and one save in {a_secs:.2f} s; mean "
          f"CE {mean_ces(a_outs)}; "
          f"guided cost {', '.join(f'{g:.4f}' for g in guided)}; source "
          f"table byte-equal to the {EXTRAS_VEC_WORDS} loaded vectors and "
          f"the init; no output bias; launches "
          f"{ {k: v for k, v in a_counts.items() if v} }; decoded "
          f"{len(src)} sentences on the card, {len(hyps)} hypotheses")

    b_counts, b_outs, b_secs = extras_run(
        "run B", "extras_b.npz", "--right-left", "--quantize-bits", "8",
        "--gradient-dropping-rate", "0.9")
    params, _ = mio.load_model(str(WORK / "extras_b.npz"))
    levels = {k: len(np.unique(v)) for k, v in params.items()
              if v.ndim >= 2 and v.shape[0] > 1}
    check(levels and max(levels.values()) <= 255,
          f"run B: distinct values {levels}")
    want = {k: PER_UPDATE.get(k, 0) * EXTRAS_UPDATES for k in b_counts}
    check(b_counts == want, f"run B launches {b_counts}, expected {want}")
    decode_card_vs_cpu("run B's checkpoint (--right-left, 8-bit)",
                       "extras_b.npz", src[:2])
    print(f"train extras: run B (6+6 base width, tied, --right-left, "
          f"--quantize-bits 8, --gradient-dropping-rate 0.9): "
          f"{EXTRAS_UPDATES} updates and one save in {b_secs:.2f} s; mean "
          f"CE {mean_ces(b_outs)}; "
          f"distinct values a quantized matrix {min(levels.values())}-"
          f"{max(levels.values())} over {len(levels)} matrices; launches "
          f"{ {k: v for k, v in b_counts.items() if v} }")

    for name in EXTRAS_CUTS:
        flags = " ".join(Path(f).name for f in extras_cut_flags(name))
        reset_counts()
        train_card_vs_cpu(f"2+2 cut of transformer-base, {flags}",
                          base_parity_setup(*extras_cut_flags(name)),
                          PARITY_LIMITS, cpu.get(f"extras_{name}"))
        counts = read_counts()
        fce = sum(v for k, v in counts.items() if k.startswith("fused_ce"))
        check(counts["packed_attention"] > 0
              and (fce == 0) == (name == "unlikelihood"),
              f"card vs cpu, {name}: launches {counts}")
    checkpointing_ab(smi)
    return {k: a_counts[k] + b_counts[k] for k in a_counts}


def checkpointing_ab(smi: str) -> None:
    """--gradient-checkpointing against none at the base width on one
    batch of the training corpus (TRAIN_FLAGS: dropout 0.1): see
    ``phase_train_extras``."""
    from marian_tpu_torch.common.config_parser import parse_options
    from marian_tpu_torch.data.batch_generator import BatchGenerator
    from marian_tpu_torch.data.corpus import Corpus
    from marian_tpu_torch.data.vocab import create_vocab
    from marian_tpu_torch.models import transformer as T
    from marian_tpu_torch.models.encoder_decoder import (batch_to_arrays,
                                                         create_model)
    from marian_tpu_torch.training.graph_group import (GraphGroup,
                                                       dropout_seed)
    dev = torch.device("cuda")
    argv = train_argv("extras_ab.npz", 1)
    opts = {"off": parse_options(argv, mode="training"),
            "on": parse_options(argv + ["--gradient-checkpointing"],
                                mode="training")}
    vocab = create_vocab(str(WORK / "vocab.yml"))
    batch = next(iter(BatchGenerator(Corpus(
        [str(WORK / "train.src"), str(WORK / "train.trg")], [vocab, vocab],
        opts["off"]), opts["off"])))
    arrays = batch_to_arrays(batch, dev)
    init = None

    def graph_group(o):
        nonlocal init
        gg = GraphGroup(create_model(o, len(vocab), len(vocab)), o, dev)
        if init is None:
            init = T.init_params(gg.model.cfg, 5)
        gg.initialize(init)
        return gg
    ref = {}
    for name in ("off", "on"):
        gg = graph_group(opts[name])
        names = list(gg.params)
        gen = torch.Generator(device=dev)
        gen.manual_seed(dropout_seed(1111, 1))
        total, _ = gg.model.loss(gg.params, arrays, gen, train=True)
        grads = torch.autograd.grad(total, [gg.params[k] for k in names])
        if name == "off":
            ref = {"loss": total.detach(), "gen": gen.get_state(),
                   "grads": dict(zip(names, (g.detach() for g in grads)))}
        else:
            same = [k for k, g in zip(names, grads)
                    if torch.equal(g, ref["grads"][k])]
            check(torch.equal(total.detach(), ref["loss"])
                  and torch.equal(gen.get_state(), ref["gen"])
                  and len(same) == len(names),
                  f"checkpointing A/B: loss {float(total.detach())} against "
                  f"{float(ref['loss'])}; gradients bit-identical for "
                  f"{len(same)} of {len(names)} leaves")
        del gg, grads, total
    ref.clear()
    torch.cuda.empty_cache()
    res = {}
    for name in ("off", "on"):
        gg = graph_group(opts[name])
        gen = torch.Generator(device=dev)
        gg.update(arrays, 1, gen, 1111)             # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for step in range(2, EXTRAS_AB_UPDATES + 2):
            gg.update(arrays, step, gen, 1111)
        torch.cuda.synchronize()
        res[name] = {"ms": 1e3 * (time.perf_counter() - t0)
                     / EXTRAS_AB_UPDATES,
                     "peak": torch.cuda.max_memory_allocated() / 2**30,
                     "counts": read_counts(),
                     "params": {k: v.detach().clone()
                                for k, v in gg.params.items()}}
        del gg
        torch.cuda.empty_cache()
    on, off = res["on"], res["off"]
    check(all(torch.equal(on["params"][k], off["params"][k])
              for k in off["params"]),
          "checkpointing A/B: parameters differ after the updates")
    fwd = {k: res[k]["counts"]["packed_attention"] for k in res}
    want = {**off["counts"], "packed_attention": fwd["off"]
            + EXTRAS_RECOMPUTED * EXTRAS_AB_UPDATES}
    check(fwd["off"] == PER_UPDATE["packed_attention"] * EXTRAS_AB_UPDATES
          and on["counts"] == want,
          f"checkpointing A/B launches: without {off['counts']}, with "
          f"{on['counts']}")
    rows, width = batch.trg.ids.shape
    print(f"train extras: --gradient-checkpointing A/B at the base width "
          f"(6+6, f32, dropout 0.1, one batch of {rows} x {width} target "
          f"tokens): loss and all {len(on['params'])} gradients "
          f"bit-identical, parameters bit-identical after "
          f"{EXTRAS_AB_UPDATES} updates; without: {off['ms']:.2f} "
          f"ms/update, peak {off['peak']:.2f} GiB, packed forward "
          f"{fwd['off']} launches; with: {on['ms']:.2f} ms/update "
          f"({on['ms'] / off['ms']:.3f}x), peak {on['peak']:.2f} GiB "
          f"({on['peak'] / off['peak']:.3f}x), packed forward {fwd['on']} "
          f"launches ({fwd['off']} + {EXTRAS_RECOMPUTED} x "
          f"{EXTRAS_AB_UPDATES}); {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--cpu-references", action="store_true",
                    help=argparse.SUPPRESS)     # the child process
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.cpu_references:
        cpu_references(args.seed)
        return 0
    from marian_tpu_torch.device import resolve_device
    resolve_device("cuda")                           # TF32 off, card present
    smi = phase_card()
    child = start_cpu_references(args.seed)
    try:
        return run_phases(args, smi, child)
    finally:
        for proc in (child, *STARTED):
            stop(proc)


class WriteMeter:
    """Bytes written by this process and every process it started, for
    the phase lines. Two counts from /proc/<pid>/io: ``wchar``, the
    bytes passed to write calls, and ``write_bytes``, what reached the
    block layer (counted when a page is dirtied). A kernel without
    block-layer accounting (an application kernel may read 0 for
    write_bytes) leaves only the first. A thread samples the
    descendants' counts every ``interval`` seconds, keyed by pid and
    start time, so a process's count is its last sample before it
    ended. Where the kernel folds a reaped child's counts into its
    parent's (Linux does, at the wait: tested once at start), only the
    live descendants are added to this process's own counts; where it
    does not, every descendant ever seen is."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.seen = {}          # (pid, start time) -> (wchar, write_bytes)
        self.lock = threading.Lock()
        before = self._io("self")[0]
        subprocess.run([sys.executable, "-c",
                        "import os; os.write(1, bytes(1 << 20))"],
                       stdout=subprocess.DEVNULL, check=True)
        self.folds = self._io("self")[0] - before >= 1 << 20
        threading.Thread(target=self._run, daemon=True,
                         name="write-meter").start()

    @staticmethod
    def _io(pid) -> tuple:
        with open(f"/proc/{pid}/io") as fh:
            f = dict(line.split(": ") for line in fh.read().splitlines())
        return int(f["wchar"]), int(f["write_bytes"])

    @staticmethod
    def _descendants():
        parent = {}
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            try:
                with open(f"/proc/{name}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            parent[(int(name), fields[19])] = int(fields[1])
        pids, out = {os.getpid()}, set()
        grew = True
        while grew:
            grew = False
            for key, ppid in parent.items():
                if ppid in pids and key[0] not in pids:
                    pids.add(key[0])
                    out.add(key)
                    grew = True
        return out

    def sample(self) -> None:
        alive = {}
        for key in self._descendants():
            try:
                alive[key] = self._io(key[0])
            except (OSError, KeyError, ValueError):
                continue
        with self.lock:
            if self.folds:
                self.seen = alive
            else:
                self.seen.update(alive)

    def _run(self) -> None:
        while True:
            time.sleep(self.interval)
            self.sample()

    def read(self) -> tuple:
        """(wchar, write_bytes) of this process and its descendants."""
        self.sample()
        wchar, blocks = self._io("self")
        with self.lock:
            wchar += sum(w for w, _ in self.seen.values())
            blocks += sum(b for _, b in self.seen.values())
        return wchar, blocks


def gib_written(meter: WriteMeter, since: tuple) -> str:
    wchar, blocks = meter.read()
    return (f"{(wchar - since[0]) / 2**30:.3f} GiB written "
            f"({(blocks - since[1]) / 2**30:.3f} GiB to storage)")


def run_phases(args, smi: str, child) -> int:
    t0 = time.perf_counter()
    meter = WriteMeter()
    w0 = meter.read()

    def timed(name, fn, *args):
        t, w = time.perf_counter(), meter.read()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s "
              f"({time.perf_counter() - t0:.1f} s in all), "
              f"{gib_written(meter, w)}")
        return out
    timed("build", phase_build)
    gen = torch.Generator().manual_seed(args.seed)
    packed = timed("packed kernel", phase_packed_kernel, gen)
    packed_bwd, packed_fwd_err = timed("packed backward kernel",
                                       phase_packed_bwd_kernel, gen)
    packed["max_abs_err"] = max(packed["max_abs_err"], packed_fwd_err)
    kernels = [timed("decode kernel", phase_decode_kernel, gen), packed,
               packed_bwd,
               *timed("fused_ce kernels", phase_fused_ce_kernels, gen),
               *timed("fused_ce bf16 kernels", phase_fused_ce_kernels_bf16,
                      gen),
               *timed("flash kernels", phase_flash_kernels, gen),
               *timed("paged kernel", phase_paged_kernel, gen),
               *timed("attention bf16 kernels",
                      phase_attention_kernels_bf16, gen)]
    torch.cuda.empty_cache()
    # the child's CPU work may overlap the kernel phases, whose times are
    # the card's own (CUDA events behind a device sleep), but none of the
    # main paths, whose host-bound times it would slow
    cpu_ref = timed("cpu references (the wait for the child)",
                    collect_cpu_references, child)
    lines = timed("models", write_model, args.seed)
    paths = {"decode": timed("decode main path", phase_main_path, lines)}
    timed("decode card vs cpu", phase_card_vs_cpu, lines)
    paths["serve"] = timed("serve main path", phase_serve_main_path,
                           args.seed)
    timed("serve card vs cpu", phase_serve_card_vs_cpu, args.seed)
    paths["request serve"] = timed("request serve main path",
                                   phase_request_serve_main_path, args.seed)
    paths["beam serve"] = timed("beam serve main path",
                                phase_beam_serve_main_path, args.seed)
    paths["fused beam serve"] = timed("fused beam serve main path",
                                      phase_fused_beam_serve_main_path,
                                      args.seed)
    paths["fused beam pressure"] = timed("fused beam pressure",
                                         phase_fused_pressure, args.seed)
    timed("beam serve card vs cpu", phase_beam_serve_card_vs_cpu, args.seed)
    timed("fused beam serve card vs cpu",
          lambda: phase_beam_serve_card_vs_cpu(
              args.seed, "--iteration-steps", str(FUSED_STEPS), merge=None,
              what="fused beam serve"))
    paths["prefix serve"] = timed("prefix serve main path",
                                  phase_prefix_serve_main_path, args.seed)
    paths["decode surface"] = timed("decode surface", phase_decode_surface,
                                    args.seed)
    timed("watchdog serve", phase_watchdog_serve, args.seed)
    paths["observability serve"] = timed(
        "observability serve", phase_observability_serve, args.seed, smi)
    paths["brownout serve"] = timed("brownout serve", phase_brownout_serve,
                                    args.seed, smi)
    paths["fleet serve"] = timed("fleet serve", phase_fleet_serve, args.seed,
                                 smi)
    paths["pool drills"] = timed("pool drills", phase_pool_drills,
                                 args.seed, smi)
    paths["train"] = timed("train main path", phase_train_main_path,
                           args.seed)
    paths["train obs"] = timed("train observability", phase_train_obs,
                               args.seed, smi)
    paths["recipe train"] = timed("recipe train", phase_recipe_train,
                                  args.seed, smi)
    timed("bundles", phase_train_bundles)
    paths["lifecycle serve"] = timed("lifecycle serve main path",
                                     phase_lifecycle_serve, args.seed)
    paths["lifecycle iteration"] = timed("lifecycle iteration main path",
                                         phase_lifecycle_iteration, args.seed)
    timed("train card vs cpu", phase_train_card_vs_cpu)
    paths["train extras"] = timed("train extras", phase_train_extras,
                                  args.seed, smi, cpu_ref)
    paths["delay train"] = timed("delay train main path",
                                 phase_delay_train_main_path, args.seed)
    timed("delay card vs cpu", phase_delay_card_vs_cpu, cpu_ref)
    paths["doc train"] = timed("doc train main path",
                               phase_doc_train_main_path, args.seed)
    paths["doc decode"] = timed("doc decode main path",
                                phase_doc_decode_main_path)
    # the chaos phase's processes run beside the doc card-vs-CPU phase,
    # whose readings are no timing
    chaos = timed("chaos harness: its processes started", start_chaos_runs)
    timed("doc card vs cpu", phase_doc_card_vs_cpu, args.seed)
    paths["crash resume"] = timed("chaos harness", phase_chaos_harness,
                                  chaos, smi)
    paths["bf16 train"] = timed("bf16 train main path",
                                phase_bf16_train_main_path)
    paths["bf16 decode"] = timed("bf16 decode main path",
                                 phase_bf16_decode_main_path, lines)
    paths["bf16 doc cut"] = timed("bf16 card vs cpu", phase_bf16_card_vs_cpu,
                                  lines, args.seed, cpu_ref)
    paths["bf16 decode surface"] = timed("bf16 decode surface",
                                         phase_bf16_decode_surface, lines,
                                         cpu_ref)
    bf16_serve = dict(n=SERVE_BF16, encoder="packed_attention_bf16_tc")
    paths["bf16 request serve"] = timed(
        "bf16 request serve main path", lambda: phase_request_serve_main_path(
            args.seed, *BF16_FLAGS, what="bf16 request serve", **bf16_serve))
    paths["bf16 beam serve"] = timed(
        "bf16 beam serve main path", lambda: phase_beam_serve_main_path(
            args.seed, *BF16_FLAGS, what="bf16 beam serve", **bf16_serve))
    paths["bf16 fused beam serve"] = timed(
        "bf16 fused beam serve main path", lambda: beam_serve_run(
            "bf16 fused beam serve", args.seed,
            serve_sentences(args.seed, SERVE_BF16),
            beam_serve_options(*BF16_FLAGS, "--iteration-steps",
                               str(FUSED_STEPS), merge=None),
            bf16_serve["encoder"], guard=True))
    check(set(paths) == set(F32_PATHS + BF16_PATHS), f"paths {set(paths)}")
    for k in kernels:
        k["launches"] = sum(paths[p][k.get("counter", k["name"])]
                            for p in k.get("paths", paths))
    # every counter is a row's, but the CUDA-core bf16 fused CE's: it
    # takes the bf16 shapes no main path gives (E % 8 != 0, unaligned
    # operands)
    cuda_cores = ("fused_ce_fwd_bf16", "fused_ce_dx_bf16", "fused_ce_dw_bf16")
    counted = {k.get("counter", k["name"]) for k in kernels}
    check(counted | set(cuda_cores) == set(kernel_counters())
          and all(k["launches"] > 0 for k in kernels),
          "a kernel was not launched on its main path")
    print("kernels: " + "; ".join(
        f"{k['name']} launches {k['launches']} pass" for k in kernels)
        + f"; {', '.join(cuda_cores)} on the CUDA cores: "
        + ", ".join(str(sum(c[name] for c in paths.values()))
                    for name in cuda_cores)
        + " launches on the main paths (their shapes: E % 8 != 0 or "
          "unaligned operands)")
    print(f"phases: {time.perf_counter() - t0:.1f} s, "
          f"{gib_written(meter, w0)} in all")
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_ms_f32_peak")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
