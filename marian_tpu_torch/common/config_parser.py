"""Marian-compatible configuration surface for the port's decoder,
server and trainer: YAML config files + CLI overrides.

Three modes, as in ``marian_tpu/common/config_parser.py``:
``translation`` (the decoder's flags), ``server`` (those plus the
server's) and ``training`` (the trainer's), each with the
model flags a checkpoint's ``special:model.yml`` carries, under the same
names and defaults as the reference, the serving lifecycle's, the
metrics port's and the observability plane's (tracing, the flight
recorder, the perf plane, SLOs), the brownout ladder's and fleet
serving's among them. The trainer has its side of the plane
(``--metrics-port``, ``--trace``, ``--trace-ring``, ``--trace-dump``,
``--perf-accounting``, ``--trace-sync-phases``, ``--tensorboard``) and
the profiler window (``--profile``, ``--profile-start``,
``--profile-updates``, on ``torch.profiler``); ``--profile-server``
parses and the trainer refuses it (the live ``jax.profiler`` server has
no ``torch.profiler`` counterpart). The flags of the JAX package's
compile cache and of its mesh machinery are left out.
Precedence as
in Marian: defaults < config file(s) < the ``--task`` bundle
(``common/aliases.py``) < CLI flags. ``--cpu-threads N`` (N > 0) runs on
the CPU.

A flag that parses but whose feature this slice does not carry yet is
refused at startup (``translator.translator``, ``server.server``,
``training.train``) rather than ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence

import yaml

from . import logging as log
from .aliases import expand_aliases
from .config_validator import validate_options
from .options import Options

F = dataclasses.make_dataclass(
    "F", ["name", "type", "default", "help", "nargs"])


def _f(name, type_, default, help_, nargs=None):
    return F(name, type_, default, help_, nargs)


_COMMON = [
    _f("config", str, None, "Paths to YAML config file(s); later files override earlier", "+"),
    _f("workspace", int, -1, "Device workspace hint in MB (kept for CLI compat)"),
    _f("log", str, None, "Log to file in addition to stderr"),
    _f("log-level", str, "info", "trace/debug/info/warn/error/critical/off"),
    _f("quiet", bool, False, "Suppress all logging to stderr"),
    _f("quiet-translation", bool, False, "Suppress logging for translation"),
    _f("seed", int, 0, "RNG seed; 0 means use wall-clock"),
    _f("dump-config", str, None, "Dump effective config and exit: full/minimal"),
    _f("version", bool, False, "Print version and exit"),
]

_MODEL = [
    _f("model", str, "model.npz", "Path prefix for model to be saved/resumed"),
    _f("ignore-model-config", bool, False, "Ignore the config embedded in the model file"),
    _f("type", str, "amun", "Model type (this slice decodes: transformer)"),
    _f("dim-vocabs", int, [0, 0], "Maximum vocabulary sizes (0 = from vocab file)", "+"),
    _f("dim-emb", int, 512, "Embedding vector size"),
    _f("dim-rnn", int, 1024, "RNN state size (a model-geometry key of the checkpoint's config; the transformer does not read it)"),
    _f("enc-depth", int, 1, "Encoder layers"),
    _f("dec-depth", int, 1, "Decoder layers"),
    _f("right-left", bool, False, "Train right-to-left model"),
    _f("tied-embeddings", bool, False, "Tie target embeddings and output layer"),
    _f("tied-embeddings-src", bool, False, "Tie source and target embeddings"),
    _f("tied-embeddings-all", bool, False, "Tie all embeddings and output layer"),
    _f("output-omit-bias", bool, False, "Output (logits) projection without a bias term"),
    _f("transformer-heads", int, 8, "Number of attention heads"),
    _f("transformer-dim-ffn", int, 2048, "FFN hidden size"),
    _f("transformer-decoder-dim-ffn", int, 0, "Decoder FFN hidden size (0 = transformer-dim-ffn)"),
    _f("transformer-ffn-depth", int, 2, "FFN depth (number of linear layers)"),
    _f("transformer-decoder-ffn-depth", int, 0, "Decoder FFN depth (0 = transformer-ffn-depth)"),
    _f("transformer-ffn-activation", str, "swish", "relu, swish, gelu"),
    _f("transformer-no-projection", bool, False, "Omit output projection in MHA"),
    _f("transformer-decoder-autoreg", str, "self-attention", "self-attention (this slice)"),
    _f("transformer-flash-attention", str, "auto", "Long-sequence (flash) attention kernel, CUDA on the card, its plain version on the CPU: auto (at length >= 1024), on, off"),
    _f("attention-kernel", str, "auto", "Attention impl: auto, dense, flash (alias of --transformer-flash-attention auto, off, on)"),
    _f("transformer-packed-attention", str, "auto", "Short-sequence attention kernel (CUDA): auto (on the card), on, off"),
    _f("transformer-fused-decode-attention", str, "auto", "Fused beam-gather + cache-update + attention decode step (CUDA): auto, on, off"),
    _f("transformer-tied-layers", int, [], "Tie decoder layers to these encoder layers", "*"),
    _f("transformer-preprocess", str, "", "Per-sublayer preprocess ops: d=dropout, a=add(residual), n=layernorm"),
    _f("transformer-postprocess", str, "dan", "Per-sublayer postprocess ops"),
    _f("transformer-postprocess-emb", str, "d", "Embedding postprocess ops"),
    _f("transformer-postprocess-top", str, "", "Final decoder-top postprocess ops"),
    _f("transformer-train-position-embeddings", bool, False, "Learned positional embeddings"),
    _f("transformer-depth-scaling", bool, False, "Depth-scaled parameter initialization"),
    _f("transformer-guided-alignment-layer", str, "last", "Decoder layer for guided alignment"),
    _f("max-length", int, 50, "Maximum sentence length (decode cap)"),
    _f("precision", str, ["float32", "float32"], "Precisions: compute, optimizer accumulation (float16 is mapped to bfloat16; the second is accepted and not acted on)", "+"),
    _f("fp16", bool, False, "Half-precision shortcut: --precision bfloat16 float32 unless --precision is given (fp16's narrow exponent needs loss scaling; bf16 keeps the f32 range)"),
]

_TRANSLATION = [
    _f("vocabs", str, [], "Paths to vocabulary files", "*"),
    _f("mini-batch", int, 1, "Minibatch size (sentences)"),
    _f("mini-batch-words", int, 0, "Minibatch size in words"),
    _f("maxi-batch", int, 1, "Number of minibatches to preload and sort"),
    _f("maxi-batch-sort", str, "src", "Sorting within maxi-batch: src, none"),
    _f("data-threads", int, 8, "Host threads for data pipeline"),
    _f("input", str, ["stdin"], "Input file(s) or stdin", "+"),
    _f("output", str, "stdout", "Output file or stdout"),
    _f("models", str, [], "Model file(s) to ensemble", "*"),
    _f("weights", float, [], "Ensemble scorer weights", "*"),
    _f("beam-size", int, 12, "Beam size"),
    _f("normalize", float, 0.0, "Divide score by length^alpha", "?"),
    _f("word-penalty", float, 0.0, "Subtract penalty*length from score"),
    _f("allow-unk", bool, False, "Allow <unk> in output"),
    _f("allow-special", bool, False, "Allow special symbols in output"),
    _f("n-best", bool, False, "Produce n-best lists"),
    _f("word-scores", bool, False, "Print per-word scores in n-best lists"),
    _f("n-best-feature", str, "Score", "Feature name for the n-best score column"),
    _f("alignment", str, None, "Return word alignments: 0.x threshold, soft, hard", "?"),
    _f("force-decode", bool, False, "Force-decode given prefixes"),
    _f("output-sampling", str, [], "Sampling instead of argmax: full [temp] / topk k [temp]", "*"),
    _f("output-approx-knn", int, [], "LSH-approximated output layer: nodes, hashes", "*"),
    _f("max-length-factor-translate", float, 3.0, "(see max-length-factor)"),
    _f("shortlist", str, [], "Lexical shortlist: path [first] [best] [prune]", "*"),
    _f("devices", str, ["0"], "Device ids (GPU compat)", "+"),
    _f("num-devices", int, 0, "Number of devices (0 = all visible; this slice decodes on one)"),
    _f("cpu-threads", int, 0, "Use CPU with this many threads (inference)", "?"),
]

# training-only model flags (reference: the training/model groups)
_MODEL_TRAINING = [
    _f("pretrained-model", str, None, "Initialize weights from this model"),
    _f("max-length-crop", bool, False, "Crop instead of skipping over-long sentences"),
    _f("fused-ce", str, "auto", "Fused output projection + cross-entropy kernels (CUDA): auto (on the card), on, off"),
    _f("gradient-checkpointing", bool, False, "Rematerialization to save memory: each layer's activations are recomputed in the backward"),
    _f("task", str, None, "Shortcut for a predefined hyperparameter bundle: transformer-base, transformer-big, transformer-base-prenorm, transformer-big-prenorm", "?"),
    _f("auto-tune", bool, False, "Time dense against flash attention and bind the crossover (not ported yet)"),
]

_TRAINING = [
    _f("cost-type", str, "ce-sum", "ce-mean, ce-mean-words, ce-sum, perplexity"),
    _f("sigterm", str, "save-and-exit", "SIGTERM behavior: save-and-exit or exit-immediately"),
    _f("multi-loss-type", str, "sum", "sum, scaled, mean"),
    _f("unlikelihood-loss", bool, False, "Use word-level weights as indicators for unlikelihood loss"),
    _f("overwrite", bool, False, "Do not create checkpoints per save, overwrite model file"),
    _f("no-reload", bool, False, "Do not load existing model file before training"),
    _f("train-sets", str, [], "Paths to training corpora (source target)", "*"),
    _f("vocabs", str, [], "Paths to vocabulary files; created if missing", "*"),
    _f("after-epochs", int, 0, "Stop after this many epochs (0 = no limit)"),
    _f("after-batches", int, 0, "Stop after this many updates (0 = no limit)"),
    _f("after", str, "0e", "Stop after: e.g. 10e (epochs), 100Ku (updates), 1Gt (labels)"),
    _f("disp-freq", str, "1000u", "Display information every N updates/labels"),
    _f("disp-first", int, 0, "Display information for the first N updates"),
    _f("disp-label-counts", bool, True, "Display label counts in progress"),
    _f("save-freq", str, "10000u", "Save model every N updates/labels"),
    _f("normalize-gradient", bool, False, "Additionally divide the gradient by the batch's target-word count"),
    _f("check-gradient-nan", bool, False, "Skip the whole update when the gradient norm is non-finite"),
    _f("dynamic-gradient-scaling", str, [], "FACTOR ['log']: scale outlier gradients down to FACTOR x the windowed average (log-)norm", "*"),
    _f("gradient-norm-average-window", int, 100, "Window for the running gradient-norm average used by --dynamic-gradient-scaling"),
    _f("optimizer-state-dtype", str, "float32", "Storage dtype for Adam's first moment: float32 | bfloat16 (halves m's memory and per-step traffic; math stays f32, v stays f32; beyond the reference)"),
    _f("gradient-dtype", str, "float32", "Dtype gradients are produced and stored in until the optimizer's f32 upcast: float32 | bfloat16 (requires matching bfloat16 compute --precision, otherwise ignored with a warning). Note: the logits backward always rounds its cotangent through the COMPUTE dtype (ops/ops.py logits_matmul), so float32 here does NOT make bf16-compute backward passes fully f32"),
    _f("async-save", bool, False, "Overlap checkpoint writes with training: copies of the saved tensors on the card, taken on the training thread, then the host fetch and the disk writes on a background worker. Needs card memory for one copy of params+EMA+optimizer state at save time"),
    _f("keep-checkpoint-bundles", int, 3, "Crash-safe checkpointing: keep the last N committed checkpoint bundles under <model>.bundles/ (each bundle is the atomic, checksummed model+optimizer+progress unit restore validates and falls back across). Disk cost is ~N x checkpoint size; minimum 1"),
    _f("shuffle", str, "data", "data, batches, none"),
    _f("no-shuffle", bool, False, "Disable shuffling (= --shuffle none)"),
    _f("no-restore-corpus", bool, False, "Do not restore corpus position on resume"),
    _f("tsv", bool, False, "Train sets are tab-separated files (one line carries all streams)"),
    _f("tsv-fields", int, 0, "Number of TSV columns (0 = infer from --vocabs count)"),
    _f("mini-batch", int, 64, "Minibatch size (sentences)"),
    _f("mini-batch-words", int, 0, "Minibatch size in target labels (token budget)"),
    _f("mini-batch-fit", bool, False, "Determine the token budget (mini-batch-words) automatically: the largest whose worst-case batch trains within the card's memory"),
    _f("mini-batch-fit-step", int, 10, "Step for mini-batch-fit search"),
    _f("maxi-batch", int, 100, "Number of minibatches to preload and sort"),
    _f("maxi-batch-sort", str, "trg", "Sorting within maxi-batch: trg, src, none"),
    _f("data-threads", int, 8, "Host threads for data pipeline"),
    _f("mini-batch-words-ref", int, 0, "Reference batch size in words for LR auto-adjustment"),
    _f("mini-batch-warmup", str, "0", "Linear batch-size warmup period (in updates)"),
    _f("mini-batch-track-lr", bool, False, "Adjust LR for tracked batch-size ramp"),
    _f("optimizer", str, "adam", "adam, adagrad, sgd"),
    _f("optimizer-params", float, [], "Optimizer hyperparameters (Adam: beta1 beta2 eps)", "*"),
    _f("optimizer-delay", float, 1.0, "SGD update delay (gradient accumulation): N updates or fractional"),
    _f("dispatch-window", int, 1, "Updates per dispatch (1 only here)"),
    _f("sync-sgd", bool, False, "Synchronous SGD (one device here)"),
    _f("learn-rate", float, 0.0001, "Learning rate"),
    _f("lr-report", bool, False, "Report learning rate in progress lines"),
    _f("lr-decay", float, 0.0, "Decay factor: lr = lr * decay"),
    _f("lr-decay-strategy", str, "epoch+stalled", "epoch, batches, stalled, epoch+batches, epoch+stalled"),
    _f("lr-decay-start", int, [10, 1], "Decay start: [epoch, batches/stalled]", "+"),
    _f("lr-decay-freq", int, 50000, "Decay frequency (strategy: batches)"),
    _f("lr-decay-reset-optimizer", bool, False, "Reset optimizer state at LR decay"),
    _f("lr-decay-repeat-warmup", bool, False, "Repeat warmup after decay"),
    _f("lr-decay-inv-sqrt", str, ["0"], "Inverse-sqrt decay with this warmup, e.g. 16000u", "+"),
    _f("lr-warmup", str, "0", "Linear LR warmup period"),
    _f("lr-warmup-start-rate", float, 0.0, "Warmup start LR"),
    _f("lr-warmup-cycle", bool, False, "Cyclic warmup"),
    _f("lr-warmup-at-reload", bool, False, "Repeat warmup after checkpoint reload"),
    _f("label-smoothing", float, 0.0, "Label smoothing epsilon"),
    _f("clip-norm", float, 1.0, "Global gradient-norm clipping (0 = off)"),
    _f("exponential-smoothing", float, 0.0, "EMA decay of parameters, e.g. 1e-4 (0 = off)"),
    _f("guided-alignment", str, "none", "Path to alignments or 'none'"),
    _f("guided-alignment-cost", str, "ce", "ce, mse, mult"),
    _f("guided-alignment-weight", float, 0.1, "Weight for guided-alignment cost"),
    _f("data-weighting", str, None, "Path to per-sentence/word weight file"),
    _f("data-weighting-type", str, "sentence", "sentence or word"),
    _f("embedding-vectors", str, [], "Paths to pretrained embedding vectors", "*"),
    _f("embedding-normalization", bool, False, "Normalize pretrained embedding vectors"),
    _f("embedding-fix-src", bool, False, "Fix source embeddings"),
    _f("embedding-fix-trg", bool, False, "Fix target embeddings"),
    _f("quantize-bits", int, 0, "Train-time model quantization bits (0 = off)"),
    _f("gradient-dropping-rate", float, 0.0, "Drop this fraction of each gradient tensor (DGC-style, with error feedback); 0 = off"),
    _f("quantize-optimization-steps", int, 0, "Scale-optimization steps for quantization"),
    _f("quantize-log-based", bool, False, "Log-based quantization"),
    _f("quantize-biases", bool, False, "Quantize biases too"),
    _f("dropout-src", float, 0.0, "Source word dropout"),
    _f("dropout-trg", float, 0.0, "Target word dropout"),
    _f("transformer-dropout", float, 0.0, "Dropout between transformer layers"),
    _f("transformer-dropout-attention", float, 0.0, "Attention-weight dropout"),
    _f("transformer-dropout-ffn", float, 0.0, "FFN dropout"),
    _f("devices", str, ["0"], "Device ids (one device here)", "+"),
    _f("num-devices", int, 0, "Number of devices (one here)"),
    _f("mesh", str, [], "Mesh axes (not ported yet)", "*"),
    _f("cpu-threads", int, 0, "Use CPU with this many threads", "?"),
]

# validation (reference: the valid group); the translation validators
# decode with the beam-search flags below
_VALIDATION = [
    _f("valid-sets", str, [], "Paths to validation corpora", "*"),
    _f("valid-freq", str, "10000u", "Validate every N"),
    _f("valid-metrics", str, ["cross-entropy"], "cross-entropy, ce-mean-words, perplexity, bleu, bleu-detok, bleu-segmented, chrf, valid-script, translation", "+"),
    _f("valid-reset-stalled", bool, False, "Reset stalled counts on training restart"),
    _f("valid-reset-all", bool, False, "Reset all validation state on restart"),
    _f("early-stopping", int, 10, "Stop after N consecutive non-improving validations"),
    _f("early-stopping-epsilon", float, [0.0], "Minimum required improvement per metric", "+"),
    _f("early-stopping-on", str, "first", "first, all, any of valid-metrics"),
    _f("keep-best", bool, False, "Keep best model per metric"),
    _f("valid-log", str, None, "Validation log file"),
    _f("valid-max-length", int, 1000, "Max length for validation sentences"),
    _f("valid-mini-batch", int, 32, "Validation minibatch size"),
    _f("valid-script-path", str, None, "External validation script"),
    _f("valid-script-args", str, [], "Args for external validation script", "*"),
    _f("valid-translation-output", str, None, "Print validation translations to file"),
    _f("beam-size", int, 12, "Beam size"),
    _f("normalize", float, 0.0, "Divide score by length^alpha", "?"),
    _f("word-penalty", float, 0.0, "Subtract penalty*length from score"),
    _f("allow-unk", bool, False, "Allow <unk> in output"),
    _f("max-length-factor", float, 3.0, "Max target length factor of source length while decoding"),
]

# marian-server (reference: the serving subsystem's flags, same defaults)
_SERVER = [
    _f("port", int, 8080, "marian-server port (0 = an ephemeral one)"),
    _f("max-queue", int, 512, "Admission control: maximum queued sentences before new requests are shed with !!SERVER-OVERLOADED (0 = unbounded)"),
    _f("request-timeout", float, 0.0, "Per-request deadline in seconds: expired requests get !!SERVER-TIMEOUT, even while queued (0 = none)"),
    _f("batch-token-budget", int, 0, "Token budget of a request-mode device batch, real rows x bucketed width (0 = mini-batch x bucketed max-length)"),
    _f("batching-mode", str, "request", "request: sentences of many requests packed into device batches by token budget, each decoded by the beam search; iteration: sentences join a running decode over a paged KV pool each round and leave the step they finish (greedy at beam 1, copy-on-write beam search above it)"),
    _f("dispatch-stall-timeout", float, 0.0, "Liveness watchdog, both batching modes: a device batch or engine round still running after this many seconds fails its requests with !!SERVER-RETRY and serving moves onto a fresh device worker (0 = off; set well above the worst legitimate batch time; it cannot cancel a kernel that never returns)"),
    _f("iteration-rows", int, 32, "Iteration mode: decode slots, the most sentences decoding at once"),
    _f("iteration-steps", int, 1, "Iteration mode: decode steps per scheduling round, one host sync a round (joins possible every round; the greedy engine and the fused beam merge; the host beam merge runs 1)"),
    _f("iteration-beam-merge", str, "fused", "Iteration mode at beam > 1: where the k*k candidate merge runs; fused (on the device, --iteration-steps steps a round; a round whose worst-case page preclaim does not fit the pool runs one host step) or host (on the host, one step a round)"),
    _f("kv-page-len", int, 16, "Iteration mode: tokens per KV-cache page"),
    _f("kv-pool-bytes", int, 0, "Iteration mode: byte budget of the paged KV pool over all decoder layers, K and V (0 = every slot can hold a full --max-length row)"),
    _f("max-queue-pages", int, 0, "Iteration mode: admission bound on queued KV-pool page debt (0 = 4x the pool's allocatable pages)"),
    _f("prefix-cache", bool, False, "Iteration mode: cross-request prefix sharing over the paged KV pool: an exact source repeat of a sentence decoding now forks from it copy-on-write (greedy), a repeat of a finished one replays its text; finished rows' pages stay with the cache, LRU-evicted under pool pressure"),
    _f("prefix-cache-entries", int, 64, "With --prefix-cache: the most finished decodes kept (LRU)"),
    _f("metrics-port", int, 0, "Serve Prometheus /metrics + /healthz + /readyz on this port (0 = off), with /lifecyclez and the POST /admin/{pin,unpin,rollback} verbs under --model-watch"),
    _f("quiesce-deadline", float, 2.0, "With --batching-mode iteration and --model-watch: drain budget in seconds for a lifecycle quiesce (swap/canary/rollback). Joins pause and active decode rows drain naturally; rows still decoding at the deadline are evicted with a retriable !!SERVER-RETRY (pages freed, counted in marian_serving_quiesce_evictions_total) so a swap is never held hostage by one long sentence; the engine is re-pointed at a step boundary with an empty join set"),
    _f("model-watch", float, 0.0, "marian-server zero-downtime lifecycle: poll <model>.bundles/ every N seconds for newly committed checkpoint bundles and hot-swap to them after an off-path warmup (compat check, load onto the card, golden decode) with no dropped requests; in-flight batches finish on the old model (0 = off)"),
    _f("canary-fraction", float, 0.0, "With --model-watch: route this fraction of device batches to a freshly warmed candidate (state 'canary') before promoting it to live; per-version error/latency metrics (marian_model_*) record both sides, and a canary whose failure rate or p99 regresses is auto-rolled-back (0 = swap immediately after warmup; iteration mode: the canary takes all joins for its evaluation window)"),
    _f("rollback-error-rate", float, 0.5, "With --model-watch: auto-rollback threshold on the windowed device-batch failure rate — a canary (or a freshly swapped live version with a retained rollback target) exceeding this rate is rolled back to the previous live version"),
    _f("rollback-p99-factor", float, 0.0, "With --model-watch: auto-rollback a canary whose p99 batch latency exceeds this factor x the live version's p99 (both over a recent-sample window; 0 = latency check off)"),
    _f("canary-min-batches", int, 8, "With --model-watch and --canary-fraction > 0: promote the canary to live after this many canary batches without tripping a rollback threshold"),
    _f("warmup-golden", str, "", "With --model-watch: file of golden source sentences (one per line) each candidate model must translate during off-path warmup before it can serve — proves the checkpoint loads on the card and decodes (empty = a built-in probe set)"),
    _f("warmup-on-boot", bool, False, "marian-server: golden-decode every serving width bucket of the boot model BEFORE accepting the first request, instead of letting the first request of each bucket pay its first launches inline"),
    # the observability plane (obs/)
    _f("trace", bool, False, "Enable the request-scoped span tracer: every request's path (ingest, admission, queue wait, batch or round, dispatch, translate, reply write) is recorded into a bounded in-memory ring, exported as Chrome trace JSON at /tracez on the metrics port (open in Perfetto). Off = no overhead: no ring allocation, no lock on the hot path"),
    _f("trace-ring", int, 4096, "With --trace: span ring capacity — how many most-recent spans /tracez and flight-recorder dumps can see"),
    _f("trace-dump", str, "", "Arm the crash flight recorder (implies --trace): on a dispatch-watchdog trip, a canary/live/manual rollback, a poison-request isolation, an unhealthy quiesce, a failed pool audit or a fast SLO burn, snapshot the span ring + event timeline + /metrics (+ the pool, slo and perf state) to a timestamped JSON file in this directory"),
    _f("perf-accounting", bool, True, "Live performance & capacity plane (obs/perf.py): per-batch (per-round) chip-seconds/token, tokens/s, device busy ratio, MFU-vs-analytic-roofline and capacity-headroom gauges on /metrics. One counter update per device batch or engine round; `--perf-accounting false` restores the strictly lock-free batch path"),
    _f("slo-availability", float, 0.0, "Declare an availability SLO (e.g. 0.999): the in-process burn-rate engine (obs/slo.py) evaluates ok-vs-(failure|timeout|stalled) outcomes over fast/slow windows, exports marian_slo_* gauges and GET /sloz, emits timeline events on threshold crossings and fires a flight dump on fast burn (0 = off)"),
    _f("slo-p99-ms", float, 0.0, "Declare a latency SLO: 99% of requests must resolve under this many milliseconds (evaluated against the request-latency histogram buckets, conservatively rounded DOWN to a bucket edge). Same burn-rate machinery and exports as --slo-availability (0 = off)"),
    _f("slo-window", float, 60.0, "SLO engine short (fast-burn) window in seconds; the slow window is 10x this"),
    _f("slo-eval-interval", float, 2.0, "SLO engine evaluation cadence in seconds (its own daemon thread; nothing on the batch path)"),
    # the brownout ladder (serving/brownout.py)
    _f("brownout", bool, False, "marian-server brownout ladder: under sustained overload (capacity headroom at/below --brownout-headroom, or the SLO fast-burn threshold) step through explicit degradation levels — 1 tighten per-row decode caps, 2 evict lowest-priority/longest-remaining rows with retriable !!SERVER-RETRY, 3 shed admissions below --brownout-min-priority — so high-priority traffic keeps a bounded p99 while low lanes degrade predictably; every transition is a timeline event + marian_brownout_level move"),
    _f("brownout-headroom", float, 0.1, "Brownout overload signal: escalate while marian_capacity_headroom_ratio stays at or below this floor"),
    _f("brownout-burn", float, 0.0, "Brownout overload signal: escalate while the SLO engine's fast-window burn rate stays at or above this (0 = use the SLO fast-burn factor when an SLO is declared, else the burn signal is off and headroom drives the ladder alone)"),
    _f("brownout-hold", float, 5.0, "Seconds the overload signal must persist before the ladder escalates one level (each rung needs its own sustained hold)"),
    _f("brownout-cool", float, 15.0, "Seconds of continuous health before the ladder de-escalates one level"),
    _f("brownout-cap-factor", float, 0.5, "Brownout level 1: scale factor applied to NEW rows' decode caps (shorter rows claim fewer KV pages and leave sooner; possible truncation of the longest outputs is the explicit trade)"),
    _f("brownout-min-priority", int, 1, "Brownout level 3: admission sheds requests whose priority lane is below this (clients set a lane with the '#priority:N' protocol header; default lane is 0)"),
    # multi-tenant fleet serving (serving/fleet/)
    _f("fleet", str, "", "marian-server multi-tenant fleet serving: comma-separated <tag>=<model-path> tenants (e.g. 'en-de=/m/ende.npz,en-fr=/m/enfr.npz') served concurrently by ONE process — per-tenant lifecycle stacks (bundle watcher, canary, rollback) under the shared --fleet-hbm-budget-mb with evict-coldest + warm-on-demand; clients pick a tenant with the '#model:<tag>' protocol header. Request batching mode only; mutually exclusive with --model-watch"),
    _f("fleet-hbm-budget-mb", float, 0.0, "With --fleet: shared HBM budget in MB for resident tenant executors (estimated as bundle member bytes x an overhead factor); warming a tenant past the budget evicts the coldest idle tenant's executors first (never one with in-flight batches). 0 = unbudgeted — every tenant stays resident"),
    _f("fleet-default-tenant", str, "", "With --fleet: tenant tag for requests that send no '#model:' header (must name a configured tenant); empty = un-tagged requests are rejected with !!SERVER-ERROR"),
    _f("fleet-watch", float, 0.0, "With --fleet: poll each RESIDENT tenant's <model>.bundles/ every N seconds and hot-swap new committed bundles through that tenant's own canary/rollback lifecycle (the per-tenant --model-watch; 0 = off, tenants still warm-on-demand)"),
]

# the trainer's side of the observability plane and the profiler window
# (reference: the general group's profile flags and the translate
# group's, which the reference's training mode includes)
_TRAIN_OBS = [
    _f("profile", str, None, "Capture a torch.profiler device trace to this directory around a training-update window (Chrome trace JSON; open it in Perfetto)", "?"),
    _f("profile-server", int, 0, "Start a live jax.profiler server on this port (0 = off); the port's trainer refuses it: torch.profiler has no live server to attach to"),
    _f("profile-start", int, 10, "First update of the profiler trace window"),
    _f("profile-updates", int, 5, "Number of updates to trace"),
    _f("tensorboard", str, None, "Write train scalars (cost, words/s, learn rate, epoch) as TensorBoard events to this directory (beyond the reference, which logs text only)", "?"),
    _f("metrics-port", int, 0, "Serve Prometheus /metrics + /healthz + /readyz on this port (0 = off): train emits its cost, throughput, learning rate, update, label and skip series, the step phase gauge and the train MFU gauges into the same registry as the server, with /tracez"),
    _f("trace", bool, False, "Enable the span tracer: the train-loop phases (train.data, train.dispatch, train.host) are recorded into a bounded in-memory ring, exported as Chrome trace JSON at /tracez on the metrics port (open in Perfetto). Off = no overhead"),
    _f("trace-ring", int, 4096, "With --trace: span ring capacity — how many most-recent spans /tracez and flight-recorder dumps can see"),
    _f("trace-dump", str, "", "Arm the crash flight recorder (implies --trace): on an injected MARIAN_FAULTS kill, and at exit, snapshot the span ring + event timeline + /metrics + the fault points' hit counters to a timestamped JSON file in this directory"),
    _f("trace-sync-phases", bool, False, "Honest train-loop phase timing: drain the device (torch.cuda.synchronize) at every StepTimer phase boundary so asynchronous launches cannot shift device seconds into whichever later phase waits first. Serializes host and device — a diagnosis mode, not a throughput config"),
    _f("perf-accounting", bool, True, "Live performance plane (obs/perf.py): each display window's chip-seconds per target label and MFU against the analytic roofline of the card's peak for the compute dtype, on /metrics"),
]

FLAGS = _COMMON + _MODEL + _TRANSLATION
MODES = {"translation": FLAGS,
         "server": FLAGS + _SERVER,
         "training": _COMMON + _MODEL + _MODEL_TRAINING + _TRAINING
         + _VALIDATION + _TRAIN_OBS}

# mode-suffixed duplicates and synonyms → (the canonical key runtime code
# reads, a value map or None for identity)
_CANONICAL = {
    "max-length-factor-translate": ("max-length-factor", None),
    "attention-kernel": ("transformer-flash-attention",
                         {"auto": "auto", "dense": "off", "flash": "on"}),
}


class ConfigParser:
    """parseOptions equivalent for one mode (translation or training).
    Returns a fully-populated Options."""

    def __init__(self, mode: str = "translation"):
        self.mode = mode
        self.flags = {f.name: f for f in MODES[mode]}

    def _build_argparser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog=f"marian-tpu-torch ({self.mode})",
                                    add_help=True, allow_abbrev=False)
        for f in self.flags.values():
            kwargs: Dict[str, Any] = {"dest": f.name.replace("-", "_"),
                                      "default": None}
            if f.type is bool:
                # CLI11-style: bare flag = true, or explicit --flag true/false
                kwargs.update(nargs="?", const=True, type=_parse_bool)
            else:
                kwargs["type"] = f.type
                if f.nargs:
                    kwargs["nargs"] = f.nargs
                    if f.nargs == "?":
                        kwargs["const"] = ""
            p.add_argument(f"--{f.name}", help=f.help, **kwargs)
        return p

    def defaults(self) -> Dict[str, Any]:
        return {f.name: f.default for f in self.flags.values()
                if f.default is not None}

    def parse(self, argv: Optional[Sequence[str]] = None) -> Options:
        argv = list(sys.argv[1:] if argv is None else argv)
        ns, unknown = self._build_argparser().parse_known_args(argv)
        if unknown:
            raise SystemExit(f"Unknown option(s): {' '.join(unknown)}")
        cli = {k.replace("_", "-"): v for k, v in vars(ns).items()
               if v is not None}
        merged = self.defaults()
        explicit = set(cli)
        for path in _as_list(cli.get("config")):
            with open(path, "r", encoding="utf-8") as fh:
                loaded = yaml.safe_load(fh) or {}
            for k, v in loaded.items():
                merged[str(k)] = v
                explicit.add(str(k))
        # the --task bundle (from the command line or a config file)
        # over the config files' values, under the command line's
        task = cli.get("task", merged.get("task"))
        if task:
            merged = expand_aliases(task, merged)
            merged["task"] = task
        for k, v in cli.items():
            if k != "config":
                merged[k] = v
        if merged.get("fp16"):
            # --fp16 shortcut (reference: precision float16 float32): it
            # maps to bfloat16 compute, which keeps the f32 exponent
            # range and needs no loss scaling; an explicit --precision
            # wins
            if "precision" not in explicit:
                merged["precision"] = ["bfloat16", "float32"]
        if str((merged.get("precision") or ["float32"])[0]) in (
                "float16", "fp16", "half"):
            log.warn("precision float16 is mapped to bfloat16 (same width, "
                     "f32 exponent range — no loss scaling needed)")
            merged["precision"] = ["bfloat16"] + list(merged["precision"][1:])
        # bare `--output-sampling` (Marian shorthand) = full sampling, temp 1
        if cli.get("output-sampling") == []:
            merged["output-sampling"] = ["full"]
        # bare `--dynamic-gradient-scaling` = factor 2 (the YAML `true`
        # spelling too)
        if cli.get("dynamic-gradient-scaling") == [] \
                or merged.get("dynamic-gradient-scaling") is True:
            merged["dynamic-gradient-scaling"] = ["2"]
        for alias, (canon, vmap) in _CANONICAL.items():
            if alias in explicit and canon not in explicit:
                val = merged[alias]
                if vmap is not None:
                    if str(val) not in vmap:
                        raise SystemExit(
                            f"--{alias}: unknown value '{val}' "
                            f"(expected one of {sorted(vmap)})")
                    val = vmap[str(val)]
                merged[canon] = val
        opts = Options(merged)
        if cli.get("version"):
            print("marian-tpu-torch v0.1.0")
            raise SystemExit(0)
        if cli.get("dump-config"):
            data = opts.as_dict()
            if cli["dump-config"] == "minimal":
                data = {k: v for k, v in data.items()
                        if self.defaults().get(k) != v}
            data.pop("dump-config", None)
            yaml.safe_dump(data, sys.stdout, default_flow_style=False,
                           sort_keys=True)
            raise SystemExit(0)
        return opts


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def _as_list(v: Any) -> List[Any]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def parse_options(argv: Optional[Sequence[str]] = None,
                  mode: str = "translation") -> Options:
    """Module-level convenience mirroring ConfigParser::parseOptions, with
    the reference's validation of the mode (``config_validator``) and
    the port's own check of ``--cpu-threads``."""
    opts = ConfigParser(mode).parse(argv)
    if opts.get("no-shuffle", False):
        opts.set("shuffle", "none")
    validate_options(opts, mode)
    if int(opts.get("mini-batch-fit-step", 10) or 10) != 10:
        # the reference's audit of a flag it parses and does not read
        log.warn("--mini-batch-fit-step has no effect: bucketed static "
                 "shapes replace the binary batch-fitting search")
    threads = opts.get("cpu-threads", 0)
    if isinstance(threads, (str, bool)) or threads is None:
        raise ValueError("--cpu-threads needs a thread count N > 0")
    return opts
