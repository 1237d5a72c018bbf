"""The trainer, trimmed from ``marian_tpu/training/train.py``
(reference src/training/training.h :: Train<T>::run).

Builds the vocabs (from the training data when a vocab file is missing),
the corpus and batch generator, the model and the single-device
GraphGroup; restores a checkpoint (params, optimizer state, progress and
corpus position: from the newest valid bundle under <model>.bundles/,
or the flat files) unless --no-reload; runs the epoch loop, one update a
group of --optimizer-delay batches, with the display, validation, save
and stop triggers; saves at the end.

Validation (--valid-sets, at --valid-freq) runs the --valid-metrics
validators (training/validators.py, translator/validators.py) on the
current parameters, or their smoothed copy under
--exponential-smoothing, logs ``[valid]`` lines, saves
model.best-<metric>.npz under --keep-best when a metric improved, and
lets the Scheduler apply --lr-decay; early stopping ends training after
--early-stopping stalled validations. A group still short of
--optimizer-delay batches at the end of an epoch is dropped, as in the
reference.

SIGTERM and SIGINT set a flag (``common/signal_handling``) that the loop
reads after every update, as the reference's ``_check_stop`` does: under
``--sigterm save-and-exit`` (the default) the update finishes, the
checkpoint is saved and training ends normally; under
``exit-immediately`` it ends without a save.

Batch size, as the reference sets it: --mini-batch-fit searches the
largest token budget whose worst-case batch trains on the card
(``training/batch_fit.py``); --mini-batch-track-lr anchors
--mini-batch-words-ref at that budget, so the lr follows each batch's
labels; --mini-batch-warmup N ramps the batch linearly over the first N
updates. --async-save writes the checkpoints on a background worker
(``training/checkpoint.py``); the trainer waits for the save in flight
before a validation and at every exit.

Randomness is explicit and seeded from --seed: corpus and batch
shuffling draw from numpy's RandomState as the reference does, and
dropout draws from a ``torch.Generator`` on the training device that is
re-seeded from (seed, update number, micro-batch index) before every
micro-batch, so a resumed run draws the same masks as an uninterrupted
one (the reference folds its dropout key by the update number and the
micro-batch index for the same reason).

The training data and init flags, as the reference reads them: --tsv
takes one tab-separated file for every stream, and a vocabulary built
from it sees all its columns; --right-left reverses the target; the
--guided-alignment side stream feeds the guided cost; --embedding-vectors
(with --embedding-normalization) load word2vec tables into a fresh
init only (a resumed or --pretrained-model run keeps its tables), and
--embedding-fix-src/-trg freeze them (``graph_group.frozen_names``).

Mixed precision as the reference runs it: --precision bfloat16 (or
--fp16) computes the forward and backward in bf16 from f32 master
weights, which the optimizer updates and the checkpoint saves in f32;
--precision's second value is accepted and not acted on.

Observability, as the reference wires it: ``obs.configure`` (--trace,
--trace-dump, --perf-accounting), the perf plane's geometry for the
train MFU gauge (the card's peak for the compute dtype; 0 on the CPU),
``--metrics-port`` serving the trainer's series and ``/tracez``, a
``StepTimer`` over the phases ``data``, ``dispatch`` and ``host`` (with
--trace-sync-phases it synchronizes the card at every boundary), a
``TraceWindow`` (--profile) and the phase report at the end. The
``train.nan_grad`` fault point is crossed for every batch: armed 'fail'
poisons that batch's target mask with NaN through the full backward,
which --check-gradient-nan must skip.

Runs on the card unless the CPU is asked for (--cpu-threads N, or
device="cpu" from Python); without a card it raises.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..common import faultpoints as fp
from ..common import io as mio
from ..common import logging as log
from ..common import signal_handling
from ..common.scheduling_parameter import (SchedulingParameter,
                                           SchedulingUnit)
from ..data.batch_generator import BatchGenerator
from ..data.corpus import Corpus
from ..data.vocab import DefaultVocab, create_vocab
from ..device import resolve_device
from ..models import transformer as T
from ..models.encoder_decoder import batch_to_arrays, create_model
from ..obs.profiling import StepTimer, TraceWindow
from ..serving.metrics import maybe_start_metrics_server
from . import bundle as bdl
from .checkpoint import AsyncSaver, load_checkpoint, save_checkpoint
from .graph_group import GraphGroup, delay_of
from .scheduler import Scheduler
from .training_state import TrainingState
from .validators import create_validators

# option → value at which the feature is off; set to anything else the
# trainer refuses to start instead of ignoring it
_UNPORTED = {
    # the multi-update dispatch: with CUDA graphs (ROADMAP A10)
    "dispatch-window": 1,
    "mesh": [],
    "auto-tune": False,
    # a live jax.profiler server: torch.profiler has no counterpart
    "profile-server": 0,
}


def _refuse_unported(options) -> None:
    delay_of(options)       # the reference's refusal of delay with window
    for name, off in _UNPORTED.items():
        val = options.get(name, off)
        if val in (off, None, False, [], ""):
            continue
        if isinstance(off, (int, float)) and not isinstance(off, bool) \
                and float(val) == float(off):
            continue
        raise NotImplementedError(
            f"--{name} {val} is not ported to marian_tpu_torch yet "
            f"(ROADMAP: what the training slice left out)")
    if len(options.get("devices", ["0"]) or ["0"]) > 1 \
            or int(options.get("num-devices", 0) or 0) > 1:
        raise NotImplementedError("multi-device training is not ported to "
                                  "marian_tpu_torch yet (ROADMAP)")
    precision = options.get("precision", ["float32"]) or ["float32"]
    if str(precision[0]) not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"--precision {' '.join(map(str, precision))}: the port "
            f"computes in float32 or bfloat16 (float16 maps to bfloat16)")
    if str(options.get("type", "transformer")) != "transformer":
        raise NotImplementedError(f"--type {options.get('type')}: this "
                                  f"slice trains --type transformer")


def _vocab(path: str, train_path: str, max_size: int) -> DefaultVocab:
    """Load a vocab, or build it from the training file and save it when
    the file does not exist (reference: Vocab::create)."""
    if os.path.exists(path):
        return create_vocab(path, max_size=max_size)
    with open(train_path, "r", encoding="utf-8") as fh:
        vocab = DefaultVocab.build(fh, max_size=max_size)
    vocab.save(path)
    log.info("Created vocabulary {} ({} entries) from {}", path, len(vocab),
             train_path)
    return vocab


class Train:
    """One training run. After ``run`` the attributes ``graph_group`` and
    ``state`` describe it."""

    def __init__(self, options,
                 device: Optional[Union[str, torch.device]] = None):
        self.options = options
        log.create_loggers(options)
        signal_handling.set_signal_handlers()
        _refuse_unported(options)
        self.device = resolve_device(
            device, int(options.get("cpu-threads", 0) or 0))
        self.graph_group: Optional[GraphGroup] = None
        self.state: Optional[TrainingState] = None
        self.metrics_server = None      # --metrics-port; lives to exit
        self.step_phases = {}           # StepTimer.report() at the end

    def run(self) -> None:
        opts = self.options
        seed = int(opts.get("seed", 0)) or 1234
        train_sets = list(opts.get("train-sets"))
        tsv = bool(opts.get("tsv", False)) and len(train_sets) == 1
        if len(train_sets) != (1 if tsv else 2):
            raise NotImplementedError("this slice trains one source and one "
                                      "target stream (--train-sets src trg, "
                                      "or one file under --tsv)")
        vocab_paths = list(opts.get("vocabs", [])) or \
            [p + ".yml" for p in train_sets]
        # --tsv: the one file feeds every vocabulary (a vocabulary built
        # from it sees all its columns)
        train_per_vocab = (train_sets * len(vocab_paths) if tsv
                           else train_sets)
        dim_vocabs = list(opts.get("dim-vocabs", [0, 0]))
        vocabs = [_vocab(vp, tp, dim_vocabs[i] if i < len(dim_vocabs) else 0)
                  for i, (vp, tp) in enumerate(zip(vocab_paths,
                                                   train_per_vocab))]
        log.info("Vocabulary sizes: {}",
                 " ".join(str(len(v)) for v in vocabs))
        corpus = Corpus(train_sets, vocabs, opts)
        model = create_model(opts, len(vocabs[0]), len(vocabs[1]))
        gg = GraphGroup(model, opts, self.device)

        model_path = opts.get("model", "model.npz")
        state = TrainingState(seed=seed)
        init_params = None
        # a checkpoint exists if the flat layout OR any committed bundle
        # does: a save killed between the bundle commit and the top-level
        # publish leaves only the bundle, and that moment must resume
        has_checkpoint = (os.path.exists(model_path) or bool(
            bdl.list_bundles(bdl.bundle_root(model_path))))
        if has_checkpoint and not opts.get("no-reload", False):
            log.info("Loading model from {}", model_path)
            init_params, _, loaded = load_checkpoint(model_path, gg)
            if loaded is not None:
                state = loaded
                if state.corpus and not opts.get("no-restore-corpus", False):
                    corpus.restore(state.corpus)
                    log.info("Restored corpus position: epoch {}, sent {}",
                             state.corpus.get("epoch"),
                             state.corpus.get("position"))
        elif opts.get("pretrained-model", None):
            init_params, _ = mio.load_model(opts.get("pretrained-model"))
        if init_params is None:
            init_params = T.init_params(model.cfg, seed)
            if opts.get("embedding-vectors", []):
                load_embedding_vectors(opts, init_params, vocabs)
        # the schedule's decay factor and warmup restart resume with it
        gg.schedule.decay_factor = state.factor
        if state.batches > 0 and opts.get("lr-warmup-at-reload", False):
            gg.schedule.warmup_offset = state.batches
            log.info("Repeating learning-rate warmup from update {} "
                     "(--lr-warmup-at-reload)", state.batches)
        gg.initialize(init_params)
        n_params = sum(p.numel() for p in gg.params.values())
        log.info("Model created on {}: {} parameters ({:.1f}M)", self.device,
                 n_params, n_params / 1e6)
        self.graph_group, self.state = gg, state

        scheduler = Scheduler(opts, state)
        if state.batches > 0 and (opts.get("valid-reset-stalled", False)
                                  or opts.get("valid-reset-all", False)):
            scheduler.reset_stalled(
                reset_best=bool(opts.get("valid-reset-all", False)))
            log.info("Validation stall counters reset on resume")
        validators = create_validators(opts, vocabs, model, self.device)
        for v in validators:
            # the live state: {U}/{E}/{B}/{T} output-path templates read it
            v.training_state = state
        config_yaml = opts.as_yaml()
        generator = torch.Generator(device=self.device)
        # --async-save: the writes overlap training (checkpoint.py)
        saver = AsyncSaver() if opts.get("async-save", False) else None
        # resume point of the last APPLIED batch: the corpus runs a whole
        # maxi window ahead of training
        last_corpus_state = [corpus.state.as_dict()]

        def do_save(suffix: str = "") -> None:
            state.corpus = last_corpus_state[0]
            smooth = gg.smoothed() if gg.opt_cfg.smoothing > 0 else None
            # without --overwrite, every save also keeps an
            # iteration-numbered copy of the parameters (Train::save)
            extra = (() if suffix or opts.get("overwrite", False)
                     else (f".iter{state.batches}",))
            save_checkpoint(model_path, gg.export_params(), config_yaml, gg,
                            state, smooth_params=smooth,
                            extra_model_suffixes=extra, suffix=suffix,
                            keep_bundles=int(
                                opts.get("keep-checkpoint-bundles",
                                         bdl.DEFAULT_KEEP)
                                or bdl.DEFAULT_KEEP),
                            async_saver=saver)

        def do_validate() -> None:
            if saver is not None:
                # a validator that reads files sees this moment's
                # checkpoint, not one half written
                saver.wait()
            params = gg.smoothed() if gg.opt_cfg.smoothing > 0 \
                else gg.export_params()
            for v in validators:
                value = v.validate(params)
                improved = scheduler.register_validation(
                    v.name, value, v.lower_is_better)
                log.log_valid(
                    "info",
                    f"Ep. {state.epochs + 1} : Up. {state.batches} : "
                    f"{v.name} : {value:.6f} : "
                    + ("new best" if improved else
                       f"stalled {state.validators[v.name]['stalled']} "
                       f"times"))
                if improved and opts.get("keep-best", False):
                    do_save(suffix=".best-" + v.name)
            scheduler.maybe_decay_lr(gg.schedule, gg)

        if opts.get("mini-batch-fit", False):
            # the largest token budget whose worst-case batch trains on
            # this device (batch_fit.py); the batch generator reads it
            from .batch_fit import fit_mini_batch_words
            opts.set("mini-batch-words",
                     fit_mini_batch_words(gg, opts, len(vocabs[-1])))
        # --mini-batch-track-lr: the lr (and Adam's eps) follow the batch's
        # labels over the full (possibly fitted) budget, through
        # --mini-batch-words-ref, which the optimizer step applies
        if opts.get("mini-batch-track-lr", False) \
                and not int(opts.get("mini-batch-words-ref", 0) or 0):
            ref = int(opts.get("mini-batch-words", 0) or 0)
            if ref > 0:
                opts.set("mini-batch-words-ref", ref)
                gg.opt_cfg.ref_mb_words = ref
                log.info("mini-batch-track-lr: LR tracks batch size "
                         "(reference {} words)", ref)
        # --mini-batch-warmup: the batch (rows and token budget) ramps
        # linearly over the first N updates
        wu_n = warmup_updates(opts)
        budget_scale = None
        if wu_n > 0:
            budget_scale = lambda: min(  # noqa: E731
                (state.batches + 1) / float(wu_n), 1.0)
            log.info("mini-batch-warmup: ramping batch size over the "
                     "first {} updates", wu_n)

        # observability: --trace records the loop's phase spans into the
        # tracer serving uses, --trace-dump arms the flight recorder (an
        # armed fault point's kill dumps the ring first)
        obs.configure(opts)
        if obs.PERF.enabled:
            precision = opts.get("precision", ["float32"]) or ["float32"]
            obs.PERF.set_geometry(
                emb=int(opts.get("dim-emb", 512)),
                ffn=int(opts.get("transformer-dim-ffn", 2048)),
                enc_depth=int(opts.get("enc-depth", 6)),
                dec_depth=int(opts.get("dec-depth", 6)),
                vocab=len(vocabs[-1]),
                device_kind=(torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else None),
                compute_dtype=str(precision[0]))
        self.metrics_server = maybe_start_metrics_server(
            opts, routes=obs.trace_routes())
        # --trace-sync-phases: drain the card at every phase boundary, so
        # each phase holds the device time it caused (obs/profiling.py)
        sync = bool(opts.get("trace-sync-phases", False)) \
            and self.device.type == "cuda"
        stimer = StepTimer(
            sync_fn=(lambda: torch.cuda.synchronize(self.device))
            if sync else None)
        trace = TraceWindow(opts, self.device)

        def arrays(batch):
            """The batch on the device, crossing ``train.nan_grad``: an
            armed 'fail' poisons its target mask with NaN, a real
            non-finite gradient through the full backward."""
            a = batch_to_arrays(batch, self.device)
            try:
                fp.fault_point("train.nan_grad")
            except fp.InjectedFault:
                a["trg_mask"] = a["trg_mask"] * float("nan")
                log.warn("FAULT train.nan_grad: target mask poisoned with "
                         "NaN for update {}", state.batches + 1)
            return a

        log.info("Training started")
        stop = False
        while scheduler.keep_going() and not stop:
            n_batches = 0
            # the reference's micro list starts empty each epoch: a group
            # short of --optimizer-delay at the epoch's end is dropped
            group = []
            stimer.phase("data")
            for batch in BatchGenerator(corpus, opts,
                                        budget_scale=budget_scale):
                n_batches += 1
                group.append(batch)
                if len(group) < gg.delay:
                    continue
                step = state.batches + 1
                stimer.phase("dispatch")
                trace.tick(step)
                out = gg.update([arrays(b) for b in group], step,
                                generator, seed)
                stimer.phase("host")
                if group[-1].corpus_state is not None:
                    last_corpus_state[0] = group[-1].corpus_state
                scheduler.update(out.loss_sum, sum(b.words for b in group),
                                 sum(b.size for b in group),
                                 src_words=sum(b.src_words for b in group),
                                 lr=gg.schedule(step), skipped=out.skipped)
                group = []
                if scheduler.should_validate():
                    do_validate()
                if scheduler.should_save():
                    do_save()
                stimer.phase("data")
                if signal_handling.signal_flag():
                    if opts.get("sigterm", "save-and-exit") == \
                            "exit-immediately":
                        log.info("Caught termination signal; exiting "
                                 "immediately (--sigterm exit-immediately)")
                        trace.close()
                        scheduler.close()
                        if saver is not None:
                            saver.close()   # a save already in flight ends
                        return
                    log.info("Caught termination signal; saving and exiting")
                    do_save()
                    stop = True
                    break
                if not scheduler.keep_going():
                    stop = True
                    break
            else:
                if n_batches == 0:
                    raise ValueError("an epoch of the training corpus gave "
                                     "no batch (every sentence is longer "
                                     "than --max-length?)")
                scheduler.new_epoch()
        trace.close()
        stimer.stop()
        self.step_phases = stimer.report()   # the log line and the gauge
        scheduler.close()        # the last skip flags, the TensorBoard flush
        log.info("Training finished")
        do_save()
        if saver is not None:
            saver.close()       # the last checkpoint is on disk at exit


def load_embedding_vectors(opts, params, vocabs) -> None:
    """--embedding-vectors src.vec [trg.vec]: word2vec text tables into
    the fresh init's embedding tables (``Wemb`` or ``encoder_Wemb`` for
    the source, ``decoder_Wemb`` or the tied ``Wemb`` for the target),
    unit rows under --embedding-normalization; words a file lacks keep
    their init rows (reference: train.py, Embedding with embFile)."""
    from ..layers.embedding_io import load_word2vec, normalize_rows
    files = list(opts.get("embedding-vectors", []) or [])
    dim = int(opts.get("dim-emb", 512))
    norm = bool(opts.get("embedding-normalization", False))

    def load_into(name, path, vocab):
        if name not in params:
            return
        tab = load_word2vec(path, vocab, dim,
                            init=params[name].detach().cpu().numpy())
        if norm:
            tab = normalize_rows(tab)
        params[name] = torch.from_numpy(np.ascontiguousarray(tab))

    load_into("Wemb" if "Wemb" in params else "encoder_Wemb", files[0],
              vocabs[0])
    if len(files) > 1:
        load_into("decoder_Wemb" if "decoder_Wemb" in params else "Wemb",
                  files[1], vocabs[-1])


def warmup_updates(opts) -> int:
    """--mini-batch-warmup as an update count; only the update unit means
    something for a ramp by update, so other units are refused."""
    raw = str(opts.get("mini-batch-warmup", "0") or "0")
    wu = SchedulingParameter.parse(raw)
    if wu.n > 0 and wu.unit != SchedulingUnit.UPDATES:
        raise ValueError(
            f"--mini-batch-warmup {raw}: only update-counted warmup "
            f"(e.g. 4000 or 4000u) is supported")
    return wu.n


def train_main(options) -> None:
    Train(options).run()
