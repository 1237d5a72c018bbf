"""Checkpoints, after ``marian_tpu/training/checkpoint.py``: the
reference layout of three files,

    model.npz                 params + embedded special:model.yml
    model.npz.optimizer.npz   optimizer state ('t', 'm:<name>', ...)
    model.npz.progress.yml    TrainingState (incl. the corpus position)

plus model.ema.npz under --exponential-smoothing, committed together as
one crash-safe BUNDLE (``training/bundle.py``): staged, fsync'd, a
checksummed ``MANIFEST.json`` (v2, with the compat block the serving
lifecycle checks), renamed into ``<model>.bundles/bundle-<seq>`` in one
atomic step, then republished as the top-level files above; the last
--keep-checkpoint-bundles bundles are kept. Restore prefers the newest
bundle that validates and falls back across damaged ones, logging each
one it skips; a flat layout without bundles (hand-copied models,
checkpoints written before bundles) loads as before.

Outside the resume bundle, as in the reference: the iteration-numbered
params copies (model.iter<N>.npz) that training writes without
--overwrite, and under --keep-best the params of each metric's best
validation (model.best-<metric>.npz), each written atomically (temp
file + rename). ``model.npz`` is the format both packages' decoders
load, and a bundle of either package resumes in the other.

``--async-save`` (the reference's ``AsyncSaver``) overlaps the
checkpoint's writes with training. The optimizer updates the parameters
and its state in place, so the training thread first copies every
tensor on its own device, in stream order, before the next update's
first write, and records an event after the copies. The one background
worker waits for that event, fetches the copies to the host on a side
stream (each copy is dropped once fetched) and writes the bundle; the
files are those the synchronous path writes. Saves are serialized, and
``wait()`` flushes the one in flight, re-raising its failure on the
training thread.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import faultpoints as fp
from ..common import io as mio
from ..common import logging as log
from . import bundle as bdl
from .training_state import TrainingState


def _host(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in tree.items()}


class Snapshot:
    """Copies of a flat dict's tensors, taken on the training thread
    (bf16 leaves as f32, as the synchronous path saves them), with the
    event that marks them complete on each card's current stream."""

    def __init__(self, tree: Dict[str, Any]):
        self.tree = {k: (v.detach().to(
            torch.float32 if v.dtype == torch.bfloat16 else v.dtype,
            copy=True) if torch.is_tensor(v) else v)
            for k, v in tree.items()}
        self.events = []
        for dev in {v.device for v in self.tree.values()
                    if torch.is_tensor(v) and v.is_cuda}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.events.append((dev, ev))

    def fetch(self) -> Dict[str, np.ndarray]:
        """The copies as numpy, on the worker thread: each event waited
        for first, then the copies moved on a side stream (the training
        stream runs on meanwhile) and dropped one by one."""
        streams = {}
        for dev, ev in self.events:
            ev.synchronize()
            streams[dev] = torch.cuda.Stream(dev)
        out = {}
        for k in list(self.tree):
            v = self.tree.pop(k)
            if torch.is_tensor(v) and v.is_cuda:
                with torch.cuda.stream(streams[v.device]):
                    v = v.cpu()
            out[k] = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        return out


class AsyncSaver:
    """``--async-save``: one background worker writes the checkpoints,
    one at a time."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-save")
        self._inflight = None

    @staticmethod
    def snapshot(tree: Optional[Dict[str, Any]]) -> Optional[Snapshot]:
        """Must run on the training thread before the next update is
        dispatched: the copies are what decouple the save from the
        in-place optimizer step."""
        return None if tree is None else Snapshot(tree)

    def submit(self, fn) -> None:
        """Queue one save behind any in-flight one (at most one snapshot
        waiting and one being written)."""
        self.wait()
        self._inflight = self._pool.submit(fn)

    def wait(self) -> None:
        """Block until the in-flight save is on disk; a failed save's
        exception is raised here, on the training thread."""
        if self._inflight is not None:
            try:
                self._inflight.result()
            finally:
                self._inflight = None

    def close(self) -> None:
        """Flush the in-flight save and stop the worker."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def suffixed_path(model_path: str, suffix: str) -> str:
    """model.npz + '.iter8' -> model.iter8.npz (the reference's rule)."""
    if model_path.endswith((".npz", ".bin")):
        base, ext = os.path.splitext(model_path)
        return base + suffix + ext
    return model_path + suffix + ".npz"


def save_checkpoint(model_path: str, params: Dict[str, Any],
                    config_yaml: str, graph_group=None,
                    state: Optional[TrainingState] = None,
                    smooth_params: Optional[Dict[str, Any]] = None,
                    extra_model_suffixes: Tuple[str, ...] = (),
                    suffix: str = "",
                    keep_bundles: int = bdl.DEFAULT_KEEP,
                    async_saver: Optional[AsyncSaver] = None) -> None:
    """Commit model, optimizer and progress as one bundle, keeping the
    newest ``keep_bundles``. ``extra_model_suffixes`` writes params +
    config copies beside the model (the '.iter<N>' files of a save
    without --overwrite). A ``suffix`` ('.best-bleu', ...) writes only
    the params (and their smoothed copy) to the suffixed path, outside
    the resume bundle. With ``async_saver`` the writes run on its worker
    from a snapshot taken here (the card holds one copy of every saved
    tensor until the worker has fetched it)."""
    with_opt = graph_group is not None and not suffix
    meta = _bundle_meta(state)
    if async_saver is None:
        _write_checkpoint(model_path, _host(params), config_yaml,
                          None if smooth_params is None
                          else _host(smooth_params),
                          graph_group.optimizer_arrays() if with_opt
                          else None,
                          state, suffix, extra_model_suffixes, keep_bundles,
                          meta)
        return
    snaps = [async_saver.snapshot(t) for t in (
        params, smooth_params,
        graph_group.optimizer_tensors() if with_opt else None)]
    # progress is host data, but the object (its validator dicts too)
    # goes on changing on the training thread
    state = copy.deepcopy(state)

    def _write():
        fp.fault_point("ckpt.async.worker")
        host = [None if sn is None else sn.fetch() for sn in snaps]
        _write_checkpoint(model_path, host[0], config_yaml, host[1],
                          host[2], state, suffix, extra_model_suffixes,
                          keep_bundles, meta)
    async_saver.submit(_write)


def _write_checkpoint(model_path: str, host_params: Dict[str, np.ndarray],
                      config_yaml: str,
                      host_smooth: Optional[Dict[str, np.ndarray]],
                      host_opt: Optional[Dict[str, np.ndarray]],
                      state: Optional[TrainingState], suffix: str,
                      extra_model_suffixes: Tuple[str, ...],
                      keep_bundles: int, meta: Dict[str, Any]) -> None:
    if suffix:
        path = suffixed_path(model_path, suffix)
        mio.save_model(path, host_params, config_yaml)
        if host_smooth is not None:
            base, ext = os.path.splitext(path)
            mio.save_model(base + ".ema" + ext, host_smooth, config_yaml)
        log.info("Saved model to {}", path)
        return
    members: Dict[str, Any] = {}
    model_name = os.path.basename(model_path)
    members[model_name] = lambda p: mio.save_model(p, host_params,
                                                   config_yaml)
    if host_smooth is not None:
        base, ext = os.path.splitext(model_path)
        members[os.path.basename(base + ".ema" + ext)] = \
            lambda p: mio.save_model(p, host_smooth, config_yaml)
    if host_opt is not None:
        def _write_opt(p):
            with open(p, "wb") as fh:
                np.savez(fh, **host_opt)
        members[model_name + ".optimizer.npz"] = _write_opt
    if state is not None:
        members[model_name + ".progress.yml"] = state.save
    committed = bdl.write_bundle(model_path, members, keep=keep_bundles,
                                 meta=meta,
                                 compat=_compat_from_yaml(config_yaml))
    for s in extra_model_suffixes:
        # numbered params + config snapshots OUTSIDE rotation: plain
        # atomic files
        path = suffixed_path(model_path, s)
        mio.save_model(path, host_params, config_yaml)
        log.info("Saved model to {}", path)
    log.info("Saved model to {} (bundle {})", model_path,
             os.path.basename(committed))


def _bundle_meta(state: Optional[TrainingState]) -> Dict[str, Any]:
    """The manifest's ``meta``: the update and epoch counts (the
    reference adds the device geometry of its sharded optimizer, which
    the single-device port has not)."""
    meta: Dict[str, Any] = {}
    if state is not None:
        meta.update({"batches": state.batches, "epochs": state.epochs})
    return meta


def _compat_from_yaml(config_yaml: str) -> Optional[Dict[str, Any]]:
    """Manifest v2 compat block from the checkpoint-embedded config text
    (geometry hash + vocab checksums — what the serving lifecycle checks
    before accepting a hot-swap). A config that fails to parse degrades
    to no compat block (a v1-style manifest), never a failed save."""
    if not config_yaml:
        return None
    try:
        import yaml
        cfg = yaml.safe_load(config_yaml)
        if not isinstance(cfg, dict):
            return None
        return bdl.compat_block(cfg)
    except Exception as e:  # noqa: BLE001
        log.warn("could not derive checkpoint compat block ({}); manifest "
                 "will carry none", e)
        return None


def _load_flat(base: str, graph_group
               ) -> Tuple[Dict[str, np.ndarray], Optional[str],
                          Optional[TrainingState]]:
    params, config = mio.load_model(base)
    state = None
    if os.path.exists(base + ".progress.yml"):
        state = TrainingState.load(base + ".progress.yml")
    opt = base + ".optimizer.npz"
    if graph_group is not None and os.path.exists(opt):
        with np.load(opt) as z:
            graph_group.load_optimizer_arrays({k: z[k] for k in z.files})
    return params, config, state


def load_checkpoint(model_path: str, graph_group=None
                    ) -> Tuple[Dict[str, np.ndarray], Optional[str],
                               Optional[TrainingState]]:
    """(params as numpy, embedded config, TrainingState or None); loads
    the optimizer state into ``graph_group`` when it exists. Prefers the
    newest bundle under ``<model>.bundles/`` that validates (checksums
    verified; each damaged newer one is skipped with an error line); the
    flat layout loads when no bundle exists. When bundles exist and none
    validates, it raises: the flat files are then the published view of
    a rejected bundle, not an independent copy."""
    found = bdl.latest_valid_bundle(model_path)
    if found is not None:
        bdir, _ = found
        return _load_flat(os.path.join(bdir, os.path.basename(model_path)),
                          graph_group)
    if bdl.list_bundles(bdl.bundle_root(model_path)):
        raise bdl.BundleError(
            f"every checkpoint bundle under "
            f"{bdl.bundle_root(model_path)} failed validation; the flat "
            f"layout at {model_path} is the published view of a rejected "
            f"bundle, not an independent copy — restore a bundle from "
            f"backup, or remove the .bundles/ directory to force a flat "
            f"resume")
    return _load_flat(model_path, graph_group)
