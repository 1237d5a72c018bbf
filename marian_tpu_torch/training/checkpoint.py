"""Checkpoints, trimmed from ``marian_tpu/training/checkpoint.py``: the
reference layout of three files,

    model.npz                 params + embedded special:model.yml
    model.npz.optimizer.npz   optimizer state ('t', 'm:<name>', ...)
    model.npz.progress.yml    TrainingState (incl. the corpus position)

plus model.ema.npz under --exponential-smoothing, the
iteration-numbered params copies (model.iter<N>.npz) that training
writes without --overwrite, and under --keep-best the params of each
metric's best validation (model.best-<metric>.npz). Each file is
written atomically (temp file + rename). ``model.npz`` is the format
both packages' decoders load.

Trimmed: the checksummed bundle directories and the asynchronous saver.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import io as mio
from ..common import logging as log
from .training_state import TrainingState


def _host(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in tree.items()}


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
                    suffix: str = "") -> None:
    """``extra_model_suffixes`` writes params + config copies beside the
    model (the '.iter<N>' files of a save without --overwrite). A
    ``suffix`` ('.best-bleu', ...) writes only the params (and their
    smoothed copy) to the suffixed path, outside the resume files."""
    if suffix:
        path = suffixed_path(model_path, suffix)
        mio.save_model(path, _host(params), config_yaml)
        if smooth_params is not None:
            base, ext = os.path.splitext(path)
            mio.save_model(base + ".ema" + ext, _host(smooth_params),
                           config_yaml)
        log.info("Saved model to {}", path)
        return
    host_params = _host(params)
    mio.save_model(model_path, host_params, config_yaml)
    if smooth_params is not None:
        base, ext = os.path.splitext(model_path)
        mio.save_model(base + ".ema" + ext, _host(smooth_params), config_yaml)
    if graph_group is not None:
        opt = model_path + ".optimizer.npz"
        with open(opt + ".tmp", "wb") as fh:
            np.savez(fh, **graph_group.optimizer_arrays())
        os.replace(opt + ".tmp", opt)
    if state is not None:
        state.save(model_path + ".progress.yml")
    for suffix in extra_model_suffixes:
        path = suffixed_path(model_path, suffix)
        mio.save_model(path, host_params, config_yaml)
        log.info("Saved model to {}", path)
    log.info("Saved model to {}", model_path)


def load_checkpoint(model_path: str, graph_group=None
                    ) -> Tuple[Dict[str, np.ndarray], Optional[str],
                               Optional[TrainingState]]:
    """(params as numpy, embedded config, TrainingState or None); loads
    the optimizer state into ``graph_group`` when its file exists."""
    params, config = mio.load_model(model_path)
    state = None
    if os.path.exists(model_path + ".progress.yml"):
        state = TrainingState.load(model_path + ".progress.yml")
    opt = model_path + ".optimizer.npz"
    if graph_group is not None and os.path.exists(opt):
        with np.load(opt) as z:
            graph_group.load_optimizer_arrays({k: z[k] for k in z.files})
    return params, config, state
