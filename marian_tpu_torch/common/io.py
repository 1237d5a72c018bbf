"""Model IO for ``.npz`` checkpoints (Marian-compatible). A numpy-only
copy of the ``.npz`` part of ``marian_tpu/common/io.py``, so one
checkpoint file serves both packages.

Conventions kept from upstream Marian (reference src/common/io.cpp):

- a checkpoint is a set of named tensors ("items");
- the model config travels inside the checkpoint as a special int8 tensor
  named ``special:model.yml`` holding the YAML text (NUL-terminated).

Weights stay numpy here; ``convert.params_from_numpy`` makes tensors.
``save_yaml``/``load_yaml`` keep the trainer's progress file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import yaml

SPECIAL_CONFIG_KEY = "special:model.yml"


def config_to_array(config_yaml: str) -> np.ndarray:
    """Marian stores the config as int8 bytes incl. trailing NUL."""
    raw = config_yaml.encode("utf-8") + b"\x00"
    return np.frombuffer(raw, dtype=np.int8).copy()


def array_to_config(arr: np.ndarray) -> str:
    return arr.astype(np.int8).tobytes().rstrip(b"\x00").decode("utf-8")


def load_model(path: str):
    """Returns (params: dict name->ndarray, config_yaml: Optional[str])."""
    params: Dict[str, np.ndarray] = {}
    config: Optional[str] = None
    with np.load(path, allow_pickle=False) as npz:
        for name in npz.files:
            if name == SPECIAL_CONFIG_KEY:
                config = array_to_config(npz[name])
            else:
                params[name] = npz[name]
    return params, config


def save_model(path: str, params: Dict[str, np.ndarray],
               config_yaml: Optional[str] = None) -> None:
    """Write atomically (temp file + rename), so an interrupted save never
    corrupts the previous checkpoint."""
    arrays = {k: np.asarray(v) for k, v in sorted(params.items())}
    if config_yaml is not None:
        arrays[SPECIAL_CONFIG_KEY] = config_to_array(config_yaml)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh) or {}


def save_yaml(path: str, data: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        yaml.safe_dump(data, fh, default_flow_style=False, sort_keys=False)
    os.replace(tmp, path)
