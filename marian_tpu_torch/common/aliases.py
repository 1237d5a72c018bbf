"""Task aliases, a copy of ``marian_tpu/common/aliases.py`` (reference
src/common/aliases.cpp, ``--task transformer-base`` etc.): one flag
expands to a canonical hyperparameter bundle, the well-known
transformer-base and transformer-big recipes and their pre-norm forms.
The parser layers it as the reference does: the bundle overrides the
config files' values, and the command line overrides the bundle.
"""

from __future__ import annotations

from typing import Any, Dict

_TRANSFORMER_BASE: Dict[str, Any] = {
    "type": "transformer",
    "enc-depth": 6,
    "dec-depth": 6,
    "dim-emb": 512,
    "transformer-dim-ffn": 2048,
    "transformer-heads": 8,
    "transformer-postprocess": "dan",
    "transformer-preprocess": "",
    "transformer-ffn-activation": "relu",
    "transformer-dropout": 0.1,
    "transformer-dropout-attention": 0.0,
    "transformer-dropout-ffn": 0.0,
    "label-smoothing": 0.1,
    "clip-norm": 0.0,
    "learn-rate": 0.0003,
    "lr-warmup": "16000",
    "lr-decay-inv-sqrt": ["16000"],
    "lr-report": True,
    "optimizer-params": [0.9, 0.98, 1e-09],
    "cost-type": "ce-mean-words",
    "tied-embeddings-all": True,
    "sync-sgd": True,
    "exponential-smoothing": 0.0001,
    "max-length": 100,
    "mini-batch-fit": True,
    "mini-batch": 1000,
    "maxi-batch": 1000,
    "beam-size": 8,
    "valid-mini-batch": 16,
    "normalize": 1.0,
}

_TRANSFORMER_BIG: Dict[str, Any] = dict(
    _TRANSFORMER_BASE,
    **{
        "dim-emb": 1024,
        "transformer-dim-ffn": 4096,
        "transformer-heads": 16,
        "transformer-dropout": 0.1,
        "learn-rate": 0.0002,
        "lr-warmup": "8000",
        "lr-decay-inv-sqrt": ["8000"],
    },
)


def _prenorm(base: Dict[str, Any]) -> Dict[str, Any]:
    return dict(base, **{
        "transformer-preprocess": "n",
        "transformer-postprocess": "da",
        "transformer-postprocess-top": "n",
    })


ALIASES: Dict[str, Dict[str, Any]] = {
    "transformer-base": _TRANSFORMER_BASE,
    "transformer-big": _TRANSFORMER_BIG,
    "transformer-base-prenorm": _prenorm(_TRANSFORMER_BASE),
    "transformer-big-prenorm": _prenorm(_TRANSFORMER_BIG),
}


def expand_aliases(task: str, merged: Dict[str, Any]) -> Dict[str, Any]:
    """``merged`` with the bundle of ``task`` laid over it (the caller
    lays the command line over the result)."""
    if task not in ALIASES:
        raise SystemExit(
            f"Unknown --task '{task}'; known: {', '.join(sorted(ALIASES))}")
    out = dict(merged)
    out.update(ALIASES[task])
    return out
