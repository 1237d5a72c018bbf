"""Type-flexible options store, Marian's ``Options`` (reference:
src/common/options.h :: Options::get<T>/has/with). A copy of
``marian_tpu/common/options.py``; the port imports nothing of the JAX
package.

Marian passes a YAML-node-backed, type-erased dictionary through every layer of
the stack. We keep the same UX (one object, dotted flag names with dashes,
``get``/``has``/``with`` API) but back it with a plain dict — idiomatic Python,
trivially picklable into checkpoints (Marian embeds the config as the
``special:model.yml`` tensor; we do the same in io.py).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Optional

import yaml


class Options:
    """Immutable-by-convention key-value store for all configuration.

    Keys are Marian-style flag names with dashes (``mini-batch-words``).
    Values are plain Python scalars / lists / dicts.
    """

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kwargs: Any):
        self._data: Dict[str, Any] = dict(data or {})
        if kwargs:
            # allow Options(foo_bar=1) → "foo-bar"
            for k, v in kwargs.items():
                self._data[k.replace("_", "-")] = v

    # -- core API (mirrors Options::get<T>, Options::has) ------------------
    def get(self, key: str, default: Any = ...) -> Any:
        key = key.replace("_", "-")
        if key in self._data:
            return self._data[key]
        if default is ...:
            raise KeyError(f"Required option '{key}' is not set")
        return default

    def has(self, key: str) -> bool:
        return key.replace("_", "-") in self._data

    def nonempty(self, key: str) -> bool:
        """True if set and truthy (Marian: has() && !get().empty())."""
        key = key.replace("_", "-")
        v = self._data.get(key)
        return bool(v)

    def set(self, key: str, value: Any) -> None:
        self._data[key.replace("_", "-")] = value

    def with_(self, *updates: Dict[str, Any], **kwargs: Any) -> "Options":
        """Return a copy with updates applied (Marian: options->with(...))."""
        new = copy.deepcopy(self._data)
        for upd in updates:
            for k, v in upd.items():
                new[k.replace("_", "-")] = v
        for k, v in kwargs.items():
            new[k.replace("_", "-")] = v
        return Options(new)

    def clone(self) -> "Options":
        return Options(copy.deepcopy(self._data))

    # -- dict-ish conveniences ---------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def items(self):
        return self._data.items()

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    # -- YAML round-trip (Marian: options->asYamlString, cloneFromYaml) ----
    def as_yaml(self) -> str:
        return yaml.safe_dump(self._data, default_flow_style=False, sort_keys=True)

    @classmethod
    def from_yaml(cls, text: str) -> "Options":
        data = yaml.safe_load(text) or {}
        if not isinstance(data, dict):
            raise ValueError("Top-level YAML config must be a mapping")
        return cls(data)

    def __repr__(self) -> str:
        return f"Options({len(self._data)} keys)"
