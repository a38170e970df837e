"""Minimal YAML -> attribute-dict config system (the port's copy of
``rpeflow_tpu/train/config.py``).

The same YAML files under conf/ load unchanged. Supports attribute access,
``in`` / ``hasattr`` probing (optional keys), deep merge, and dotted-path CLI
overrides (``a.b.c=value``). ``yaml`` is imported only where a file or an
override string is parsed, so building a ``ConfigNode`` in code needs no
``yaml``.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class ConfigNode(Mapping):
    """Nested dict with attribute access (a read-mostly DictConfig stand-in)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = _wrap(v)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):  # never resolve dunders/privates via _data
            raise AttributeError(key)
        try:
            return self.__dict__["_data"][key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return ConfigNode(copy.deepcopy(self.to_dict(), memo))

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"

    # -- helpers ------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, ConfigNode) else v)
                for k, v in self._data.items()}

    def merge(self, other: "ConfigNode | dict") -> "ConfigNode":
        out = copy.deepcopy(self)
        _deep_merge(out, other)
        return out

    def set_dotted(self, path: str, value: Any) -> None:
        keys = path.split(".")
        node = self
        for k in keys[:-1]:
            if k not in node._data or not isinstance(node._data[k], ConfigNode):
                node._data[k] = ConfigNode()
            node = node._data[k]
        node._data[keys[-1]] = _wrap(_parse_value(value))


def _wrap(v: Any) -> Any:
    if isinstance(v, dict):
        return ConfigNode(v)
    if isinstance(v, ConfigNode):
        return v
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _deep_merge(dst: ConfigNode, src: "ConfigNode | dict") -> None:
    items = src.items() if isinstance(src, (dict, Mapping)) else []
    for k, v in items:
        if (k in dst._data and isinstance(dst._data[k], ConfigNode)
                and isinstance(v, (dict, Mapping))):
            _deep_merge(dst._data[k], v)
        else:
            dst._data[k] = _wrap(copy.deepcopy(v) if isinstance(v, dict) else v)


def _parse_value(v: str) -> Any:
    if not isinstance(v, str):
        return v
    import yaml

    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def load_config(path: str, overrides: list[str] | None = None) -> ConfigNode:
    """Load a YAML config file, then apply ``a.b.c=value`` overrides."""
    import yaml

    with open(path) as f:
        cfg = ConfigNode(yaml.safe_load(f))
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        cfg.set_dotted(key.strip(), value.strip())
    return cfg
