"""Minimal yacs-compatible config node (the port's own copy of
``procedurevrl_tpu/config/cfg_node.py``).

The reference uses fvcore/yacs ``CfgNode`` (see reference
``lib/config/defaults.py:8`` and ``lib/utils/parser.py:66-93``); neither
library is a dependency here, so this is a small clean-room implementation of
the same public surface: attribute access, ``clone()``, ``merge_from_file``
(YAML overlay), ``merge_from_list`` (``KEY.SUBKEY value`` CLI pairs), and
``dump()``.  Unknown keys in an overlay raise ``KeyError`` to catch config
typos early, matching yacs behavior.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List

import yaml


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-style merging."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # ---- merging -----------------------------------------------------------

    def merge_from_other_cfg(self, other: dict, _path: str = "") -> None:
        for key, value in other.items():
            full = f"{_path}.{key}" if _path else key
            if key not in self:
                raise KeyError(f"Non-existent config key: {full}")
            current = self[key]
            if isinstance(current, CfgNode):
                if not isinstance(value, dict):
                    raise TypeError(f"Cannot overwrite config group {full} with a scalar")
                current.merge_from_other_cfg(value, full)
            else:
                # yacs literal-evals strings from YAML too, so "(3, 7, 7)" in a
                # YAML file becomes a tuple (reference MViT configs rely on it).
                if isinstance(value, str) and not isinstance(current, str):
                    value = _parse_literal(value)
                self[key] = _coerce(value, current, full)

    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self.merge_from_other_cfg(loaded)

    def merge_from_list(self, opts: List[str]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node[part], CfgNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[part]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(_parse_literal(raw), node[leaf], key)

    # ---- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
            for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CfgNode":
        node = cls()
        for k, v in d.items():
            node[k] = cls.from_dict(v) if isinstance(v, dict) else copy.deepcopy(v)
        return node


def _parse_literal(raw: Any) -> Any:
    """Parse a CLI string into a Python literal when possible (yacs semantics)."""
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _coerce(value: Any, current: Any, key: str) -> Any:
    """Coerce ``value`` toward the type of the default, with yacs-like leniency."""
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        raise TypeError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(current, float) and isinstance(value, int):
        return float(value)
    if isinstance(current, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(current, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(current) is not type(value) and not (
        isinstance(current, str) and isinstance(value, str)
    ):
        # permit numeric/str flexibility like yacs for a handful of keys
        if isinstance(current, (int, float)) and isinstance(value, (int, float)):
            return value
        if isinstance(current, str) or isinstance(value, str):
            return value
        raise TypeError(
            f"Type mismatch for key {key}: default {type(current).__name__}, "
            f"got {type(value).__name__}"
        )
    return value
