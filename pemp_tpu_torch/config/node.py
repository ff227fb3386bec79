"""A small config tree (after pemp_tpu.config.node): nested dicts with
attribute access and a typed merge.

A node holds a fixed set of keys: setting or merging a key it does not hold
raises ``KeyError``, unless the node was made with ``new_allowed=True``
(its child dicts then take new keys too). Merged values are coerced to the
type of the value they replace, as yacs does.
"""

from __future__ import annotations

import copy
from typing import Any


class ConfigNode(dict):
    """A dict with attribute access, a fixed key set and a typed merge."""

    _NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, self._NEW_ALLOWED, new_allowed)
        for k, v in (init or {}).items():
            super().__setitem__(k, self._convert(v))

    def _convert(self, v: Any) -> Any:
        if isinstance(v, dict) and not isinstance(v, ConfigNode):
            return ConfigNode(v, new_allowed=self.is_new_allowed())
        return v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if name not in self and not self.is_new_allowed():
            raise KeyError(f"config key {name!r} does not exist (the port does not read it)")
        super().__setitem__(name, self._convert(value))

    def is_new_allowed(self) -> bool:
        return object.__getattribute__(self, self._NEW_ALLOWED)

    def clone(self) -> "ConfigNode":
        return ConfigNode(
            {k: v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
             for k, v in self.items()},
            new_allowed=self.is_new_allowed(),
        )

    def merge_from_other(self, other: dict, prefix: str = "") -> None:
        for k, v in other.items():
            key = prefix + k
            if k not in self and not self.is_new_allowed():
                raise KeyError(f"config key {key} does not exist (the port does not read it)")
            cur = self.get(k)
            if isinstance(cur, ConfigNode) and isinstance(v, dict):
                cur.merge_from_other(v, key + ".")
            else:
                self[k] = _coerce(v, cur, key)

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }


def _coerce(new: Any, old: Any, key: str) -> Any:
    """yacs-style coercion: int to float, list to and from tuple, int to
    bool, and a plain string for a list named ``NAME``; any other change of
    type raises."""
    if old is None or new is None or type(new) is type(old):
        return new
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
        return type(old)(new)
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, (tuple, list)) and isinstance(new, str) and key.split(".")[-1] == "NAME":
        # MODEL.LOSS.NAME: the legacy loss names are plain strings
        # (pemp_tpu/config/node.py:175-180); no other list key takes one
        return new
    raise ValueError(
        f"type mismatch for key {key}: cannot replace {type(old).__name__} "
        f"with {type(new).__name__} ({new!r})"
    )
