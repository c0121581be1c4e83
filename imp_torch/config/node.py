"""A minimal yacs-compatible config node.

The reference uses yacs (``medmm/config/defaults.py:1``); yacs is not in this
image, so this is a small reimplementation of the subset the framework needs:
attribute access, clone, freeze/defrost, merge_from_file / merge_from_list /
merge_from_other_cfg with type checking, and the one quirk the reference
relies on — a key whose default is ``None`` may be replaced by any type
(used by ``MODEL.FUSION``, reference ``medmm/config/defaults.py:141-144``).

PyYAML is imported only by the three functions that parse or emit YAML
(``merge_from_file``, ``dump`` and ``_decode_value``): a serving host that
sets typed values and stores the config as JSON (``to_dict``) needs none,
and without it ``merge_from_list`` reads command-line values as Python
literals.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

_VALID_SCALARS = (int, float, bool, str, type(None), tuple, list)


class CfgNode(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access --------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key '{name}' not found")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        dict.__setitem__(self, name, value)

    # -- immutability -------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- cloning / merging ---------------------------------------------------
    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Expected key-value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))

    def _merge_dict(self, other: Dict[str, Any], path: List[str]) -> None:
        for k, v in other.items():
            full = ".".join(path + [str(k)])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode) and isinstance(v, dict):
                cur._merge_dict(v, path + [str(k)])
            else:
                dict.__setitem__(self, k, _coerce(v, cur, full))

    # -- misc ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def __str__(self) -> str:
        def _fmt(node: "CfgNode", indent: int) -> str:
            lines = []
            for k in sorted(node.keys()):
                v = node[k]
                if isinstance(v, CfgNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.append(_fmt(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v}")
            return "\n".join(lines)

        return _fmt(self, 0)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CfgNode({dict.__repr__(self)})"


def _decode_value(value: str) -> Any:
    """A command-line value: parsed as YAML, as the JAX package does; on a
    host without PyYAML, as a Python literal (yacs' rule), else the string."""
    try:
        import yaml
    except ImportError:
        import ast

        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Type-check a replacement value against the default (yacs semantics)."""
    if isinstance(new, dict) and not isinstance(new, CfgNode):
        new = CfgNode(new)
    if isinstance(new, str) and not isinstance(old, str):
        # YAML 1.1 reads '2e-4' (no dot) as a string; yacs recovers via
        # literal_eval — do the same so reference YAMLs load unchanged
        import ast

        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if old is None or new is None:
        # a None default accepts any type (the MODEL.FUSION quirk)
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, bool) is not isinstance(new, bool) and (
        isinstance(old, bool) or isinstance(new, bool)
    ):
        raise ValueError(f"Type mismatch for key {key}: bool vs {type(new)}")
    if not isinstance(new, type(old)) and not isinstance(old, type(new)):
        raise ValueError(
            f"Type mismatch for key {key}: expected {type(old).__name__}, "
            f"got {type(new).__name__} ({new!r})"
        )
    return new
