"""Global config system (the port's own copy of
``rs_detection_tpu/config/config.py``): attribute-style dict config,
``.py`` / ``.yaml`` file loading, ``_base_`` multi-inheritance with
recursive priority merge, a ``_cover_`` key that replaces (rather than
merges) a subtree, and a process-global singleton with
``init_cfg/get_cfg/update_cfg/save_cfg``.

``.py`` configs are executed with ``runpy`` in an isolated namespace.
PyYAML is imported only where a ``.yaml`` config is read: ``save_cfg``
and ``print_cfg`` write JSON, which YAML readers accept.
"""

from __future__ import annotations

import copy
import inspect
import json
import os
import runpy
from typing import Any, Dict, Union

BASE_KEY = "_base_"
COVER_KEY = "_cover_"

__all__ = [
    "Config",
    "init_cfg",
    "get_cfg",
    "update_cfg",
    "save_cfg",
    "print_cfg",
]


def _load_raw(filename: str) -> Dict[str, Any]:
    """Load a single config file (no ``_base_`` resolution) into a dict."""
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    ext = os.path.splitext(filename)[1]
    if ext in (".yaml", ".yml"):
        import yaml

        with open(filename, "r") as f:
            out = yaml.safe_load(f.read())
        return out or {}
    if ext == ".py":
        ns = runpy.run_path(filename)
        return {
            k: v
            for k, v in ns.items()
            if not k.startswith("__") and not inspect.ismodule(v)
        }
    raise ValueError(f"unsupported config extension: {filename}")


def _strip_cover(node: Any) -> Any:
    """Deep-copy a value, dropping every ``_cover_`` marker key."""
    if isinstance(node, dict):
        return {k: _strip_cover(v) for k, v in node.items() if k != COVER_KEY}
    if isinstance(node, list):
        return [_strip_cover(v) for v in node]
    return copy.deepcopy(node)


def merge_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Merge ``src`` into ``dst`` in place; ``src`` wins.

    A dict carrying ``_cover_: True`` replaces the destination subtree
    wholesale instead of being merged key-by-key.
    """
    if COVER_KEY in src:
        dst.clear()
        dst.update(_strip_cover(src))
        return
    for key, val in src.items():
        mergeable = (
            key in dst
            and isinstance(dst.get(key), dict)
            and isinstance(val, dict)
            and not val.get(COVER_KEY, False)
        )
        if mergeable:
            merge_into(dst[key], val)
        else:
            dst[key] = _strip_cover(val)


def _resolve(filename: str) -> Dict[str, Any]:
    """Load a config file, recursively resolving its ``_base_`` chain."""
    cfg = _load_raw(filename)
    bases = cfg.pop(BASE_KEY, None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    here = os.path.dirname(filename)
    merged: Dict[str, Any] = {}
    for base in bases:
        merge_into(merged, _resolve(os.path.join(here, base)))
    merge_into(merged, cfg)
    return merged


class Config(dict):
    """dict with attribute access; missing attributes read as ``None``."""

    def __init__(self, filename: Union[str, None] = None, **kwargs):
        super().__init__()
        if kwargs:
            self.update({k: self._wrap(v) for k, v in kwargs.items()})
        if filename is not None:
            self.load_from_file(filename)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        return self.get(name, None)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        out = Config()
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    @classmethod
    def _wrap(cls, node: Any) -> Any:
        if isinstance(node, dict) and not isinstance(node, Config):
            out = cls()
            for k, v in node.items():
                out[k] = cls._wrap(v)
            return out
        if isinstance(node, list):
            return [cls._wrap(v) for v in node]
        return node

    def load_from_file(self, filename: str) -> "Config":
        data = _resolve(filename)
        self.clear()
        for k, v in data.items():
            self[k] = self._wrap(v)
        if self.name is None:
            self.name = os.path.splitext(os.path.basename(filename))[0]
        if self.work_dir is None:
            self.work_dir = os.path.join("work_dirs", self.name)
        return self

    def dump(self) -> Dict[str, Any]:
        """Convert back to plain nested dicts and lists."""

        def unwrap(node):
            if isinstance(node, dict):
                return {k: unwrap(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [unwrap(v) for v in node]
            return node

        return unwrap(self)


_cfg = Config()


def init_cfg(filename: str) -> Config:
    _cfg.load_from_file(filename)
    return _cfg


def get_cfg() -> Config:
    return _cfg


def update_cfg(args: Dict[str, Any]) -> None:
    _cfg.update({k: Config._wrap(v) for k, v in dict(args).items()})


def _dumps(cfg: Config) -> str:
    # values JSON has no form for (a dtype object, a callable) as their repr
    return json.dumps(cfg.dump(), indent=2, default=repr) + "\n"


def save_cfg(save_file: str) -> None:
    with open(save_file, "w") as f:
        f.write(_dumps(_cfg))


def print_cfg() -> None:
    print(_dumps(_cfg), end="")
