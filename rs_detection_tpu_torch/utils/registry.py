"""String -> class registries and config-driven builders (the port's own
copy of ``rs_detection_tpu/utils/registry.py``): a named mapping from
type strings to callables, and ``build_from_cfg``, which instantiates
from a ``{"type": name, **kwargs}`` dict. The port's registries are its
own instances, filled by the port's modules as they are imported."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional


class Registry:
    """A registry mapping type names to classes/callables."""

    def __init__(self, name: str):
        self._name = name
        self._modules: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def modules(self) -> Dict[str, Callable]:
        return self._modules

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._modules)})"

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"'{key}' is not registered in registry '{self._name}'. "
                f"Available: {sorted(self._modules)}"
            )
        return self._modules[key]

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Register a module class. Usable as decorator (with or without name)."""
        if module is not None:
            self._register(module, name)
            return module

        def _decorator(cls):
            self._register(cls, name)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str]):
        key = name if name is not None else module.__name__
        if key in self._modules and self._modules[key] is not module:
            raise KeyError(f"'{key}' already registered in '{self._name}'")
        self._modules[key] = module


def build_from_cfg(cfg: Any, registry: Registry, **default_args) -> Any:
    """Instantiate an object from a config.

    - ``None`` -> ``None``
    - string -> look up name and call with ``default_args``
    - dict with ``type`` -> pop type, instantiate with remaining keys
    - list -> list of built objects
    - anything already instantiated is passed through
    """
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        return [build_from_cfg(c, registry, **default_args) for c in cfg]
    if isinstance(cfg, str):
        return registry.get(cfg)(**default_args)
    if isinstance(cfg, dict):
        args = copy.deepcopy(dict(cfg))
        if "type" not in args:
            raise KeyError(f"cfg dict must contain 'type': {cfg}")
        obj_type = args.pop("type")
        cls = registry.get(obj_type) if isinstance(obj_type, str) else obj_type
        for k, v in default_args.items():
            args.setdefault(k, v)
        return cls(**args)
    # already-built object
    return cfg


MODELS = Registry("models")
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
ROI_EXTRACTORS = Registry("roi_extractors")
BOXES = Registry("boxes")
DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")
OPTIMS = Registry("optims")
SCHEDULERS = Registry("schedulers")
HOOKS = Registry("hooks")
LOSSES = Registry("losses")
BRICKS = Registry("bricks")
SHARED_HEADS = Registry("shared_heads")
