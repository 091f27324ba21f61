"""Lazy configuration system (a copy of ``ape_tpu/config/lazy.py``, whose
module imports nothing of JAX; the port keeps its own copy).

Plain-Python lazy config trees with detectron2's LazyConfig/L/instantiate
ergonomics:

    from ape_tpu.config import LazyCall as L, instantiate
    cfg.model = L(MyModel)(depth=12, width="${..embed_dim}")
    model = instantiate(cfg.model)

* ``LazyCall``/``L`` wraps a callable into a :class:`LazyNode` dict holding
  ``_target_`` plus kwargs; ``instantiate`` builds the object tree.
* ``LazyConfig.load`` executes a config .py file and collects its
  module-level names into a :class:`ConfigDict`.
* ``LazyConfig.apply_overrides`` applies ``a.b.c=value`` dotted CLI overrides.
  (JAX's ``load_rel``, ``save`` and ``to_py``, which nothing of the port
  calls, are not copied.)
* ``"${path}"`` interpolation resolves relative (``${..sibling}``) and
  absolute (``${model.embed_dim}``) references at instantiate time.

What is the port's own: the repository's config files import
``ape_tpu.config``, ``ape_tpu.data.*`` and ``ape_tpu.modeling.*``, which
need JAX, flax or PIL. ``LazyConfig.load`` executes a file with an
``__import__`` of its own (``_ConfigImporter``) that resolves those names
inside that one execution: ``ape_tpu.config`` to this package, the data
modules to the port's counterparts (``CONFIG_MODULES``), and the model
modules to placeholders (``ModelTarget``) that carry JAX's dotted name, which
``model_zoo.build_model`` reads. Any other ``ape_tpu`` name raises an
``ImportError`` naming the file and the name. Other imports go to Python's.
"""

from __future__ import annotations

import ast
import builtins as _builtins
import importlib
import os
import types
from typing import Any, Callable


class ConfigDict(dict):
    """A dict with attribute access, used for every mapping node in a config tree."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def clone(self) -> "ConfigDict":
        return _deep_copy(self)


class LazyNode(ConfigDict):
    """A deferred call: ``_target_`` plus keyword arguments."""


def _deep_copy(node: Any) -> Any:
    if isinstance(node, LazyNode):
        return LazyNode({k: _deep_copy(v) for k, v in node.items()})
    if isinstance(node, ConfigDict):
        return ConfigDict({k: _deep_copy(v) for k, v in node.items()})
    if isinstance(node, dict):
        return ConfigDict({k: _deep_copy(v) for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        t = type(node)
        return t(_deep_copy(v) for v in node)
    return node


class LazyCall:
    """``L(Class)(a=1, b=2)`` produces a LazyNode recording the deferred call."""

    def __init__(self, target: Callable):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"LazyCall target must be callable or str, got {target!r}")
        self._target = target

    def __call__(self, **kwargs: Any) -> LazyNode:
        node = LazyNode({k: _wrap(v) for k, v in kwargs.items()})
        node["_target_"] = self._target
        return node


L = LazyCall


def _wrap(value: Any) -> Any:
    """Convert plain dicts to ConfigDict recursively so attribute access works."""
    if isinstance(value, (LazyNode, ConfigDict)):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_wrap(v) for v in value)
    return value


# The JAX package's modules a config file may import, and the port's module
# that stands for each while the file executes.
CONFIG_MODULES = {
    "ape_tpu.config": "ape_tpu_torch.config",
    "ape_tpu.data.mapper": "ape_tpu_torch.data.mapper",
    "ape_tpu.data.catalog": "ape_tpu_torch.data.catalog",
    "ape_tpu.data.datasets": "ape_tpu_torch.data.datasets",
    "ape_tpu.data.datasets.metadata": "ape_tpu_torch.data.datasets.metadata",
    "ape_tpu.data.datasets.coco": "ape_tpu_torch.data.datasets.coco",
    "ape_tpu.data.datasets.builtin": "ape_tpu_torch.data.datasets.builtin",
}
# The model modules a config file may import and the names it may take from
# each: each name resolves to a ModelTarget carrying JAX's dotted name.
MODEL_MODULES = {
    "ape_tpu.modeling.ape_deta.model": ("APEDeta", "ChannelMapper"),
    "ape_tpu.modeling.ape_deta.transformer": (
        "DeformableDetrTransformer", "DeformableTransformerEncoder",
        "DeformableTransformerDecoder"),
    "ape_tpu.modeling.ape_deta.criterion": ("DeformableCriterion",),
    "ape_tpu.modeling.backbone.eva_vit": ("EVAViT", "SimpleFeaturePyramid"),
    "ape_tpu.modeling.backbone.resnet": ("ResNet",),
    "ape_tpu.modeling.build": ("build_ape_ti",),
}


class ModelTarget:
    """A config's model target: JAX's dotted name (``ape_tpu.modeling.
    ape_deta.model.APEDeta``). It builds nothing itself: the port's model
    comes from ``ape_tpu_torch.model_zoo.build_model``, which reads it."""

    def __init__(self, dotted: str):
        self.dotted = dotted
        self.__module__, _, self.__qualname__ = dotted.rpartition(".")

    def __call__(self, **kwargs):
        raise TypeError(f"{self.dotted} is a flax module: build the port's model from the "
                        "config with ape_tpu_torch.model_zoo.build_model / build_criterion")

    def __eq__(self, other):
        return isinstance(other, ModelTarget) and other.dotted == self.dotted

    def __hash__(self):
        return hash(self.dotted)

    def __repr__(self):
        return f"ModelTarget({self.dotted!r})"


def target_name(target: Any) -> str:
    """A target's dotted name, in the JAX package's terms: a ModelTarget's
    own, a port object's with ``ape_tpu_torch`` read as ``ape_tpu``."""
    if isinstance(target, str):
        return target
    if isinstance(target, ModelTarget):
        return target.dotted
    name = f"{target.__module__}.{getattr(target, '__qualname__', target)}"
    return "ape_tpu" + name[len("ape_tpu_torch"):] if name.startswith("ape_tpu_torch.") else name


class _ModelModule:
    """What ``from ape_tpu.modeling.<module> import X`` reads while a config
    executes: a ModelTarget per name the module exports."""

    def __init__(self, name: str, path: str):
        self._name, self._path = name, path

    def __getattr__(self, attr: str):
        if attr.startswith("__") or attr not in MODEL_MODULES[self._name]:
            raise ImportError(f"{self._path}: the port resolves no {self._name}.{attr}")
        return ModelTarget(f"{self._name}.{attr}")


class _ConfigImporter:
    """The ``__import__`` of one config file's execution: ``ape_tpu.*``
    names as CONFIG_MODULES and MODEL_MODULES say, anything else as Python
    imports it. Nothing is written into ``sys.modules`` under an
    ``ape_tpu`` name."""

    def __init__(self, path: str):
        self.path = path

    def resolve(self, name: str, fromlist):
        """The module ``from <name> import <fromlist>`` reads."""
        if name in CONFIG_MODULES:
            module = importlib.import_module(CONFIG_MODULES[name])
            for item in fromlist or ():
                sub = f"{name}.{item}"
                if sub in CONFIG_MODULES:
                    importlib.import_module(CONFIG_MODULES[sub])
            return module
        if name in MODEL_MODULES:
            return _ModelModule(name, self.path)
        raise ImportError(f"{self.path}: the port resolves no module {name!r} "
                          f"(config imports it can resolve: "
                          f"{sorted(CONFIG_MODULES) + sorted(MODEL_MODULES)})")

    def __call__(self, name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == "ape_tpu" or name.startswith("ape_tpu.")):
            if not fromlist:
                raise ImportError(f"{self.path}: import {name} (the port resolves the "
                                  "configs' 'from ape_tpu... import name' form only)")
            return self.resolve(name, fromlist)
        return _builtins.__import__(name, globals, locals, fromlist, level)


def _locate(name: str) -> Any:
    """Import a dotted name ``pkg.mod.Class``."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        try:
            for p in parts[i:]:
                obj = getattr(obj, p)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot locate {name!r}")


def _resolve_interp(path: str, node_stack: list) -> Any:
    """Resolve an interpolation path against the config tree.

    ``${..name}`` walks up one level per extra leading dot (one dot = current node).
    ``${a.b.c}`` resolves from the root.
    """
    root = node_stack[0]
    if path.startswith("."):
        # count leading dots: ".x" = sibling in current node, "..x" = parent's, etc.
        n = len(path) - len(path.lstrip("."))
        rest = path[n:]
        # node_stack[-1] is the node holding the interpolated value; `.x` refers to it
        base = node_stack[-n] if n <= len(node_stack) else root
    else:
        rest = path
        base = root
    cur = base
    for part in rest.split("."):
        if part == "":
            continue
        if isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def _contains_interp(value: Any) -> bool:
    return isinstance(value, str) and value.startswith("${") and value.endswith("}")


def resolve_interpolations(cfg: Any) -> Any:
    """Resolve all ``${...}`` string references in-place (returns the tree)."""

    def walk(node: Any, stack: list) -> Any:
        if isinstance(node, dict):
            for k, v in list(node.items()):
                node[k] = walk(v, stack + [node])
            return node
        if isinstance(node, list):
            for i, v in enumerate(node):
                node[i] = walk(v, stack + [node])
            return node
        if isinstance(node, tuple):
            return tuple(walk(v, stack + [list(node)]) for v in node)
        if _contains_interp(node):
            resolved = _resolve_interp(node[2:-1], stack)
            # resolved value may itself be an interpolation
            if _contains_interp(resolved):
                resolved = walk(resolved, stack)
            return resolved
        return node

    return walk(cfg, [cfg])


def instantiate(cfg: Any, _root: Any = None, _stack: list = None) -> Any:
    """Recursively build objects from a lazy config tree.

    LazyNodes become ``target(**kwargs)``; ConfigDicts/lists recurse; everything
    else passes through. Interpolations are resolved against the outermost tree
    passed to the first ``instantiate`` call.
    """
    if _root is None:
        cfg = _deep_copy(cfg)
        resolve_interpolations(cfg)
        _root = cfg
    if isinstance(cfg, LazyNode):
        target = cfg["_target_"]
        if isinstance(target, str):
            target = _locate(target)
        kwargs = {
            k: instantiate(v, _root) for k, v in cfg.items() if k != "_target_"
        }
        return target(**kwargs)
    if isinstance(cfg, dict):
        return {k: instantiate(v, _root) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [instantiate(v, _root) for v in cfg]
    if isinstance(cfg, tuple):
        return tuple(instantiate(v, _root) for v in cfg)
    return cfg


class LazyConfig:
    """Load/override/save plain-Python config files (reference: d2 LazyConfig)."""

    @staticmethod
    def load(path: str) -> ConfigDict:
        """Execute a config file and collect its public plain values. The
        file's ``ape_tpu.*`` imports resolve through ``_ConfigImporter``,
        for this one execution: nothing goes into ``sys.modules`` and no
        hook outlives the call."""
        path = os.path.abspath(path)
        if not path.endswith(".py"):
            raise ValueError(f"Config file must be .py, got {path}")
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        builtins = dict(vars(_builtins))
        builtins["__import__"] = _ConfigImporter(path)
        module = types.ModuleType("ape_tpu_torch._cfg")
        module.__file__ = path
        module.__builtins__ = builtins
        exec(code, vars(module))
        cfg = ConfigDict()
        for name in dir(module):
            if name.startswith("_"):
                continue
            value = getattr(module, name)
            if isinstance(value, (dict, list, tuple, int, float, str, bool, type(None))):
                cfg[name] = _wrap(value)
        return cfg

    @staticmethod
    def apply_overrides(cfg: ConfigDict, overrides: list) -> ConfigDict:
        """Apply ``a.b.c=value`` strings; values parsed with ast.literal_eval."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"Override must be key=value, got {ov!r}")
            key, value = ov.split("=", 1)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass  # keep as string
            node = cfg
            parts = key.split(".")
            for p in parts[:-1]:
                if isinstance(node, (list, tuple)):
                    node = node[int(p)]
                elif p not in node:
                    node[p] = ConfigDict()
                    node = node[p]
                else:
                    node = node[p]
            last = parts[-1]
            if isinstance(node, (list, tuple)):
                node[int(last)] = value
            else:
                node[last] = value
        return cfg
