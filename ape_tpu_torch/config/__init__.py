from .lazy import L, LazyCall, LazyConfig, ConfigDict, LazyNode, ModelTarget, instantiate, target_name

__all__ = ["L", "LazyCall", "LazyConfig", "ConfigDict", "LazyNode", "ModelTarget", "instantiate",
           "target_name"]
