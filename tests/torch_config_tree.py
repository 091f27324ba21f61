"""A config tree in a JSON-able form, for holding the port's ``LazyConfig``
against JAX's (imports nothing of JAX: the refusing interpreter of
``test_torch_config.py`` runs it)."""

from pathlib import Path

from ape_tpu_torch.config import ModelTarget, target_name

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py"))


def canonical(node):
    """Targets by dotted name (the JAX package's), tuples marked, other
    leaves by repr."""
    if isinstance(node, dict):
        out = {str(k): canonical(v) for k, v in node.items() if k != "_target_"}
        if "_target_" in node:
            t = node["_target_"]
            out["_target_"] = (target_name(t) if isinstance(t, (str, ModelTarget))
                               or t.__module__.startswith("ape_tpu_torch")
                               else f"{t.__module__}.{t.__qualname__}")
        return out
    if isinstance(node, tuple):
        return {"__tuple__": [canonical(v) for v in node]}
    if isinstance(node, list):
        return [canonical(v) for v in node]
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    return repr(node)
