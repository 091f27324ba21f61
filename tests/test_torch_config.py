"""The port's config system (``ape_tpu_torch.config``) against JAX's.

Every config file of the repository loads through the port's
``LazyConfig`` in an interpreter that refuses jax, flax, PIL and the JAX
package, into the tree JAX's ``LazyConfig.load`` gives (targets compared by
their dotted names, the port's read in the JAX package's terms); JAX's
``tests/test_config.py`` cases run on the port's copy; a load leaves no
``ape_tpu`` alias in ``sys.modules`` and no hook behind.
"""

import builtins
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ape_tpu.config import LazyConfig as JLazyConfig
from ape_tpu_torch.config import (
    ConfigDict,
    L,
    LazyConfig,
    LazyNode,
    ModelTarget,
    instantiate,
    target_name,
)
from tests.test_config import Leaf, Node
from tests.torch_config_tree import CONFIGS, ROOT, canonical

REFUSE = textwrap.dedent("""
    import sys
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "ape_tpu"):
                raise ImportError("refused: " + name)
    sys.meta_path.insert(0, Refuse())
""")


@pytest.fixture(scope="module")
def port_trees():
    """Every config loaded by the port in a fresh interpreter that refuses
    jax, flax, PIL and ape_tpu: {file: canonical tree or the error}."""
    code = REFUSE + textwrap.dedent("""
        import json
        from tests.torch_config_tree import canonical, CONFIGS
        from ape_tpu_torch.config import LazyConfig
        out = {}
        for f in CONFIGS:
            try:
                out[f] = canonical(LazyConfig.load(f))
            except Exception as e:
                out[f] = {"__error__": f"{type(e).__name__}: {e}"}
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "PIL", "ape_tpu"))
        print(json.dumps({"trees": out, "leaked": leaked}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_every_config_loads_without_jax(port_trees):
    errors = {f: t["__error__"] for f, t in port_trees["trees"].items() if "__error__" in t}
    assert len(port_trees["trees"]) == len(CONFIGS) > 300
    assert errors == {}
    assert port_trees["leaked"] == []


@pytest.mark.parametrize("chunk", range(4))
def test_trees_equal_jax(port_trees, chunk):
    """Each file's tree equals JAX's, targets by dotted name (a quarter of
    the files a case)."""
    files = CONFIGS[chunk::4]
    differ = [f for f in files
              if json.loads(json.dumps(canonical(JLazyConfig.load(str(ROOT / f)))))
              != port_trees["trees"][f]]
    assert differ == []


def test_model_targets_carry_jax_names():
    cfg = LazyConfig.load(str(ROOT / "configs/tests/ape_deta_tiny.py"))
    assert cfg.model["_target_"] == ModelTarget("ape_tpu.modeling.ape_deta.model.APEDeta")
    assert target_name(cfg.model.backbone.net["_target_"]) == \
        "ape_tpu.modeling.backbone.eva_vit.EVAViT"
    with pytest.raises(TypeError, match="build_model"):
        instantiate(cfg.model)
    data = LazyConfig.load(str(ROOT / "configs/common/data/coco.py"))
    mapper = instantiate(data.dataloader.train.mapper)
    assert type(mapper).__module__ == "ape_tpu_torch.data.mapper"


def test_load_leaves_no_alias_and_no_hook(tmp_path):
    before = set(sys.modules)
    imp = builtins.__import__
    LazyConfig.load(str(ROOT / "configs/COCO_InstanceSegmentation/ape_deta/"
                               "ape_deta_vitt_eva02_lsj1024_12ep.py"))
    new = set(sys.modules) - before
    assert not [m for m in new if m == "ape_tpu" or m.startswith(("ape_tpu.", "ape_tpu_torch._cfg"))]
    assert builtins.__import__ is imp
    bad = tmp_path / "bad.py"
    bad.write_text("from ape_tpu.engine.trainer import Trainer\n")
    with pytest.raises(ImportError, match="bad.py.*ape_tpu.engine.trainer"):
        LazyConfig.load(str(bad))
    bad.write_text("from ape_tpu.modeling.ape_deta.model import Nothing\n")
    with pytest.raises(ImportError, match="Nothing"):
        LazyConfig.load(str(bad))
    assert builtins.__import__ is imp


# --- JAX's tests/test_config.py, on the port's copy -------------------------

def test_instantiate_nested():
    cfg = L(Node)(child=L(Leaf)(x=3, name="a"), scale=2.0, tags=[L(Leaf)(x=1)])
    obj = instantiate(cfg)
    assert isinstance(obj, Node) and isinstance(obj.child, Leaf)
    assert obj.child.x == 3 and obj.scale == 2.0
    assert isinstance(obj.tags[0], Leaf) and obj.tags[0].x == 1
    assert isinstance(cfg, LazyNode)


def test_interpolation_relative_and_absolute():
    cfg = ConfigDict(dim=256, model=L(Node)(child=L(Leaf)(x="${dim}", name="leaf"),
                                            scale="${.child.x}"))
    obj = instantiate(cfg)["model"]
    assert obj.child.x == 256
    assert obj.scale == 256


def test_apply_overrides():
    cfg = ConfigDict(model=L(Node)(child=L(Leaf)(x=1), scale=1.0), train=ConfigDict(iters=10))
    LazyConfig.apply_overrides(
        cfg, ["model.child.x=42", "train.iters=99", "train.name=hello", "model.scale=0.5"])
    assert cfg.model.child.x == 42
    assert cfg.train.iters == 99
    assert cfg.train.name == "hello"
    obj = instantiate(cfg.model)
    assert obj.child.x == 42 and obj.scale == 0.5


def test_load_config_file(tmp_path):
    p = tmp_path / "cfg_a.py"
    p.write_text(textwrap.dedent("""
        from ape_tpu.config import L
        from tests.test_config import Leaf, Node

        dim = 8
        model = L(Node)(child=L(Leaf)(x="${dim}"), scale=3.0)
        train = dict(max_iter=100)
    """))
    cfg = LazyConfig.load(str(p))
    assert cfg.train.max_iter == 100
    assert instantiate(cfg)["model"].child.x == 8


def test_config_inheritance(tmp_path):
    base = tmp_path / "base.py"
    base.write_text("from ape_tpu.config import L\n"
                    "from tests.test_config import Leaf\n"
                    "model = L(Leaf)(x=5, name='base')\n"
                    "train = dict(lr=0.1)\n")
    child = tmp_path / "child.py"
    child.write_text("from ape_tpu.config import LazyConfig\n"
                     f"_base = LazyConfig.load({str(base)!r})\n"
                     "model = _base.model\n"
                     "train = _base.train\n"
                     "model.x = 7\n")
    cfg = LazyConfig.load(str(child))
    assert instantiate(cfg.model).x == 7
    assert cfg.train.lr == 0.1
