"""``python -m ape_tpu_torch.tools.train_net`` on the tiny model with a data
mix, on the CPU, in an interpreter that refuses jax, flax, PIL and the JAX
package: a group whose records are copy-pasted (``copypaste_prob`` 0.5) and
a group of semantic label maps (``DatasetMapperSemantic``), drawn by
``dataset_ratio``; then ``--eval-only`` through the semantic and OpenImages
routes (builtin-style registrations, label PNGs)."""

import json

import numpy as np

from tests.test_torch_data import write_dataset
from tests.test_torch_runtime import TINY
from tests.test_torch_train_net import _train_net

CONFIG = """
from ape_tpu.config import L, LazyConfig
from ape_tpu.data.catalog import DatasetCatalog
from ape_tpu.data.datasets.coco import register_coco_instances, register_sem_seg
from ape_tpu.data.mapper import DatasetMapperDETR, DatasetMapperSemantic

_base = LazyConfig.load({tiny!r})
model = _base.model
criterion = _base.criterion
optimizer = _base.optimizer
train = _base.train
train.fast_dev_run.enabled = False
train.dataset_ratio = [2.0, 1.0]  # draws 0, 1, 0, 0 under seed 0
if "mix_train" not in DatasetCatalog:
    register_coco_instances("mix_train", {{}}, {root!r} + "/train.json", {root!r} + "/train")
    register_coco_instances("mix_val", {{}}, {root!r} + "/val.json",
                            {root!r} + "/val")
    register_sem_seg("mix_sem", {{"stuff_classes": ["sky", "road", "grass", "wall"]}},
                     {root!r} + "/sem_gt", {root!r} + "/sem_img")
_train = dict(is_train=True, image_size=64, max_gt=6, mask_size=16)
dataloader = dict(
    train=dict(groups=[
        dict(dataset_names=["mix_train"], batch_size=2, copypaste_prob=0.5,
             mapper=L(DatasetMapperDETR)(**_train)),
        dict(dataset_names=["mix_sem"], batch_size=2, filter_empty=False,
             mapper=L(DatasetMapperSemantic)(**_train)),
    ]),
    tests=[dict(dataset_name="mix_sem", evaluator_type="sem_seg",
                mapper=L(DatasetMapperDETR)(is_train=False, image_size=64)),
           dict(dataset_name="mix_val", evaluator_type="oid",
                mapper=L(DatasetMapperDETR)(is_train=False, image_size=64))],
)
"""


def test_mix_train_and_eval_without_jax(tmp_path):
    from ape_tpu_torch.data.image_io import write_png

    for split, seed in (("train", 0), ("val", 1)):
        js, _ = write_dataset(tmp_path / split, n=5, seed=seed)
        (tmp_path / f"{split}.json").write_text(open(js).read().replace('"file_name": "',
                                                                        '"file_name": "img/'))
    rng = np.random.RandomState(2)
    (tmp_path / "sem_gt").mkdir()
    (tmp_path / "sem_img").mkdir()
    for i in range(4):  # the images as PNG bytes under the loader's .jpg names
        h, w = (40, 56) if i % 2 else (56, 40)
        write_png(str(tmp_path / "sem_img" / f"{i}.jpg"),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        labels = rng.randint(0, 4, (h, w)).astype(np.uint8)
        labels[: h // 4] = 255
        write_png(str(tmp_path / "sem_gt" / f"{i}.png"), labels)
    cfg = tmp_path / "mix.py"
    cfg.write_text(CONFIG.format(tiny=str(TINY), root=str(tmp_path)))
    out = tmp_path / "out"
    _train_net("--config-file", str(cfg), "train.device=cpu", f"train.output_dir={out}",
               "train.log_period=1", "train.checkpoint_period=100", "train.eval_period=0",
               "train.max_iter=4")
    rows = [json.loads(line) for line in open(out / "metrics.json")]
    assert len(rows) == 4 and all(np.isfinite(r["total_loss"]) for r in rows)
    drawn = [int(r["dataset_id"]) for r in rows]
    assert set(drawn) == {0, 1}, drawn
    assert sum(r["count_copypaste"] for r, d in zip(rows, drawn) if d == 0) > 0
    log = _train_net("--eval-only", "--config-file", str(cfg), "train.device=cpu",
                     f"train.output_dir={out}", f"train.init_checkpoint={out / 'model_final.pth'}",
                     "language.width=64", "language.heads=2", "language.layers=1")
    sem = [ln for ln in log.splitlines() if "mix_sem: {" in ln][-1]
    for key in ("sem_seg/mIoU", "sem_seg/pACC", "seconds/device", "seconds/postprocess"):
        assert f"'{key}'" in sem
    assert "'images': 4" in sem and "'scored': 4" in sem
    oid = [ln for ln in log.splitlines() if "mix_val: {" in ln][-1]
    assert "'bbox/AP'" in oid and "'images': 5" in oid


def test_new_modules_import_without_jax_or_pil(tmp_path):
    """The slice's modules in an interpreter that refuses jax, flax, PIL,
    cv2 and the JAX package: each imports, and the blur, the label-map read
    and the components run once."""
    import subprocess
    import sys
    import textwrap

    from tests.torch_config_tree import ROOT

    code = textwrap.dedent(f"""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("PIL", "cv2", "jax", "jaxlib", "flax", "ape_tpu"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from ape_tpu_torch.data import copypaste, mapper, mapper_panoptic
        from ape_tpu_torch.data.datasets import builtin, metadata
        from ape_tpu_torch.data.image_io import read_label_map, write_png
        from ape_tpu_torch.evaluation import d3_eval, eval_runner, oid_eval, unified_eval
        x = (np.random.RandomState(0).rand(20, 30) > 0.5).astype(np.uint8)
        write_png({str(tmp_path / "m.png")!r}, x)
        comps = mapper_panoptic.connected_components(read_label_map({str(tmp_path / "m.png")!r}) > 0)
        blur = copypaste.gaussian_blur(x * 255, 5.0)
        print(len(comps), blur.shape, len(metadata.fed_loss_cls_weights("oid")),
              len(builtin.ODINW_13_TEST))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["601", "13"]
