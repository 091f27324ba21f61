"""The port's dataset tables and registrations against JAX's: every function
of ``metadata`` (the federated loss's weights too: F10, where the port
raised for every name but LVIS's), the whole ``MetadataCatalog`` after
``register_metadata``, ``register_all`` on a temporary layout (the same
names and the same ``DatasetCatalog`` dicts), ``load_sem_seg`` and
``load_coco_panoptic``, and the ten criteria of APE-Ti's flagship mix config
built on the CPU. Each test runs on empty catalogs of both packages and
puts the old ones back (``fresh_catalogs``)."""

import json
import os

import numpy as np
import pytest

from ape_tpu.data import catalog as j_catalog
from ape_tpu.data.datasets import builtin as j_builtin
from ape_tpu.data.datasets import coco as j_coco
from ape_tpu.data.datasets import metadata as j_metadata
from ape_tpu_torch.data import catalog
from ape_tpu_torch.data.datasets import builtin, coco, metadata
from ape_tpu_torch.data.image_io import write_png
from tests.torch_config_tree import ROOT

MIX = ROOT / ("configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
              "ape_deta/ape_deta_vitt_eva02_vlf_lsj1024_cp_16x4_1080k.py")


@pytest.fixture
def fresh_catalogs():
    """Empty dataset and metadata catalogs in both packages for the test."""
    saved = [(c, c._registry) for c in (catalog.DatasetCatalog, catalog.MetadataCatalog,
                                        j_catalog.DatasetCatalog, j_catalog.MetadataCatalog)]
    for c, _ in saved:
        c._registry = {}
    yield
    for c, reg in saved:
        c._registry = reg


@pytest.mark.parametrize("dataset", ["lvis_v1_train", "openimages_v6", "oid", "o365", "gqa"])
def test_fed_loss_weights_equal_jax(dataset):
    """F10: OpenImages v6's counts for ``openimages*`` and ``oid*``, None for
    a dataset without a table, LVIS's for ``lvis*``, as JAX gives them."""
    assert metadata.category_image_counts(dataset) == j_metadata.category_image_counts(dataset)
    assert metadata.fed_loss_cls_weights(dataset) == j_metadata.fed_loss_cls_weights(dataset)
    assert metadata.fed_loss_cls_weights(dataset, 0.3) == \
        j_metadata.fed_loss_cls_weights(dataset, 0.3)


def test_metadata_tables_equal_jax():
    for fn in ("odinw_categories", "odinw_prompts", "odinw_splits", "seginw_categories",
               "seginw_splits", "objects365_splits", "oid_splits", "d3_splits"):
        assert getattr(metadata, fn)() == getattr(j_metadata, fn)(), fn
    for fix in (True, False):
        assert metadata.objects365_categories(fix) == j_metadata.objects365_categories(fix)
    for version in ("2019", "v6", "seg"):
        assert metadata.oid_categories(version) == j_metadata.oid_categories(version)
    for ds in j_metadata._load("inst_categories.json"):
        assert metadata.inst_categories(ds) == j_metadata.inst_categories(ds)
    for ds in j_metadata.odinw_categories():
        assert metadata.thing_classes_with_prompts(ds) == j_metadata.thing_classes_with_prompts(ds)
    for name in os.listdir(ROOT / "ape_tpu" / "data" / "datasets" / "assets"):
        assert metadata._load(name) == j_metadata._load(name), name


def _catalog_state(meta_catalog):
    return {n: {k: v for k, v in m.as_dict().items() if k != "name"}
            for n, m in meta_catalog._registry.items()}


def test_register_metadata_equals_jax(fresh_catalogs):
    builtin.register_metadata()
    j_builtin.register_metadata()
    got, want = _catalog_state(catalog.MetadataCatalog), _catalog_state(j_catalog.MetadataCatalog)
    assert sorted(got) == sorted(want) and len(got) > 200
    for name in want:
        assert got[name] == want[name], name
    assert builtin.ODINW_13_TEST == j_builtin.ODINW_13_TEST


def _write_json(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def write_layout(root, seed=0):
    """Annotation files (and a few images) for a sample of every kind of
    builtin: COCO-style (COCO, LVIS, the mix's groups, Objects365, OID,
    D-cube, ODinW, SegInW, Roboflow-100), panoptic and semantic."""
    rng = np.random.RandomState(seed)

    def coco_json(n_img=2, n_cat=3):
        images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": 20, "width": 30}
                  for i in range(n_img)]
        anns = [{"id": k + 1, "image_id": 1 + k % n_img, "category_id": 1 + k % n_cat,
                 "bbox": [float(v) for v in rng.uniform(0, 10, 4)], "iscrowd": 0,
                 "segmentation": [[1.0, 1.0, 8.0, 1.0, 8.0, 9.0]], "phrase": f"thing {k}"}
                for k in range(4)]
        return {"images": images, "annotations": anns,
                "categories": [{"id": c + 1, "name": f"c{c}"} for c in range(n_cat)]}

    rels = [spec[0] for spec in builtin._COCO_STYLE.values()][::3]
    rels += [spec[1] for spec in list(metadata.objects365_splits().values())[:2]]
    rels += [spec[1] for table in metadata.oid_splits().values() for spec in list(table.values())[:1]]
    d3 = next(iter(metadata.d3_splits().values()))
    rels.append(next(iter(d3.values()))[1]["FULL"])
    rels += [spec[1] for spec in list(next(iter(metadata.odinw_splits().values())).values())[:2]]
    split, base, ann = next(iter(metadata.seginw_splits().values()))
    rels.append(os.path.join(base, split, ann))
    rels.append(os.path.join("rf100", "aquarium", "test", "_annotations.coco.json"))
    for rel in rels:
        _write_json(root / rel, coco_json())
    for name, (json_rel, img_rel, pan_rel) in list(builtin._PANOPTIC.items())[:3]:
        _write_json(root / json_rel, {
            "images": [{"id": 1, "file_name": "a.jpg", "height": 8, "width": 6}],
            "annotations": [{"image_id": 1, "file_name": "a.png",
                             "segments_info": [{"id": 5, "category_id": 2, "isthing": 1}]},
                            {"image_id": 9, "file_name": "orphan.png", "segments_info": []}],
            "categories": [{"id": 2, "name": "x"}]})
    for gt_rel, img_rel in list(builtin._SEM_SEG.values())[:4]:
        os.makedirs(root / gt_rel, exist_ok=True)
        for i in range(2):
            write_png(str(root / gt_rel / f"im{i}.png"),
                      rng.randint(0, 4, (6, 5)).astype(np.uint8))
    return rels


def test_register_all_equals_jax(fresh_catalogs, tmp_path):
    """The same names registered, each loading the same dicts (and the same
    metadata after the loads)."""
    write_layout(tmp_path)
    n = builtin.register_all(str(tmp_path))
    j_n = j_builtin.register_all(str(tmp_path))
    assert n == j_n and n > 20
    assert catalog.DatasetCatalog.list() == j_catalog.DatasetCatalog.list()
    for name in j_catalog.DatasetCatalog.list():
        assert catalog.DatasetCatalog.get(name) == j_catalog.DatasetCatalog.get(name), name
    got, want = _catalog_state(catalog.MetadataCatalog), _catalog_state(j_catalog.MetadataCatalog)
    assert got == want
    assert builtin.register_all(str(tmp_path)) == 0  # registered names are skipped


def test_sem_seg_and_panoptic_loaders_equal_jax(fresh_catalogs, tmp_path):
    os.makedirs(tmp_path / "gt")
    for i in range(3):
        write_png(str(tmp_path / "gt" / f"{i:03d}.png"), np.full((4, 4), i, np.uint8))
    assert coco.load_sem_seg(str(tmp_path / "gt"), "imgs") == \
        j_coco.load_sem_seg(str(tmp_path / "gt"), "imgs")
    assert coco.load_sem_seg(str(tmp_path / "gt"), "imgs", image_ext=".png") == \
        j_coco.load_sem_seg(str(tmp_path / "gt"), "imgs", image_ext=".png")
    pan = {"images": [{"id": 3, "file_name": "x.jpg", "height": 4, "width": 5},
                      {"id": 4, "height": 6, "width": 7}],
           "annotations": [{"image_id": 3, "file_name": "x.png",
                            "segments_info": [{"id": 1, "category_id": 0}]},
                           {"image_id": 4, "file_name": "y.png", "segments_info": []},
                           {"image_id": 5, "file_name": "z.png", "segments_info": []}]}
    _write_json(tmp_path / "pan.json", pan)
    args = (str(tmp_path / "pan.json"), "img", "pan")
    assert coco.load_coco_panoptic(*args) == j_coco.load_coco_panoptic(*args)
    coco.register_coco_panoptic("pan_test", {"thing_classes": ["a"]}, *args)
    j_coco.register_coco_panoptic("pan_test", {"thing_classes": ["a"]}, *args)
    coco.register_sem_seg("sem_test", {}, str(tmp_path / "gt"), "imgs")
    j_coco.register_sem_seg("sem_test", {}, str(tmp_path / "gt"), "imgs")
    for name in ("pan_test", "sem_test"):
        assert catalog.DatasetCatalog.get(name) == j_catalog.DatasetCatalog.get(name)
    assert _catalog_state(catalog.MetadataCatalog) == _catalog_state(j_catalog.MetadataCatalog)


def test_mix_config_criteria_build():
    """APE-Ti's flagship mix: all ten criteria build (F10 raised at the OID
    one), the LVIS and OpenImages ones with the federated loss over JAX's
    weights (LVIS's padded by its "cat" rule to the 1256 classes)."""
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.model_zoo import build_criterion

    cfg = LazyConfig.load(str(MIX))
    crits = [build_criterion(cfg, i) for i in range(len(cfg.criterions))]
    assert [c.num_classes for c in crits] == [1256, 365, 601, 256, 1, 256, 256, 256, 256, 256]
    assert [c.use_fed_loss for c in crits] == [True, False, True] + [False] * 7
    oid = crits[2].fed_loss_cls_weights.numpy()
    np.testing.assert_array_equal(
        oid, np.asarray(j_metadata.fed_loss_cls_weights("openimages_v6"), np.float32))
    assert crits[0].fed_loss_cls_weights.shape == (1256,)
    lvis = np.asarray(j_metadata.fed_loss_cls_weights("lvis_v1_train"), np.float32)
    np.testing.assert_array_equal(crits[0].fed_loss_cls_weights.numpy()[:1203], lvis)
