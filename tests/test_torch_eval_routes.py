"""The slice as a whole on the CPU: every route of ``evaluate_dataset`` run
by the port on a tiny masked APE-Ti tree (f32, 256^2) and by JAX on the
same weights (carried by ``state_dict_from_jax``) and the same text
features, over the same registered datasets: LVIS (bbox and segm), OID,
the semantic route over label PNGs, the referring route over records that
carry expressions, the panoptic route over records that carry ``pan_seg``;
and the reference's traits: a registered COCO-style JSON routed to
``sem_seg`` scores no image (trait 23), a registered referring JSON no
expression (trait 24), a ``register_coco_panoptic`` dataset no image
(trait 20), a semantic dataset without classes raises in both (trait 25),
and ``d3`` has no route. The metrics equal JAX's within ``METRIC_TOL``;
the counts of what each route scored equal what JAX's loop scores,
counted on the host."""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from ape_tpu.data.catalog import DatasetCatalog as JDatasetCatalog
from ape_tpu.data.catalog import MetadataCatalog as JMetadataCatalog
from ape_tpu.data.datasets import coco as j_coco
from ape_tpu.data.mapper import DatasetMapperDETR as JMapper
from ape_tpu.engine.ape_wrapper import APE as JAPE
from ape_tpu.evaluation.eval_runner import evaluate_dataset as j_evaluate
from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from ape_tpu_torch.data.datasets import coco
from ape_tpu_torch.data.image_io import write_png
from ape_tpu_torch.data.mapper import DatasetMapperDETR
from ape_tpu_torch.engine.ape_wrapper import APE
from ape_tpu_torch.evaluation.eval_runner import evaluate_dataset, to_host
from tests.parity_harness import DIMS, FakeLanguage
from tests.test_torch_data import write_dataset
from tests.torch_parity import jax_tiny_masked, model_pair, torch_tiny_masked

# The two models' outputs differ by f32 rounding (1e-4 of the logits,
# test_torch_masks): a score or a mask pixel at a threshold could flip,
# moving a metric by one match's share. None does on these inputs: the
# metrics agree to METRIC_TOL (f64 evaluators in the same order).
METRIC_TOL = 1e-9
COUNTS = ("images", "forwards", "scored")


@pytest.fixture(scope="module")
def apes():
    """The port's APE and JAX's on the tiny masked pair, one shared
    FakeLanguage table (DIMS["num_text"] texts), each dataset's vocabulary
    its metadata's classes."""
    jm, params, _, pm = model_pair(jax_tiny_masked(), torch_tiny_masked())
    feats = np.random.RandomState(5).randn(DIMS["num_text"], DIMS["ldim"]).astype(np.float32)
    names = ["routes_coco", "routes_sem", "routes_ref", "routes_pan", "routes_pan_files"]
    return (APE(pm.eval(), FakeLanguage(feats), dataset_names=names),
            JAPE(jm, params, FakeLanguage(feats), dataset_names=names))


@pytest.fixture(scope="module")
def layout(tmp_path_factory, apes):
    """The datasets, registered under the same names in both catalogs."""
    root = tmp_path_factory.mktemp("routes")
    rng = np.random.RandomState(0)
    js, img_root = write_dataset(root / "coco", n=3, seed=2)

    def both(name, port_fn, jax_fn, **meta):
        DatasetCatalog.register(name, port_fn)
        JDatasetCatalog.register(name, jax_fn)
        MetadataCatalog.get(name).set(**meta)
        JMetadataCatalog.get(name).set(**meta)

    coco.register_coco_instances("routes_coco", {}, js, img_root)
    j_coco.register_coco_instances("routes_coco", {}, js, img_root)
    dicts = DatasetCatalog.get("routes_coco")

    # semantic: label PNGs paired with the images by name (the images copied
    # to the loader's ".jpg" names: both readers go by content), 5 classes
    (root / "sem_gt").mkdir()
    for d in dicts:
        base = d["file_name"][:-4]
        shutil.copy(d["file_name"], base + ".jpg")
        labels = rng.randint(0, 5, (d["height"], d["width"])).astype(np.uint8)
        labels[:3] = 255
        write_png(str(root / "sem_gt" / f"{base.rsplit('/', 1)[1]}.png"), labels)
    for name, meta in (("routes_sem", {"stuff_classes": [f"s{i}" for i in range(5)]}),
                       ("routes_sem_noclass", {})):
        coco.register_sem_seg(name, meta, str(root / "sem_gt"), img_root)
        j_coco.register_sem_seg(name, meta, str(root / "sem_gt"), img_root)

    # referring: the records with expressions (two an object, one object
    # without); each object's box (read as x, y, w, h: trait 24) is the port's
    # top-1 box for its first expression, so that P@0.5 counts hits
    port = apes[0]
    mapped = [DatasetMapperDETR(is_train=False, image_size=DIMS["img"])(d) for d in dicts]
    ref = []
    for d, ex in zip(dicts, mapped):
        anns = []
        for k, a in enumerate(d["annotations"]):
            a = dict(a)
            if k != 1:
                a["expressions"] = ["a red cat", "the dog, left"][:1 + k % 2]
                inst = to_host(port([dict(ex, text_prompt=a["expressions"][0])])[0])["instances"]
                if len(inst["scores"]):
                    x0, y0, x1, y1 = inst["boxes"][inst["scores"].argmax()].tolist()
                    a["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            anns.append(a)
        ref.append(dict(d, annotations=anns))
    both("routes_ref", lambda: ref, lambda: ref)

    # panoptic: id maps at each image's size, 3 things and 2 stuff classes
    (root / "pan").mkdir()
    pan = []
    for i, d in enumerate(dicts):
        h, w = d["height"], d["width"]
        seg = np.zeros((h, w), np.int32)
        info = []
        for j in range(4):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            seg[y:y + rng.randint(6, h // 2), x:x + rng.randint(6, w // 2)] = j + 1
            info.append({"id": j + 1, "category_id": int(j % 5), "isthing": int(j % 5 < 3)})
        ids = seg.astype(np.uint32)
        Image.fromarray(np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1)
                        .astype(np.uint8)).save(root / "pan" / f"{i}.png")
        pan.append(dict(d, pan_seg=seg, segments_info=info))
    pan_meta = dict(thing_classes=["a", "b", "c"], stuff_classes=["d", "e"])
    both("routes_pan", lambda: pan, lambda: pan, **pan_meta)
    pan_json = root / "pan.json"
    pan_json.write_text(json.dumps({
        "images": [{"id": d["image_id"], "file_name": d["file_name"].rsplit("/", 1)[1],
                    "height": d["height"], "width": d["width"]} for d in dicts],
        "annotations": [{"image_id": d["image_id"], "file_name": f"{i}.png",
                         "segments_info": p["segments_info"]}
                        for i, (d, p) in enumerate(zip(dicts, pan))]}))
    coco.register_coco_panoptic("routes_pan_files", pan_meta, str(pan_json), img_root,
                                str(root / "pan"))
    j_coco.register_coco_panoptic("routes_pan_files", pan_meta, str(pan_json), img_root,
                                  str(root / "pan"))
    return {"dicts": dicts, "ref": ref, "pan": pan}


def _run(apes, name, etype, iou_types=("bbox",)):
    port, jax_ = apes
    kw = dict(is_train=False, image_size=DIMS["img"])
    got = evaluate_dataset(port, name, DatasetMapperDETR(**kw), iou_types, evaluator_type=etype)
    want = j_evaluate(jax_, name, JMapper(**kw), iou_types, evaluator_type=etype)
    metrics = {k: v for k, v in want.items() if not k.startswith("seconds/") and k not in COUNTS}
    assert metrics and set(metrics) <= set(got)
    for k, v in metrics.items():
        if np.isnan(v):
            assert np.isnan(got[k]), (k, got[k])
        else:
            assert abs(got[k] - v) <= METRIC_TOL, (k, got[k], v)
    assert {f"seconds/{s}" for s in ("data", "device", "postprocess", "eval")} <= set(got)
    return got, metrics


def test_lvis_route(apes, layout):
    got, metrics = _run(apes, "routes_coco", "lvis", ("bbox", "segm"))
    n = len(layout["dicts"])
    assert (got["images"], got["forwards"], got["scored"]) == (n, n, n)
    assert {"bbox/AP", "segm/AP"} <= set(metrics)


def test_oid_route(apes, layout):
    got, metrics = _run(apes, "routes_coco", "oid")
    assert got["scored"] == len(layout["dicts"]) and "bbox/AP" in metrics


def test_sem_seg_route(apes, layout):
    got, metrics = _run(apes, "routes_sem", "sem_seg")
    assert got["scored"] == got["images"] == len(layout["dicts"])
    assert np.isfinite(metrics["sem_seg/mIoU"])


def test_sem_seg_route_over_coco_json_scores_nothing(apes, layout):
    """Trait 23: the records of a COCO-style JSON carry no semantic ground
    truth; every image runs and none is scored, in both."""
    got, metrics = _run(apes, "routes_coco", "sem_seg")
    assert got["scored"] == 0 and got["images"] == len(layout["dicts"])
    assert np.isnan(metrics["sem_seg/mIoU"])


def test_sem_seg_route_without_classes_raises(apes, layout):
    """Trait 25: the class count is the metadata's vocabulary; with none, the
    first labelled pixel fails the evaluator, in both."""
    port, jax_ = apes
    kw = dict(is_train=False, image_size=DIMS["img"])
    with pytest.raises(ValueError):
        j_evaluate(jax_, "routes_sem_noclass", JMapper(**kw))
    with pytest.raises(ValueError):
        evaluate_dataset(port, "routes_sem_noclass", DatasetMapperDETR(**kw))


def test_refcoco_route(apes, layout):
    got, metrics = _run(apes, "routes_ref", "refcoco")
    exprs = sum(len(a.get("expressions", [])) for d in layout["ref"] for a in d["annotations"])
    assert got["scored"] == got["forwards"] == exprs > 0
    assert metrics["refcoco/P@0.5"] > 0 and "refcoco/mIoU" in metrics


def test_refcoco_route_over_coco_json_scores_nothing(apes, layout):
    """Trait 24: ``load_coco_json`` keeps no expressions, so a registered
    referring JSON scores none, and P@0.5 reads 0 in both."""
    got, metrics = _run(apes, "routes_coco", "refcoco")
    assert got["scored"] == got["forwards"] == 0
    assert metrics["refcoco/P@0.5"] == 0.0


def test_panoptic_route(apes, layout):
    got, metrics = _run(apes, "routes_pan", "panoptic")
    assert got["scored"] == got["images"] == len(layout["pan"])
    assert set(metrics) == {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ", "panoptic/PQ_th",
                            "panoptic/PQ_st"}
    assert metrics["panoptic/PQ"] == 0.0  # random weights: no segment passes the merge's overlap


def test_panoptic_route_over_registered_json_scores_nothing(apes, layout):
    """Trait 20: ``load_coco_panoptic`` records carry the id map's file, not
    ``pan_seg``; every image runs, none is scored, PQ is NaN in both."""
    got, metrics = _run(apes, "routes_pan_files", "panoptic")
    assert got["scored"] == 0 and got["images"] == len(layout["pan"])
    assert np.isnan(metrics["panoptic/PQ"])


def test_d3_has_no_route(apes, layout):
    port, jax_ = apes
    with pytest.raises(ValueError, match="d3"):
        j_evaluate(jax_, "routes_coco", None, evaluator_type="d3")
    with pytest.raises(ValueError, match="d3"):
        evaluate_dataset(port, "routes_coco", None, evaluator_type="d3")
