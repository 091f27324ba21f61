"""The port's OpenImages, D-cube and unified evaluators against JAX's: JAX's
hand-computed cases (``tests/test_oid_eval.py``, ``tests/test_d3_unified_eval.py``)
run on the port's classes, and seeded random cases whose metrics must equal
JAX's to 1e-12 (both compute in f64 in the same order)."""

import numpy as np
import pytest

import tests.test_d3_unified_eval as d3_cases
import tests.test_oid_eval as oid_cases
from ape_tpu.evaluation import coco_eval as j_coco_eval
from ape_tpu.evaluation import d3_eval as j_d3_eval
from ape_tpu.evaluation import oid_eval as j_oid_eval
from ape_tpu.evaluation import unified_eval as j_unified_eval
from ape_tpu_torch.evaluation import coco_eval, d3_eval, oid_eval, unified_eval

TOL = 1e-12


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)


@pytest.mark.parametrize("case", ["test_perfect_single_det", "test_voc_area_hand_computed",
                                  "test_hierarchy_expansion", "test_federated_filtering",
                                  "test_group_of", "test_voc_ap_helper", "test_freq_buckets"])
def test_oid_cases_on_the_port(monkeypatch, case):
    """JAX's hand-computed OID cases, their evaluator the port's."""
    for name in ("OIDEvaluator", "build_ancestors", "voc_average_precision"):
        monkeypatch.setattr(oid_cases, name, getattr(oid_eval, name))
    getattr(oid_cases, case)()


@pytest.mark.parametrize("case", ["test_d3_modes", "test_d3_intra_sent_id_remap",
                                  "test_unified_map_back", "test_unified_novel_fanout"])
def test_d3_and_unified_cases_on_the_port(monkeypatch, case):
    monkeypatch.setattr(d3_cases, "COCOEvaluator", coco_eval.COCOEvaluator)
    monkeypatch.setattr(d3_cases, "D3Evaluator", d3_eval.D3Evaluator)
    for name in ("UnifiedEvaluator", "build_map_back", "build_map_back_novel"):
        monkeypatch.setattr(d3_cases, name, getattr(unified_eval, name))
    getattr(d3_cases, case)()


def _box(rng, size=100.0):
    x0, y0 = rng.uniform(0, size * 0.8, 2)
    return [x0, y0, x0 + rng.uniform(2, size * 0.3), y0 + rng.uniform(2, size * 0.3)]


def _oid_case(seed, n_img=12, n_cat=6):
    """OID-style records (xyxy boxes, group-of boxes, verified negative and
    positive labels) and detections near them or spurious, some of classes
    an image does not verify."""
    rng = np.random.RandomState(seed)
    dicts, preds = [], []
    for i in range(n_img):
        anns = [{"category_id": int(rng.randint(n_cat)), "bbox": _box(rng),
                 "iscrowd": int(rng.rand() < 0.15)} for _ in range(rng.randint(0, 6))]
        dicts.append({"image_id": i, "annotations": anns,
                      "neg_category_ids": [int(c) for c in rng.choice(n_cat, 2, replace=False)],
                      "pos_category_ids": [int(rng.randint(n_cat))]})
        boxes, scores, classes = [], [], []
        for a in anns + [None] * int(rng.randint(0, 5)):
            b = _box(rng) if a is None else list(np.asarray(a["bbox"]) + rng.normal(0, 2, 4))
            boxes.append(b)
            scores.append(float(rng.rand()))
            classes.append(int(rng.randint(n_cat)) if a is None or rng.rand() < 0.2
                           else a["category_id"])
        preds.append({"image_id": i, "instances": {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(scores), "classes": np.asarray(classes, np.int64)}})
    return dicts, preds


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("expand", [True, False])
def test_oid_evaluator_equals_jax(seed, expand):
    """Random cases with a three-level hierarchy: metrics and per-class AP."""
    dicts, preds = _oid_case(seed)
    hierarchy = {"LabelName": "root", "Subcategory": [
        {"LabelName": "c0", "Subcategory": [{"LabelName": "c1"},
                                            {"LabelName": "c2", "Subcategory": [{"LabelName": "c3"}]}]},
        {"LabelName": "c4"}]}
    names = {f"c{i}": i for i in range(6)}
    anc = oid_eval.build_ancestors(hierarchy, names)
    assert anc == j_oid_eval.build_ancestors(hierarchy, names)
    port = oid_eval.OIDEvaluator(dicts, ancestors=anc, expand_pred_label=expand, max_dets=7)
    jax_ = j_oid_eval.OIDEvaluator(dicts, ancestors=anc, expand_pred_label=expand, max_dets=7)
    port.process(preds)
    jax_.process(preds)
    _same(port.evaluate(), jax_.evaluate())
    assert port.per_class_ap == jax_.per_class_ap


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("group", ["inter", "intra"])
def test_d3_evaluator_equals_jax(seed, group):
    rng = np.random.RandomState(seed)
    dicts, preds = _oid_case(seed + 10, n_cat=8)
    for d, p in zip(dicts, preds):
        d["height"] = d["width"] = 120
        for a in d["annotations"]:
            a["iscrowd"] = 0
            a["area"] = float((a["bbox"][2] - a["bbox"][0]) * (a["bbox"][3] - a["bbox"][1]))
        if group == "intra":
            p["sent_ids"] = [int(c) for c in rng.permutation(8)[:5]]
    kw = dict(pres_ids=[0, 2, 4, 6], abs_ids=[1, 3, 5], group=group)
    port, jax_ = d3_eval.D3Evaluator(dicts, **kw), j_d3_eval.D3Evaluator(dicts, **kw)
    port.process(preds)
    jax_.process(preds)
    _same(port.evaluate(), jax_.evaluate())


@pytest.mark.parametrize("seed", range(3))
def test_unified_evaluator_equals_jax(seed):
    """Map-back with a label map and with novel-class fan-out, into COCO AP."""
    rng = np.random.RandomState(seed)
    dicts, preds = _oid_case(seed + 20, n_cat=5)
    for d in dicts:
        d["height"] = d["width"] = 120
        for a in d["annotations"]:
            a["area"] = float((a["bbox"][2] - a["bbox"][0]) * (a["bbox"][3] - a["bbox"][1]))
    unified = [int(v) for v in rng.permutation(40)[:5]]
    novel = [[unified[c]] + [int(v) for v in rng.choice(40, 2)] for c in range(5)]
    for p in preds:  # predictions in the unified label space, some outside it
        p["instances"]["classes"] = np.asarray(
            [unified[c] if rng.rand() < 0.8 else int(rng.randint(40, 50))
             for c in p["instances"]["classes"]], np.int64)
    for build in ("build_map_back", "build_map_back_novel"):
        arg = unified if build == "build_map_back" else novel
        mb = getattr(unified_eval, build)(arg)
        assert mb == getattr(j_unified_eval, build)(arg)
        port = unified_eval.UnifiedEvaluator(coco_eval.COCOEvaluator(dicts, "bbox", 100), mb)
        jax_ = j_unified_eval.UnifiedEvaluator(j_coco_eval.COCOEvaluator(dicts, "bbox", 100), mb)
        port.process(preds)
        jax_.process(preds)
        _same(port.evaluate(), jax_.evaluate())
