"""The port's COCO and LVIS evaluators against JAX's, to 1e-12, on seeded
synthetic annotations and detections (boxes and masks: polygons and RLE,
crowds, empty images, ``max_dets``), and JAX's hand-computed protocol cases
of ``tests/test_coco_protocol.py`` run on the port's evaluator."""

import numpy as np
import pytest

import tests.test_coco_protocol as protocol
from ape_tpu.evaluation.coco_eval import COCOEvaluator as JCOCOEvaluator
from ape_tpu.evaluation.coco_eval import box_iou_xyxy as j_box_iou
from ape_tpu.evaluation.lvis_eval import LVISEvaluator as JLVISEvaluator
from ape_tpu_torch.data.transforms import polygons_to_mask, rle_encode
from ape_tpu_torch.evaluation import other_evals
from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator, box_iou_xyxy
from ape_tpu_torch.evaluation.lvis_eval import LVISEvaluator

H, W = 40, 48


def _polygon(rng):
    x0, y0 = rng.uniform(0, W - 12), rng.uniform(0, H - 12)
    bw, bh = rng.uniform(4, W - x0), rng.uniform(4, H - y0)
    return [x0, y0, x0 + bw, y0 + rng.uniform(0, 2), x0 + bw * rng.uniform(0.5, 1), y0 + bh,
            x0, y0 + bh * rng.uniform(0.6, 1)]


def synthetic(seed: int, n_img: int = 7, n_cat: int = 6, lvis: bool = False):
    """(dataset dicts, predictions): 1-6 objects an image (polygon or RLE
    segmentations, every fifth a crowd), one image without any; detections
    near the objects (jittered), spurious ones, several classes; LVIS
    fields (negative and not-exhaustive categories) with ``lvis``."""
    rng = np.random.RandomState(seed)
    dicts, preds = [], []
    for i in range(n_img):
        anns = []
        for j in range(0 if i == n_img - 1 else int(rng.randint(1, 7))):
            poly = _polygon(rng)
            mask = polygons_to_mask([poly], H, W)
            ys, xs = np.nonzero(mask)
            if not len(xs):
                continue
            seg = rle_encode(mask) if j % 3 == 1 else [poly]
            anns.append({"category_id": int(rng.randint(n_cat)),
                         "bbox": [float(xs.min()), float(ys.min()), float(xs.max() + 1),
                                  float(ys.max() + 1)],
                         "area": float(mask.sum()), "iscrowd": int(j % 5 == 4),
                         "segmentation": seg, "_mask": mask})
        d = {"image_id": 100 + i, "height": H, "width": W,
             "annotations": [{k: v for k, v in a.items() if k != "_mask"} for a in anns]}
        if lvis:
            d["neg_category_ids"] = [int(c) for c in rng.choice(n_cat, 2, replace=False)]
            d["not_exhaustive_category_ids"] = [int(rng.randint(n_cat))]
        dicts.append(d)
        boxes, scores, classes, masks = [], [], [], []
        for a in anns + [None] * int(rng.randint(0, 4)):
            if a is None or rng.rand() < 0.2:  # spurious
                poly = _polygon(rng)
                m = polygons_to_mask([poly], H, W)
                b = np.asarray([poly[0], poly[1], poly[2], poly[5]], np.float64)
                c = int(rng.randint(n_cat))
            else:
                m = np.roll(a["_mask"], int(rng.randint(-2, 3)), axis=1)
                b = np.asarray(a["bbox"]) + rng.uniform(-2, 2, 4)
                c = a["category_id"] if rng.rand() < 0.85 else int(rng.randint(n_cat))
            boxes.append(b)
            scores.append(float(np.round(rng.rand(), 2)))  # ties among the scores
            classes.append(c)
            masks.append(m)
        preds.append({"image_id": 100 + i, "instances": {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4), "scores": np.asarray(scores),
            "classes": np.asarray(classes), "masks": masks}})
    return dicts, preds


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("max_dets", [1, 3, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_evaluator_equals_jax(iou_type, max_dets, seed):
    dicts, preds = synthetic(seed)
    port, jax_ = COCOEvaluator(dicts, iou_type, max_dets), JCOCOEvaluator(dicts, iou_type, max_dets)
    port.process(preds)
    jax_.process(preds)
    _same(port.evaluate(), jax_.evaluate())
    assert port.per_class_ap.keys() == jax_.per_class_ap.keys()
    for c, v in jax_.per_class_ap.items():
        assert abs(port.per_class_ap[c] - v) <= 1e-12


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("seed", [2, 3])
def test_lvis_evaluator_equals_jax(iou_type, seed):
    """Up to 300 detections an image, the federated filter, the
    not-exhaustive categories and the r/c/f buckets (from counts given, and
    from the dataset's own)."""
    dicts, preds = synthetic(seed, n_img=9, lvis=True)
    counts = {c: int(n) for c, n in zip(range(6), (3, 9, 10, 50, 100, 101))}
    for kw in ({}, {"category_image_counts": counts}):
        port, jax_ = LVISEvaluator(dicts, iou_type, **kw), JLVISEvaluator(dicts, iou_type, **kw)
        port.process(preds)
        jax_.process(preds)
        got, want = port.evaluate(), jax_.evaluate()
        _same(got, want)
        assert {f"{iou_type}/AP{b}" for b in "rcf"} <= set(got)


def test_box_iou_is_one_implementation():
    rng = np.random.RandomState(4)
    a = np.sort(rng.rand(5, 4) * 10, axis=1)[:, [0, 1, 2, 3]]
    b = np.sort(rng.rand(7, 4) * 10, axis=1)
    crowd = rng.rand(7) < 0.5
    np.testing.assert_array_equal(box_iou_xyxy(a, b, crowd), j_box_iou(a, b, crowd))
    assert other_evals.box_iou_xyxy is box_iou_xyxy


@pytest.mark.parametrize("case", ["test_max_dets_truncation", "test_area_range_ignore_semantics",
                                  "test_crowd_absorbs_extra_dets",
                                  "test_ignored_gt_does_not_block_valid_match",
                                  "test_score_tie_stable_order"])
def test_coco_protocol_cases_on_the_port(monkeypatch, case):
    """JAX's hand-computed protocol cases, their evaluator the port's."""
    monkeypatch.setattr(protocol, "COCOEvaluator", COCOEvaluator)
    getattr(protocol, case)()
