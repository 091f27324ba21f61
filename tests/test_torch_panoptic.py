"""The port's host evaluation (``ape_tpu_torch/evaluation/``) against
ape_tpu's on the CPU:

* ``panoptic_merge`` equal to JAX's on seeded inputs, with stuff
  deduplicated, a query dropped by the overlap threshold, an empty keep
  and a class outside ``thing_ids``;
* ``upsample_prob_maps`` within 1e-5 of JAX's (PIL's mode "F") up and
  down, non-square, from and to one pixel; ``paste_masks`` equal to JAX's
  (PIL's mode "L", thresholded at 127 with pixels at 127 and 128 present)
  with boxes clipped at every edge;
* ``SemSegEvaluator``, ``PanopticEvaluator`` and ``RefCOCOEvaluator``:
  dicts equal to JAX's on synthetic segments, NaN where JAX gives NaN;
* the per-image semantic and panoptic steps equal to the bodies of JAX's
  ``_eval_sem_seg`` and ``_eval_panoptic`` loops;
* the modules import no PIL, no cv2 and nothing of ``ape_tpu``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ape_tpu.evaluation import eval_runner as j_runner
from ape_tpu.evaluation import other_evals as j_evals
from ape_tpu.evaluation.panoptic_merge import panoptic_merge as j_merge
from ape_tpu_torch.evaluation import eval_runner, other_evals
from ape_tpu_torch.evaluation.panoptic_merge import panoptic_merge

THINGS = {0, 1, 2}


def _blobs(rng, k, h, w, lo=0.05, hi=0.95):
    """k mask probability maps, each high inside a random rectangle."""
    masks = np.full((k, h, w), lo, np.float32) + rng.uniform(0, 0.04, (k, h, w)).astype(np.float32)
    for i in range(k):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        y1, x1 = rng.randint(y0 + 3, h + 1), rng.randint(x0 + 3, w + 1)
        masks[i, y0:y1, x0:x1] = hi
    return masks


def _merge_case(case, rng):
    """(scores, labels, raw_scores, masks_prob) of one merge case."""
    k, h, w = 12, 20, 24
    scores = rng.uniform(0.2, 1.0, k).astype(np.float32)
    labels = rng.randint(0, 6, k)
    raw = rng.uniform(0.1, 1.0, k).astype(np.float32)
    masks = _blobs(rng, k, h, w)
    if case == "stuff_dedup":  # two disjoint queries of one stuff class: one segment
        labels[:2] = 4
        raw[:2] = 0.9
        masks[:2] = 0.05
        masks[0, :8, :8] = masks[1, 10:, 12:] = 0.95
    elif case == "overlap":  # query 1 mostly under query 0, which scores higher
        scores[:2] = (0.99, 0.3)
        raw[:] = 0.2
        raw[:2] = 0.9
        masks[:2] = 0.05
        masks[0, 2:12, 2:12] = 0.95
        masks[1, 4:13, 4:13] = 0.95
    elif case == "empty_keep":
        raw[:] = 0.2
    elif case == "absent_thing":  # class 5 lies outside THINGS: routed as stuff
        labels[:3] = 5
        raw[:3] = 0.9
    return scores, labels, raw, masks


@pytest.mark.parametrize("case", ["seeded", "stuff_dedup", "overlap", "empty_keep",
                                  "absent_thing"])
def test_panoptic_merge_matches_ape_tpu(rng, case):
    args = _merge_case(case, rng)
    seg, info = panoptic_merge(*args, THINGS)
    want_seg, want_info = j_merge(*args, THINGS)
    assert seg.dtype == np.int32
    np.testing.assert_array_equal(seg, want_seg)
    assert info == want_info
    cats = [s["category_id"] for s in info]
    if case == "empty_keep":
        assert not info and not seg.any()
    elif case == "stuff_dedup":
        assert cats.count(4) == 1 and (seg == info[cats.index(4)]["id"]).sum() >= 8 * 8 + 10 * 12
    elif case == "overlap":  # query 1 keeps 17 of its 81 pixels: under 0.8, dropped
        assert len(info) == 1 and (seg == info[0]["id"]).sum() == 100
    elif case == "absent_thing":
        assert 5 in cats and not info[cats.index(5)]["isthing"]
    else:
        assert len(info) >= 3 and {s["isthing"] for s in info} == {True, False}


@pytest.mark.parametrize("shape,size", [((64, 64), (480, 640)), ((256, 256), (97, 131)),
                                        ((17, 23), (31, 9)), ((1, 1), (13, 9)),
                                        ((5, 7), (1, 1))],
                         ids=["up", "down", "mixed", "from_one_pixel", "to_one_pixel"])
def test_upsample_prob_maps_matches_pil(rng, shape, size):
    probs = rng.rand(3, *shape).astype(np.float32)
    got = eval_runner.upsample_prob_maps(probs, *size)
    want = j_runner.upsample_prob_maps(probs, *size)
    assert got.shape == want.shape == (3,) + size and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_paste_masks_matches_pil(rng):
    """Logits whose uint8 probabilities sit at 127 and 128 around the
    threshold; boxes past every edge, one wholly outside, halves rounding."""
    h, w = 90, 70
    logits = rng.normal(0.0, 0.05, (6, 32, 32)).astype(np.float32)
    logits[:, ::3] += 2.0
    boxes = np.asarray([[-5.0, -3.0, 40.0, 50.0], [30.0, 20.0, 80.0, 95.0],
                        [10.5, 11.5, 60.5, 70.5], [-10.0, 40.0, 75.0, 89.6],
                        [71.0, 5.0, 90.0, 20.0], [0.0, 0.0, 70.0, 90.0]], np.float32)
    got = eval_runner.paste_masks(logits, boxes, h, w)
    want = j_runner.paste_masks(logits, boxes, h, w)
    for g, m in zip(got, want):
        np.testing.assert_array_equal(g, m)
    assert not got[4].any() and got[5].any()
    full = eval_runner.pil_resize((255 / (1 + np.exp(-logits[0]))).astype(np.uint8), h, w)
    assert (full == 127).any() and (full == 128).any()


def _same(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_equal(got, want)  # NaN equals NaN


def test_sem_seg_evaluator_matches_ape_tpu(rng):
    """Two images, an ignore label, a class in neither prediction nor truth
    (NaN IoU) and one only predicted."""
    got, want = other_evals.SemSegEvaluator(6), j_evals.SemSegEvaluator(6)
    for _ in range(2):
        gt = rng.randint(0, 4, (30, 40))
        gt[:3] = 255
        pred = np.where(rng.rand(30, 40) < 0.7, gt % 255, rng.randint(0, 6, (30, 40)))
        pred[pred == 4] = 5
        got.process(pred, gt)
        want.process(pred, gt)
    out = got.evaluate()
    _same(out, want.evaluate())
    assert np.isfinite(out["sem_seg/mIoU"])
    got.reset()
    assert not got._conf.any()


def _segments(rng, h, w, n, cats):
    seg = np.zeros((h, w), np.int32)
    info = []
    for i in range(1, n + 1):
        y0, x0 = rng.randint(0, h - 6), rng.randint(0, w - 6)
        seg[y0:y0 + rng.randint(4, 12), x0:x0 + rng.randint(4, 12)] = i
        info.append({"id": i, "category_id": int(cats[i - 1])})
    return seg, info


@pytest.mark.parametrize("thing_ids", [set(), {0, 2}], ids=["no_things", "things"])
def test_panoptic_evaluator_matches_ape_tpu(rng, thing_ids):
    """Predictions as the truth shifted by a pixel (matched), with extra
    (FP) and missed (FN) segments; a class with no segment; and an image
    with no prediction at all."""
    got = other_evals.PanopticEvaluator(5, thing_ids)
    want = j_evals.PanopticEvaluator(5, thing_ids)
    for i in range(3):
        gt, gt_info = _segments(rng, 40, 50, 5, rng.randint(0, 4, 5))
        pred = np.roll(gt, 1, axis=1)
        pred_info = [dict(s) for s in gt_info]
        pred[35:, 45:] = 9
        pred_info.append({"id": 9, "category_id": 3})
        if i == 2:
            pred[:] = 0
            pred_info = []
        for ev in (got, want):
            ev.process(pred, pred_info, gt, gt_info)
    _same(got.evaluate(), want.evaluate())
    empty_got = other_evals.PanopticEvaluator(3, thing_ids).evaluate()
    empty_want = j_evals.PanopticEvaluator(3, thing_ids).evaluate()
    _same(empty_got, empty_want)
    assert np.isnan(empty_got["panoptic/PQ"])


def test_refcoco_evaluator_matches_ape_tpu(rng):
    """Top-1 boxes at several overlaps, with masks, a missed expression's
    mask (None), and one expression without masks."""
    got, want = other_evals.RefCOCOEvaluator(), j_evals.RefCOCOEvaluator()
    for i in range(6):
        gt = np.asarray([10, 10, 50, 60], np.float32)
        pred = gt + rng.uniform(-12, 12, 4).astype(np.float32)
        gmask = np.zeros((70, 70), bool)
        gmask[10:60, 10:50] = True
        pmask = np.roll(gmask, i, axis=0) if i != 3 else None
        for ev in (got, want):
            if i == 5:
                ev.process(pred, gt)
            elif pmask is None:
                ev._total += 1
                ev.process_mask(None, gmask)
            else:
                ev.process(pred, gt, pmask, gmask)
    _same(got.evaluate(), want.evaluate())
    assert "refcoco/oIoU" in got.evaluate()


def test_aggregate_benchmark_suite_matches_ape_tpu():
    results = {"a": {"bbox/AP": 40.0}, "b": {"bbox/AP": float("nan")}, "c": {"bbox/AP": 10.0},
               "d": {"segm/AP": 3.0}}
    _same(other_evals.aggregate_benchmark_suite(results),
          j_evals.aggregate_benchmark_suite(results))
    assert other_evals.aggregate_benchmark_suite({}) == {}


def test_sem_seg_and_panoptic_steps_match_ape_tpu_loops(rng):
    """One image through the port's steps and through the bodies of JAX's
    _eval_sem_seg and _eval_panoptic loops (eval_runner.py:131-144,
    :218-231): the same label map, segments, and evaluator state."""
    h, w = 45, 61
    sem = rng.rand(8, 16, 16).astype(np.float32)
    sem[6:] = 0.0  # the padded vocabulary's maps, as the model gives them
    gt = rng.randint(0, 6, (h, w))
    ev, jev = other_evals.SemSegEvaluator(6), j_evals.SemSegEvaluator(6)
    pred = eval_runner.sem_seg_step(sem, gt, ev)
    jev.process(j_runner.upsample_prob_maps(sem, h, w).argmax(0), gt)
    assert pred.shape == (h, w)
    _same(ev.evaluate(), jev.evaluate())

    k = 10
    logits = 8.0 * (_blobs(rng, k, 16, 16) - 0.5)
    raw = {"scores": rng.uniform(0.2, 1.0, k).astype(np.float32),
           "labels": rng.randint(0, 5, k), "raw_scores": rng.uniform(0.2, 1.0, k).astype(np.float32),
           "mask_logits": logits}
    gt_seg, gt_info = _segments(rng, h, w, 4, rng.randint(0, 5, 4))
    pev, jpev = other_evals.PanopticEvaluator(5, THINGS), j_evals.PanopticEvaluator(5, THINGS)
    seg, info = eval_runner.panoptic_step(raw, gt_seg, gt_info, THINGS, pev)
    masks_prob = 1.0 / (1.0 + np.exp(-j_runner.upsample_prob_maps(raw["mask_logits"], h, w)))
    want_seg, want_info = j_merge(raw["scores"], raw["labels"], raw["raw_scores"], masks_prob,
                                  THINGS)
    jpev.process(want_seg, want_info, gt_seg, gt_info)
    np.testing.assert_array_equal(seg, want_seg)
    assert info == want_info and len(info) >= 2
    _same(pev.evaluate(), jpev.evaluate())
    # the merge's own output as the truth: every segment matched at IoU 1
    own = other_evals.PanopticEvaluator(5, THINGS)
    own.process(seg, info, seg, info)
    assert own.evaluate()["panoptic/PQ"] == 100.0


def test_evaluation_imports_no_pil_cv2_or_ape_tpu():
    """In a fresh interpreter that refuses PIL, cv2, jax and the JAX
    package, the evaluation modules import and run one merge, one resize
    of each mode and one evaluation."""
    code = textwrap.dedent("""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("PIL", "cv2", "jax", "jaxlib", "flax", "ape_tpu"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from ape_tpu_torch.evaluation import eval_runner, other_evals, panoptic_merge
        probs = np.random.RandomState(0).rand(4, 8, 8).astype(np.float32)
        masks = eval_runner.upsample_prob_maps(probs, 12, 10)
        seg, info = panoptic_merge.panoptic_merge(np.ones(4, np.float32), np.arange(4),
                                                  np.ones(4, np.float32), masks, {0, 1})
        pasted = eval_runner.paste_masks(probs, np.asarray([[0, 0, 5, 5]] * 4), 12, 10)
        ev = other_evals.PanopticEvaluator(4, {0, 1})
        ev.process(seg, info, seg, info)
        print(sorted(ev.evaluate()), len(pasted))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert "panoptic/PQ" in out.stdout
