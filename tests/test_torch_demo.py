"""The port's demo path (``ape_tpu_torch/demo/``, ``utils/draw.py``,
``tools/visualize_json_results.py``) against JAX's on the CPU:

* ``VisualizationDemo.draw`` equal to JAX's bit for bit on one prediction
  dict (fractional boxes, boxes past the edges, a class past the text
  list), every ``with_box``/``with_mask``/``with_sseg`` combination and
  several image shapes, with the label text stubbed on both sides (PIL's
  ``ImageDraw.text`` and the port's ``draw_label``): labels are the one
  place the images differ. A separate case holds the port's labels to the
  class colour at JAX's anchor, inside PIL's own text by at most a pixel,
  and the glyph table to the font it was rasterised from;
* the CLIs end to end on a PIL-written JPEG with a text prompt:
  ``configs/tests/ape_deta_tiny.py`` (with a one-layer tower) built by
  JAX's ``demo.demo_lazy.build_model``, its weights handed to the port as a
  checkpoint (``state_dict_from_jax``) and its tower's by
  ``language_state_dict_from_jax``; ``predictions.json`` within the port's
  f32 tolerances of JAX's (scores 1e-4, boxes 1e-2 px, as
  ``test_torch_model.test_ape_wrapper_matches``), the written overlays equal
  outside the label boxes (the JPEG blocks they touch), and equal byte for
  byte with the labels stubbed. The input is square at the tiny config's
  image size, 64, so that neither predictor resamples: the port's predictor
  resize is within 1 level of PIL's, not equal to it
  (``test_torch_model.test_predictor_resize_matches_pil``);
* ``visualize_json_results`` equal to JAX's byte for byte (labels stubbed);
* ``AsyncPredictor``'s order and errors; ``grabcut_refine`` and
  ``run_on_video`` equal to JAX's with OpenCV, and both, and the CLI's
  ``--video-input``, raising ``ImportError`` naming cv2 without it (JAX's
  ``grabcut_refine`` returns the mask unrefined instead);
* in a fresh interpreter that refuses PIL, cv2, jax, flax, ape_tpu and
  experiments: decode, draw, encode, and one tiny request through
  ``demo_lazy.main``.

JAX's weights come from its ``build_model`` (an eager flax init of the tiny
model, about 45 s on a CPU, once for the module). Its class heads start at the
focal prior (bias -4.6), under which no query passes the wrapper's 0.05;
both CLIs get the same weights with those biases at 0.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

from ape_tpu_torch.demo import demo_lazy, predictor_lazy
from demo.predictor_lazy import VisualizationDemo as JaxVisualizationDemo
from ape_tpu_torch.tools import train_net, visualize_json_results
from ape_tpu_torch.utils import draw
from tests.torch_parity import flatten, unflatten

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "configs" / "tests" / "ape_deta_tiny.py"
TOWER = dict(width=64, heads=2, layers=1, output_dim=256)
CONFIG = textwrap.dedent("""
    from ape_tpu.config import LazyConfig

    _base = LazyConfig.load({tiny!r})
    model = _base.model
    train = _base.train
    dataloader = _base.dataloader
    language = dict({tower})
""")
PROMPT = "person,dog,frisbee"
DRAWN = 2  # instances the overlay draws: the threshold sits between JAX's 3rd and 4th scores


def write_config(root: Path) -> str:
    path = root / "tiny_demo.py"
    path.write_text(CONFIG.format(tiny=str(TINY),
                                  tower=", ".join(f"{k}={v}" for k, v in TOWER.items())))
    return str(path)


def image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     (xx + yy) * 127.0 / max(w + h - 2, 1)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _demos(threshold: float):
    """JAX's and the port's VisualizationDemo without a predictor (draw only)."""
    jv = JaxVisualizationDemo.__new__(JaxVisualizationDemo)
    pv = predictor_lazy.VisualizationDemo.__new__(predictor_lazy.VisualizationDemo)
    jv.threshold = pv.threshold = threshold
    return jv, pv


def fake_prediction(rng, h: int, w: int, n: int = 7, names=("person", "dog", "frisbee"),
                    side: int = 16) -> dict:
    """Instances with fractional boxes, boxes past every edge and integral
    ones, a class past the text list, mask logits and sem_seg at ``side``."""
    x0 = rng.uniform(-0.3 * w, w, n)
    y0 = rng.uniform(-0.3 * h, h, n)
    x1 = x0 + rng.uniform(0, 0.9 * w, n)
    y1 = y0 + rng.uniform(0, 0.9 * h, n)
    boxes = np.stack([x0, y0, x1, y1], 1).astype(np.float32)
    boxes[0] = np.round(boxes[0])
    classes = rng.randint(0, len(names) + 1, n).astype(np.int64)
    return {"text_list": list(names),
            "instances": {"boxes": boxes, "scores": rng.uniform(0.05, 1.0, n).astype(np.float32),
                          "classes": classes,
                          "mask_logits": (rng.randn(n, side, side) * 4).astype(np.float32)},
            "sem_seg": rng.randn(len(names) + 1, side, side).astype(np.float32)}


@pytest.fixture
def no_labels(monkeypatch):
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(predictor_lazy, "draw_label", lambda *a, **k: None)


FLAGS = [(b, m, s) for b in (True, False) for m in (True, False) for s in (True, False)]


@pytest.mark.parametrize("shape", ((37, 53), (64, 64), (90, 41)), ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "box%d-mask%d-sseg%d" % f)
def test_draw_equals_jax(no_labels, shape, flags):
    rng = np.random.RandomState(shape[0] + 7 * sum(flags))
    img = image(*shape, seed=shape[1])
    pred = fake_prediction(rng, *shape)
    jv, pv = _demos(0.3)
    kw = dict(with_box=flags[0], with_mask=flags[1], with_sseg=flags[2])
    want = jv.draw(img, pred, **kw)
    got = pv.draw(img, {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                            if k == "instances" else v) for k, v in pred.items()}, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("anchor", ((10.0, 30.0), (3.4, 25.7), (20.6, 5.0), (-1.5, 44.2)))
def test_labels_in_class_colour_at_jax_anchor(monkeypatch, anchor):
    """One instance, labels on: the port's label pixels are the class
    colour, start at JAX's anchor (x0 + 2, max(y0 - 12, 0)) one row down
    (``GLYPH_TOP``), and lie within a pixel of where PIL's FreeType label
    inks."""
    h, w = 60, 120
    img = np.full((h, w, 3), 17, np.uint8)
    x0, y0 = anchor
    pred = {"text_list": ["dog", "person"],
            "instances": {"boxes": np.array([[x0, y0, x0 + 30, y0 + 20]], np.float32),
                          "scores": np.array([0.87], np.float32),
                          "classes": np.array([1])}}
    jv, pv = _demos(0.3)
    colour = draw.palette(2)[1]
    ours = pv.draw(img, pred, with_box=False, with_mask=False) != img
    ours = ours.any(-1)
    got = pv.draw(img, pred, with_box=False, with_mask=False)[ours]
    assert ours.any() and (got == np.array(colour, np.uint8)).all()
    ys, xs = np.nonzero(ours)
    ax, ay = np.floor(x0 + 2), np.floor(max(y0 - 12, 0))
    assert xs.min() >= max(ax, 0) and ys.min() >= ay + draw.GLYPH_TOP
    assert xs.min() <= max(ax, 0) + 2 and ys.max() < ay + draw.GLYPH_TOP + draw.GLYPH_ROWS
    theirs = (jv.draw(img, pred, with_box=False, with_mask=False) != img).any(-1)
    grown = theirs.copy()
    grown[1:] |= theirs[:-1]
    grown[:-1] |= theirs[1:]
    grown[:, 1:] |= grown[:, :-1].copy()
    grown[:, :-1] |= grown[:, 1:].copy()
    assert grown[ours].all()


def test_glyph_table_is_the_default_font():
    """``GLYPHS`` is Pillow's default font (Aileron Regular at 10 px)
    rasterised by FreeType at the origin, coverage >= 128, advances
    rounded: regenerated here, it matches entry for entry."""
    font = ImageFont.load_default(size=10)
    assert font.getname() == ("Aileron", "Regular")
    ascent, descent = font.getmetrics()
    for code, entry in zip(range(32, 127), draw.GLYPHS):
        ch = chr(code)
        canvas = Image.new("L", (24, ascent + descent + 2), 0)
        ImageDraw.Draw(canvas).text((0, 0), ch, fill=255, font=font)
        ink = np.asarray(canvas) >= 128
        advance, bits = draw._GLYPHS[ch]
        assert advance == int(round(font.getlength(ch))), ch
        rows = ink[draw.GLYPH_TOP:draw.GLYPH_TOP + draw.GLYPH_ROWS, :bits.shape[1]]
        np.testing.assert_array_equal(rows, bits, err_msg=ch)
        assert not ink[:, bits.shape[1]:].any() and ink.sum() == bits.sum(), ch
    assert len(draw.GLYPHS) == 95


# --- the CLIs end to end ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """JAX's demo model and tower from its ``build_model``, the class biases
    lifted to 0 (module docstring), and the port's checkpoint of them."""
    import jax.numpy as jnp

    from ape_tpu_torch.checkpoint.convert import language_state_dict_from_jax, state_dict_from_jax
    from demo import demo_lazy as jdemo

    root = tmp_path_factory.mktemp("demo_model")
    cfg = write_config(root)
    ape, size = jdemo.build_model(jdemo.get_parser().parse_args(["--config-file", cfg]))
    flat = {k: np.asarray(v) for k, v in flatten(ape.params).items()}
    for k in flat:
        if k.endswith("/bias0") or k == "enc_class_head_linear/bias":
            flat[k] = np.zeros_like(flat[k])
    ape.params = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    torch.save({"model": state_dict_from_jax(flat)}, root / "weights.pth")
    tower = language_state_dict_from_jax({k: np.asarray(v) for k, v in
                                          flatten(ape.model_language.params).items()})
    return SimpleNamespace(cfg=cfg, ape=ape, size=size, weights=str(root / "weights.pth"),
                           tower=tower)


def _port_tower(monkeypatch, tower):
    from ape_tpu_torch.modeling.text.wrapper import EVA02CLIP

    monkeypatch.setattr(train_net, "build_language",
                        lambda cfg, device: EVA02CLIP(tower, **TOWER, device=device))


def _run_both(jax_model, monkeypatch, tmp_path, argv, tag):
    from demo import demo_lazy as jdemo

    monkeypatch.setattr(jdemo, "build_model", lambda args: (jax_model.ape, jax_model.size))
    monkeypatch.setattr(sys, "argv", ["demo_lazy.py", *argv, "--output", str(tmp_path / f"jax{tag}")])
    jdemo.main()
    records = demo_lazy.main([*argv, "--output", str(tmp_path / f"port{tag}"),
                              "--init-checkpoint", jax_model.weights, "train.device=cpu"])
    return tmp_path / f"jax{tag}", tmp_path / f"port{tag}", records


def _label_cells(rows, threshold, h, w):
    """The pixels either side's labels may touch, grown to the 16-pixel JPEG
    cells (4:2:0 MCUs) that hold them, then by 2 pixels (fancy upsampling
    reads one chroma sample across a cell's edge)."""
    font = ImageFont.load_default()
    touched = np.zeros((h, w), bool)
    for r in rows:
        if r["score"] < threshold:
            continue
        x, y = r["bbox"][:2]
        ax, ay = int(np.floor(x + 2)), int(np.floor(max(y - 12, 0)))
        text = f"{r['category_name']} {r['score']:.2f}"
        width = int(max(font.getlength(text), sum(draw._GLYPHS[c][0] for c in text))) + 3
        touched[max(ay - 1, 0):max(ay + 15, 0), max(ax - 2, 0):max(ax + width, 0)] = True
    cells = touched.reshape(h // 16, 16, w // 16, 16).any((1, 3))
    grown = np.kron(cells, np.ones((16, 16), bool))
    out = grown.copy()
    for d in (1, 2):
        out[d:] |= grown[:-d]
        out[:-d] |= grown[d:]
        out[:, d:] |= grown[:, :-d]
        out[:, :-d] |= grown[:, d:]
    return out


def test_demo_cli_equals_jax(jax_model, monkeypatch, tmp_path):
    _port_tower(monkeypatch, jax_model.tower)
    Image.fromarray(image(64, 64, seed=3)).save(tmp_path / "in.jpg")
    pred = JaxVisualizationDemo(jax_model.ape, jax_model.size).predictor(
        np.asarray(Image.open(tmp_path / "in.jpg").convert("RGB")), text_prompt=PROMPT)
    scores = np.sort(np.asarray(pred["instances"]["scores"]))[::-1]
    threshold = float(scores[DRAWN - 1] + scores[DRAWN]) / 2
    argv = ["--config-file", jax_model.cfg, "--input", str(tmp_path / "in.jpg"),
            "--text-prompt", PROMPT, "--with-mask", "--with-sseg",
            "--confidence-threshold", repr(threshold)]
    jdir, pdir, records = _run_both(jax_model, monkeypatch, tmp_path, argv, "")
    want = json.loads((jdir / "predictions.json").read_text())
    got = json.loads((pdir / "predictions.json").read_text())
    assert len(got) == len(want) == records[0]["instances"] > 3
    for g, w in zip(got, want):
        for k in ("image_id", "category_id", "category_name"):
            assert g[k] == w[k]
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-2)
    assert sum(r["score"] >= threshold for r in want) == DRAWN
    a = np.asarray(Image.open(jdir / "in.jpg"))
    b = np.asarray(Image.open(pdir / "in.jpg"))
    assert a.shape == b.shape == (64, 64, 3)
    skip = _label_cells(want, threshold, 64, 64) | _label_cells(got, threshold, 64, 64)
    print(f"compared {(~skip).mean():.3f} of the overlay outside the label cells")
    assert (~skip).mean() > 0.2
    np.testing.assert_array_equal(a[~skip], b[~skip])
    assert set(records[0]) == {"path", "instances", "device", "draw", "write"}
    # labels stubbed on both sides: the overlays' bytes are equal
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(predictor_lazy, "draw_label", lambda *a, **k: None)
    jdir, pdir, _ = _run_both(jax_model, monkeypatch, tmp_path, argv, "_stubbed")
    assert (pdir / "in.jpg").read_bytes() == (jdir / "in.jpg").read_bytes()


def test_visualize_json_results_equals_jax(monkeypatch, tmp_path):
    import tools.visualize_json_results as jvis

    rng = np.random.RandomState(4)
    (tmp_path / "img").mkdir()
    rows = []
    for i, (h, w) in enumerate(((40, 56), (63, 31))):
        Image.fromarray(image(h, w, seed=i)).save(tmp_path / "img" / f"{i}.jpg")
        for j in range(5):
            x, y = rng.uniform(-10, w), rng.uniform(-10, h)
            rows.append({"image_id": f"{i}.jpg", "category_id": j,
                         **({"category_name": f"c{j}"} if j != 2 else {}),
                         "bbox": [x, y, rng.uniform(0, w), rng.uniform(0, h)],
                         "score": float(rng.uniform(0.1, 1.0))})
    rows.append({"image_id": "missing.jpg", "category_id": 0, "bbox": [0, 0, 1, 1], "score": 1.0})
    (tmp_path / "p.json").write_text(json.dumps(rows))
    args = ["--input", str(tmp_path / "p.json"), "--image-root", str(tmp_path / "img")]
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(draw, "draw_label", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["visualize_json_results.py", *args, "--output",
                                      str(tmp_path / "jax")])
    jvis.main()
    written = visualize_json_results.main([*args, "--output", str(tmp_path / "port")])
    assert sorted(Path(p).name for p in written) == ["0.jpg", "1.jpg"]
    for name in ("0.jpg", "1.jpg"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# --- the OpenCV paths -----------------------------------------------------------

def test_async_predictor_order_and_errors():
    class Slow:
        def run_on_image(self, image, **kw):
            time.sleep(0.02 * (3 - int(image[0, 0, 0]) % 3))
            if kw.get("fail"):
                raise ValueError("bad frame")
            return {"i": int(image[0, 0, 0])}, threading.get_ident()

    ap = predictor_lazy.AsyncPredictor(Slow(), buffer_size=2)
    for i in range(5):
        ap.put(i, np.full((2, 2, 3), i, np.uint8))
    out = [ap.get() for _ in range(5)]
    assert [idx for idx, _ in out] == list(range(5))
    assert [res[0]["i"] for _, res in out] == list(range(5))
    assert {res[1] for _, res in out} == {ap._thread.ident}
    ap.put(5, np.zeros((2, 2, 3), np.uint8), fail=True)
    with pytest.raises(ValueError, match="bad frame"):
        ap.get()
    ap.shutdown()
    ap._thread.join(5)
    assert not ap._thread.is_alive()


def test_grabcut_and_video_equal_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from demo import predictor_lazy as jpl

    img = image(48, 64, seed=5)
    img[10:38, 14:50] = (200, 60, 40)
    mask = np.zeros((48, 64), np.float32)
    mask[12:36, 16:48] = 1
    np.testing.assert_array_equal(predictor_lazy.grabcut_refine(img, mask),
                                  jpl.grabcut_refine(img, mask))
    small = np.zeros((48, 64), np.float32)
    small[:3, :3] = 1  # under 16 pixels: returned as given by both
    np.testing.assert_array_equal(predictor_lazy.grabcut_refine(img, small), small)

    path = str(tmp_path / "v.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    for i in range(6):
        writer.write(np.full((24, 32, 3), 30 * i, np.uint8))
    writer.release()

    class Echo:
        def run_on_image(self, image, **kw):
            return {}, image[::-1].copy()

    got = list(predictor_lazy.run_on_video(Echo(), path, max_frames=5))
    want = list(jpl.run_on_video(Echo(), path, max_frames=5))
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_opencv_paths_raise_without_cv2(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    mask = np.ones((8, 8), np.float32)
    with pytest.raises(ImportError, match="cv2"):
        predictor_lazy.grabcut_refine(np.zeros((8, 8, 3), np.uint8), mask)
    with pytest.raises(ImportError, match="cv2"):
        next(predictor_lazy.run_on_video(object(), "v.avi"))
    with pytest.raises(ImportError, match="cv2"):
        demo_lazy.main(["--config-file", str(TINY), "--video-input", "v.avi"], device="cpu")
    jv, pv = _demos(0.0)
    pred = fake_prediction(np.random.RandomState(0), 24, 24, n=2)
    with pytest.raises(ImportError, match="cv2"):
        pv.draw(image(24, 24), pred, grabcut=True)


def test_import_closure_decode_draw_encode_serve(tmp_path):
    """In a fresh interpreter that refuses PIL, cv2, jax, flax and the JAX
    package: decode a JPEG, draw a prediction, encode, and one tiny request
    through ``demo_lazy.main`` on the CPU (random weights from the config's
    seed, the config's one-layer tower). torch on two threads, so that
    beside the suite's other workers it does not take every core."""
    Image.fromarray(image(64, 64, seed=8)).save(tmp_path / "in.jpg")
    cfg = write_config(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "cv2", "ape_tpu",
                                          "experiments"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import numpy as np, torch
        torch.set_num_threads(2)
        from ape_tpu_torch.data.image_io import read_image
        from ape_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
        from ape_tpu_torch.demo import demo_lazy, predictor_lazy
        img = read_image({str(tmp_path / 'in.jpg')!r})
        assert img.shape == (64, 64, 3)
        demo = predictor_lazy.VisualizationDemo.__new__(predictor_lazy.VisualizationDemo)
        demo.threshold = 0.0
        rng = np.random.RandomState(0)
        pred = {{"text_list": ["a", "b"], "sem_seg": rng.randn(2, 16, 16).astype(np.float32),
                 "instances": {{"boxes": np.array([[3.5, 4.2, 40.1, 50.7]], np.float32),
                               "scores": np.array([0.9], np.float32), "classes": np.array([1]),
                               "mask_logits": rng.randn(1, 16, 16).astype(np.float32)}}}}
        vis = demo.draw(img, pred, with_mask=True, with_sseg=True)
        assert decode_jpeg(encode_jpeg(vis)).shape == (64, 64, 3)
        records = demo_lazy.main(["--config-file", {cfg!r}, "--input", {str(tmp_path / 'in.jpg')!r},
                                  "--output", {str(tmp_path / 'out')!r}, "--text-prompt", "a,b",
                                  "--with-mask", "train.device=cpu"])
        assert len(records) == 1 and read_image({str(tmp_path / 'out' / 'in.jpg')!r}).shape == (64, 64, 3)
        for name in ("jax", "flax", "PIL", "cv2", "ape_tpu"):
            assert name not in sys.modules, name
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-4000:]
