"""The port's PIL-free data path against JAX's (which reads and resizes
through PIL): the PNG reader, PIL's bilinear and nearest resizes and
polygon fill bit for bit, the RLE codec, the COCO loader, the instance
mapper, the samplers and the train loader, on seeded inputs."""

import dataclasses
import io
import json

import numpy as np
import pytest
from PIL import Image, ImageDraw

from ape_tpu.data import build as j_build
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data import samplers as j_samplers
from ape_tpu.data import transforms as j_transforms
from ape_tpu.data.catalog import DatasetCatalog as JDatasetCatalog
from ape_tpu.data.catalog import MetadataCatalog as JMetadataCatalog
from ape_tpu.data.datasets.coco import load_coco_json as j_load_coco_json
from ape_tpu_torch.data import build, samplers, transforms
from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from ape_tpu_torch.data.datasets.coco import load_coco_json, register_coco_instances
from ape_tpu_torch.data.image_io import decode_png, read_image, write_png
from ape_tpu_torch.data.mapper import DatasetMapperDETR

CASES = 240  # seeded cases a resize or fill test holds bit for bit


# --- PNG ---------------------------------------------------------------------

def _pil_png(rng, mode):
    h, w = rng.randint(1, 40, 2)
    if mode == "P":
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        return Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                            colors=int(rng.randint(2, 256)))
    if mode == "P4":  # a 16-colour palette, saved at 4 bits
        return Image.fromarray(rng.randint(0, 16, (h, w)).astype(np.uint8), "L").convert("P")
    if mode == "1":
        return Image.fromarray(rng.rand(h, w) > 0.5).convert("1")
    c = len(mode)
    return Image.fromarray(rng.randint(0, 256, (h, w, c) if c > 1 else (h, w)).astype(np.uint8),
                           mode)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P4", "1"])
def test_png_read_equals_pil(mode):
    """Every supported PNG type, at three compressions (PIL's optimizer
    picks every filter type), decodes to PIL's convert("RGB")."""
    rng = np.random.RandomState(len(mode))
    for k in range(12):
        im = _pil_png(rng, mode)
        buf = io.BytesIO()
        kw = {"bits": 4} if mode == "P4" else {}
        im.save(buf, "PNG", compress_level=(0, 1, 9)[k % 3], optimize=k % 3 == 2, **kw)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(decode_png(buf.getvalue()), want)


def test_png_writer_files_and_errors(tmp_path):
    rng = np.random.RandomState(0)
    for c in (1, 3, 4):
        arr = rng.randint(0, 256, (17, 23, c) if c > 1 else (17, 23)).astype(np.uint8)
        write_png(str(tmp_path / "a.png"), arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)
        np.testing.assert_array_equal(read_image(str(tmp_path / "a.png")),
                                      np.asarray(Image.open(tmp_path / "a.png").convert("RGB")))
    np.save(tmp_path / "b.npy", arr[..., :3])
    np.testing.assert_array_equal(read_image(str(tmp_path / "b.npy")), arr[..., :3])
    Image.fromarray(arr[..., :3]).save(tmp_path / "c.jpg")
    with pytest.raises(ValueError, match="JPEG.*ROADMAP"):
        read_image(str(tmp_path / "c.jpg"))
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 0xFF  # a damaged chunk: its CRC fails
    (tmp_path / "d.png").write_bytes(bytes(data))
    assert read_image(str(tmp_path / "d.png")) is None
    (tmp_path / "e.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="PNG and .npy"):
        read_image(str(tmp_path / "e.gif"))


# --- resizes and polygons ----------------------------------------------------

def test_bilinear_rgb_resize_equals_pil():
    rng = np.random.RandomState(1)
    for _ in range(CASES):
        h, w = rng.randint(1, 120, 2)
        nh, nw = rng.randint(1, 200, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(transforms.resize_image(img, nh, nw),
                                      j_transforms.resize_image(img, nh, nw))


def test_nearest_resize_equals_pil():
    rng = np.random.RandomState(2)
    for k in range(CASES):
        h, w = rng.randint(1, 150, 2)
        nh, nw = rng.randint(1, 250, 2)
        if k % 4 == 0:  # exact multiples and halves
            nh, nw = h * int(rng.randint(1, 4)), max(1, w // 2)
        m = (rng.rand(h, w) > 0.5).astype(np.uint8) * 255
        np.testing.assert_array_equal(transforms.resize_nearest(m, nh, nw),
                                      j_transforms.resize_nearest(m, nh, nw))


def _pil_fill(polys, h, w):
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, bool)


def _polygon_case(rng, k):
    """Seeded polygons over the edge cases: horizontal edges, vertices on
    pixel centres, slivers under a pixel wide, self-intersecting paths,
    vertices outside the image, and COCO-like convex outlines."""
    w, h = rng.randint(5, 60, 2)
    nv = int(rng.randint(3, 12))
    kind = k % 7
    if kind == 0:
        xy = rng.uniform(-6, max(w, h) + 6, (nv, 2))
    elif kind == 1:
        xy = rng.randint(-2, max(w, h) + 2, (nv, 2)).astype(float)
    elif kind == 2:  # on pixel centres
        xy = rng.randint(0, max(w, h), (nv, 2)) + 0.5
    elif kind == 3:  # axis-aligned: horizontal edges, runs of them
        xs, ys = rng.randint(0, w, 3), rng.randint(0, h, 2)
        xy = np.array([[xs[0], ys[0]], [xs[1], ys[0]], [xs[2], ys[0]], [xs[2], ys[1]],
                       [xs[0], ys[1]]], float)
    elif kind == 4:  # a sliver narrower than a pixel
        x, (y0, y1) = rng.uniform(0, w), rng.uniform(0, h, 2)
        xy = np.array([[x, y0], [x + rng.uniform(0, 0.9), y1], [x + 0.3, y1]])
    elif kind == 5:  # a self-intersecting star
        ang = np.arange(5) * 4 * np.pi / 5
        xy = np.stack([w / 2 + w / 2 * np.cos(ang), h / 2 + h / 2 * np.sin(ang)], 1)
    else:  # a COCO-like outline
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        r = rng.uniform(2, max(w, h) / 2) * rng.uniform(0.5, 1, nv)
        xy = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    return [xy.ravel().tolist()], h, w


def test_polygon_fill_equals_pil():
    rng = np.random.RandomState(3)
    for k in range(CASES * 2):
        polys, h, w = _polygon_case(rng, k)
        if k % 11 == 0:  # two polygons of one annotation
            polys += _polygon_case(rng, k + 1)[0]
        np.testing.assert_array_equal(transforms.polygons_to_mask(polys, h, w),
                                      _pil_fill(polys, h, w), err_msg=str((polys, h, w)))


def test_polygon_fill_large_outlines_equal_pil():
    """Outlines of up to 120 vertices over images up to 700 pixels."""
    rng = np.random.RandomState(4)
    for k in range(40):
        w, h = rng.randint(50, 700, 2)
        nv = int(rng.randint(3, 120))
        if k % 2:
            c, r = rng.uniform(0, [w, h]), rng.uniform(5, 200)
            ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
            xy = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
        else:
            xy = rng.uniform(-20, max(w, h) + 20, (nv, 2))
        polys = [xy.ravel().tolist()]
        np.testing.assert_array_equal(transforms.polygons_to_mask(polys, h, w),
                                      _pil_fill(polys, h, w))


def test_rle_codec_equals_jax():
    rng = np.random.RandomState(5)
    for k in range(60):
        h, w = rng.randint(1, 50, 2)
        m = rng.rand(h, w) > rng.uniform(0.1, 0.9)
        if k % 5 == 0:
            m[:] = k % 2 == 0
        enc = transforms.rle_encode(m)
        assert enc == j_transforms.rle_encode(m)
        np.testing.assert_array_equal(transforms.rle_decode(enc), m)
        np.testing.assert_array_equal(transforms.rle_decode(enc, h, w),
                                      j_transforms.rle_decode(enc, h, w))
        other = transforms.rle_encode(rng.rand(h, w) > 0.5)
        assert transforms.rle_iou(enc, other) == j_transforms.rle_iou(enc, other)
        counts = transforms._rle_string_to_counts(enc["counts"])
        assert counts == j_transforms._rle_string_to_counts(enc["counts"])


# --- the COCO loader, the mapper --------------------------------------------

def write_dataset(root, n=6, seed=0, ncat=5):
    """PNG images of three sizes with polygon, RLE and crowd annotations, one
    image without any; returns (json file, image root)."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    (root / "img").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = ((48, 64), (64, 40), (43, 64))[i % 3]
        write_png(str(root / "img" / f"{i}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": h, "width": w})
        for j in range(0 if i == n - 1 else int(rng.randint(1, 6))):
            x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(3, w - x0), rng.uniform(3, h - y0)
            poly = [x0, y0, x0 + bw, y0 + 0.5, x0 + bw * 0.7, y0 + bh, x0, y0 + bh * 0.8]
            seg = [poly]
            if j == 1:
                seg = transforms.rle_encode(transforms.polygons_to_mask([poly], h, w))
                seg["counts"] = seg["counts"].decode()
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": int(rng.choice([1, 3, 7, 9, 11][:ncat])),
                         "bbox": [x0, y0, bw, bh], "iscrowd": int(j == 2), "segmentation": seg,
                         "area": bw * bh})
    cats = [{"id": c, "name": f"cat{c}"} for c in [1, 3, 7, 9, 11][:ncat]]
    (root / "ann.json").write_text(json.dumps({"images": images, "annotations": anns,
                                               "categories": cats}))
    return str(root / "ann.json"), str(root / "img")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("coco"))


def test_load_coco_json_equals_jax(dataset):
    js, root = dataset
    assert load_coco_json(js, root, "port_data_test") == j_load_coco_json(js, root, "jax_data_test")
    want = JMetadataCatalog.get("jax_data_test")
    got = MetadataCatalog.get("port_data_test")
    for k in ("thing_classes", "thing_dataset_id_to_contiguous_id"):
        assert got.get(k) == want.get(k)


def _same_example(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["image_size"], want["image_size"])
    assert dataclasses.astuple(got["transform"]) == dataclasses.astuple(want["transform"])
    for k in ("height", "width", "image_id"):
        assert got[k] == want[k]
    if "targets" in want:
        assert got["phrases"] == want["phrases"]
        for k, v in want["targets"].items():
            if k == "boxes":
                np.testing.assert_allclose(got["targets"][k], v, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got["targets"][k], v)


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_equals_jax(dataset, is_train):
    """Train (LSJ: the seeded draws, resizes, flips, crops, polygons and RLE
    rasterized and resized) and eval (shortest edge and pad): images and
    masks exact, boxes within 1e-6."""
    js, root = dataset
    dicts = load_coco_json(js, root)
    kw = dict(is_train=is_train, image_size=96, max_gt=6, mask_size=24, seed=3)
    port, jax_ = DatasetMapperDETR(**kw), j_mapper.DatasetMapperDETR(**kw)
    for rep in range(3):
        for d in dicts:
            _same_example(port(d), jax_(d))


def test_samplers_equal_jax(dataset):
    js, root = dataset
    dicts = load_coco_json(js, root)

    def first(s, n=40):
        it = iter(s)
        return [next(it) for _ in range(n)]

    for seed, rank, world in ((0, 0, 1), (5, 1, 3)):
        assert first(samplers.TrainingSampler(11, True, seed, rank, world)) == \
            first(j_samplers.TrainingSampler(11, True, seed, rank, world))
        rf = samplers.repeat_factors_from_category_frequency(dicts, 0.5)
        np.testing.assert_array_equal(rf, j_samplers.repeat_factors_from_category_frequency(
            dicts, 0.5))
        assert first(samplers.RepeatFactorTrainingSampler(rf, seed, rank, world)) == \
            first(j_samplers.RepeatFactorTrainingSampler(rf, seed, rank, world))
        assert first(samplers.ClassAwareSampler(dicts, seed, rank, world)) == \
            first(j_samplers.ClassAwareSampler(dicts, seed, rank, world))
        assert list(samplers.InferenceSampler(11, rank, world)) == \
            list(j_samplers.InferenceSampler(11, rank, world))
    mds, jmds = samplers.MultiDatasetSampler([1.0, 3.0, 0.5], 2), \
        j_samplers.MultiDatasetSampler([1.0, 3.0, 0.5], 2)
    assert [mds.next_dataset() for _ in range(50)] == [jmds.next_dataset() for _ in range(50)]


def test_train_loader_equals_jax_and_resumes(dataset):
    js, root = dataset
    register_coco_instances("port_loader_test", {}, js, root)
    JDatasetCatalog.register("jax_loader_test", lambda: j_load_coco_json(js, root))
    kw = dict(is_train=True, image_size=64, max_gt=5, mask_size=16, seed=1)
    port = build.build_detection_train_loader(["port_loader_test"], DatasetMapperDETR(**kw), 2,
                                              "RepeatFactorTrainingSampler", seed=4)
    jax_ = j_build.build_detection_train_loader(["jax_loader_test"], j_mapper.DatasetMapperDETR(**kw),
                                                2, "RepeatFactorTrainingSampler", seed=4)
    it, jit = iter(port), iter(jax_)
    got = [next(it) for _ in range(4)]
    for g in got:
        w = next(jit)
        assert g["dataset_id"] == w["dataset_id"] and g["image_id"] == w["image_id"]
        np.testing.assert_array_equal(g["images"], w["images"])
        for k, v in w["targets"].items():
            np.testing.assert_array_equal(g["targets"][k], v)
    # restart a new loader at the position after the second batch
    port2 = build.build_detection_train_loader(["port_loader_test"], DatasetMapperDETR(**kw), 2,
                                               "RepeatFactorTrainingSampler", seed=4)
    fresh = iter(port2)
    next(fresh), next(fresh)
    state = port2.state_dict()
    port.close()
    port3 = build.build_detection_train_loader(["port_loader_test"], DatasetMapperDETR(**kw), 2,
                                               "RepeatFactorTrainingSampler", seed=4)
    port3.load_state_dict(state)
    resumed = iter(port3)
    for g in got[2:]:
        np.testing.assert_array_equal(next(resumed)["images"], g["images"])
    port2.close()
    port3.close()


def test_loader_worker_error_fails_the_step(dataset):
    js, root = dataset
    dicts = load_coco_json(js, root)

    def broken(d):
        raise OSError("disk gone")

    loader = build.TrainLoader(dicts, broken, 2)
    with pytest.raises(RuntimeError, match="data loader worker failed"):
        next(iter(loader))
    with pytest.raises(NotImplementedError, match="copy-paste"):
        build.build_detection_train_loader(["port_loader_test"], DatasetMapperDETR(), 2,
                                           copypaste_prob=0.5)


def test_test_loader_equals_jax(dataset):
    js, root = dataset
    register_coco_instances("port_eval_test", {}, js, root)
    JDatasetCatalog.register("jax_eval_test", lambda: j_load_coco_json(js, root))
    kw = dict(is_train=False, image_size=64)
    got = list(build.build_detection_test_loader("port_eval_test", DatasetMapperDETR(**kw))())
    want = list(j_build.build_detection_test_loader("jax_eval_test",
                                                    j_mapper.DatasetMapperDETR(**kw))())
    assert len(got) == len(want) == len(DatasetCatalog.get("port_eval_test"))
    for g, w in zip(got, want):
        g.pop("dataset_dict"), w.pop("dataset_dict")
        _same_example(g, w)
