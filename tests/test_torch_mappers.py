"""The port's semantic, panoptic and copy-paste data paths against JAX's
(which read, resize and blur through PIL), bit for bit: the label-map
reader against ``np.asarray(Image.open(f))``, PIL's Gaussian blur in NumPy,
``connected_components`` (the list, its order and its pixels),
``DatasetMapperSemantic`` and ``DatasetMapperPanoptic`` (with and without
the stuff decomposition), ``copypaste`` through its blend and plain paths,
``CopyPasteMapper`` over a pool of records, and the train loader with
``copypaste_prob`` 0.5 and its resume, on seeded inputs."""

import numpy as np
import pytest
from PIL import Image, ImageFilter

from ape_tpu.data import build as j_build
from ape_tpu.data import copypaste as j_copypaste
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data import mapper_panoptic as j_panoptic
from ape_tpu.data.catalog import DatasetCatalog as JDatasetCatalog
from ape_tpu.data.datasets.coco import load_coco_json as j_load_coco_json
from ape_tpu_torch.data import build, copypaste, mapper, mapper_panoptic
from ape_tpu_torch.data.datasets.coco import load_coco_json, register_coco_instances
from ape_tpu_torch.data.image_io import read_label_map, read_rgb, write_png
from tests.test_torch_data import _same_example, write_dataset


# --- readers and the blur -----------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "P", "LA", "RGB", "RGBA"])
def test_label_map_read_equals_pil(tmp_path, mode):
    """Palette indices kept (not looked up), gray as stored, LA, RGB and RGBA
    as they are: the array, its dtype and shape, of PNGs PIL writes."""
    rng = np.random.RandomState(len(mode))
    for k in range(8):
        h, w = rng.randint(1, 50, 2)
        if mode == "P":
            im = Image.fromarray(rng.randint(0, 60, (h, w)).astype(np.uint8), "P")
            im.putpalette(list(rng.randint(0, 256, 768).astype(np.uint8)))
        else:
            c = len(mode)
            im = Image.fromarray(rng.randint(0, 256, (h, w, c) if c > 1 else (h, w))
                                 .astype(np.uint8), mode)
        f = tmp_path / f"{k}.png"
        im.save(f, compress_level=(0, 1, 9)[k % 3], optimize=k % 3 == 2)
        want = np.asarray(Image.open(f))
        got = read_label_map(str(f))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_rgb(str(f)), np.asarray(Image.open(f).convert("RGB")))


def test_label_map_refuses_other_formats(tmp_path):
    f = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(f)
    with pytest.raises(ValueError, match="PNG"):
        read_label_map(str(f))


def test_gaussian_blur_equals_pil():
    """0/255 masks and gray noise of 1-300 pixels a side, at the copy-paste
    radius and three others."""
    rng = np.random.RandomState(0)
    for k in range(30):
        h, w = rng.randint(1, 300, 2)
        x = ((rng.rand(h, w) > rng.rand()) * 255 if k % 2 else rng.randint(0, 256, (h, w)))
        x = x.astype(np.uint8)
        for r in (5.0, 0.7, 2.3, 11.0):
            want = np.asarray(Image.fromarray(x).filter(ImageFilter.GaussianBlur(r)))
            np.testing.assert_array_equal(copypaste.gaussian_blur(x, r), want)


def test_connected_components_equal_jax():
    """Random masks (sparse to dense, with one-pixel lines): the same
    components in the same order."""
    rng = np.random.RandomState(1)
    for k in range(25):
        h, w = rng.randint(1, 40, 2)
        mask = rng.rand(h, w) < rng.uniform(0.1, 0.7)
        if k % 5 == 0:
            mask[:, rng.randint(w)] = True
        got = mapper_panoptic.connected_components(mask)
        want = j_panoptic.connected_components(mask)
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype and g.shape == wnt.shape
            np.testing.assert_array_equal(g, wnt)
    assert mapper_panoptic.connected_components(np.zeros((3, 4), bool)) == []


# --- the semantic and panoptic mappers -----------------------------------------

def _write_images(root, rng, n, sizes=((40, 52), (52, 36), (33, 48))):
    files = []
    (root / "img").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        f = root / "img" / f"{i}.png"
        write_png(str(f), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        files.append((str(f), h, w))
    return files


def _blobs(rng, h, w, n):
    """A label map of n blob regions on a background label."""
    out = np.zeros((h, w), np.int64)
    yy, xx = np.mgrid[:h, :w]
    for k in range(1, n + 1):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, max(h, w) / 3)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = k
    return out


def test_semantic_mapper_equals_jax(tmp_path):
    """Label maps as gray PNGs and as palette PNGs (indices, not colours),
    with the ignore label, through LSJ: the example bit for bit."""
    rng = np.random.RandomState(2)
    records = []
    for k, (f, h, w) in enumerate(_write_images(tmp_path, rng, 6)):
        labels = (_blobs(rng, h, w, 4) * 7 % 30).astype(np.uint8)
        labels[rng.rand(h, w) < 0.05] = 255
        gt = tmp_path / f"gt{k}.png"
        if k % 2:
            im = Image.fromarray(labels, "P")
            im.putpalette(list(rng.randint(0, 256, 768).astype(np.uint8)))
            im.save(gt)
        else:
            Image.fromarray(labels).save(gt)
        records.append({"file_name": f, "sem_seg_file_name": str(gt), "image_id": k})
    kw = dict(is_train=True, image_size=64, max_gt=8, mask_size=16, seed=4)
    port, jax_ = mapper.DatasetMapperSemantic(**kw), j_mapper.DatasetMapperSemantic(**kw)
    for rep in range(2):
        for r in records:
            _same_example(port(r), jax_(r))


def _pan_record(root, rng, k, f, h, w):
    """A panoptic PNG (ids coded R + 256 G + 256^2 B) of things and stuff
    regions, stuff with several components, and its segments_info (one
    segment absent from the map)."""
    labels = _blobs(rng, h, w, 5)
    ids = labels * 1000 + 7
    info = []
    for j in range(6):
        info.append({"id": int(j * 1000 + 7), "category_id": int(rng.randint(0, 20)),
                     "isthing": int(j % 2 == 1)})
    info.append({"id": 999999, "category_id": 3, "isthing": 0})  # not in the map
    rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
    pan = root / f"pan{k}.png"
    Image.fromarray(rgb).save(pan)
    return {"file_name": f, "pan_seg_file_name": str(pan), "segments_info": info, "image_id": k,
            "annotations": [] if k % 3 else [{"bbox": [1.0, 1.0, 9.0, 9.0], "category_id": 2,
                                               "segmentation": [[1.0, 1.0, 9.0, 1.0, 9.0, 9.0]]}]}


@pytest.mark.parametrize("decompose", [False, True])
def test_panoptic_mapper_equals_jax(tmp_path, decompose):
    rng = np.random.RandomState(3)
    records = [_pan_record(tmp_path, rng, k, f, h, w)
               for k, (f, h, w) in enumerate(_write_images(tmp_path, rng, 6))]
    kw = dict(is_train=True, image_size=64, max_gt=12, mask_size=16, seed=5,
              stuff_classes_offset=80, stuff_classes_decomposition=decompose)
    port, jax_ = (mapper_panoptic.DatasetMapperPanoptic(**kw),
                  j_panoptic.DatasetMapperPanoptic(**kw))
    for rep in range(2):
        for r in records:
            got, want = port(r), jax_(r)
            _same_example(got, want)
    assert (got["targets"]["valid"] & ~got["targets"]["is_thing"]).any()
    np.testing.assert_array_equal(mapper_panoptic.rgb2id(np.asarray(Image.open(
        records[0]["pan_seg_file_name"]))), j_panoptic.rgb2id(np.asarray(Image.open(
            records[0]["pan_seg_file_name"]))))


# --- copy-paste ------------------------------------------------------------------

def _example(rng, n_valid, size=64, mask_size=16, slots=6, blob=4):
    masks = np.zeros((slots, mask_size, mask_size), np.float32)
    for i in range(n_valid):
        y, x = rng.randint(0, mask_size - blob, 2)
        s = rng.randint(2, blob + 1)
        masks[i, y:y + s + 2, x:x + s + 2] = 1
    return {"image": rng.randn(size, size, 3).astype(np.float32),
            "targets": {"labels": rng.randint(0, 9, slots).astype(np.int32),
                        "boxes": (rng.rand(slots, 4) * 0.3 + 0.2).astype(np.float32),
                        "valid": np.arange(slots) < n_valid,
                        "is_thing": np.ones(slots, bool), "masks": masks}}


def _same_paste(got, want):
    assert sorted(got) == sorted(want)
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    for k, v in want["targets"].items():
        assert got["targets"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["targets"][k], v)


@pytest.mark.parametrize("blend", [True, False])
def test_copypaste_equals_jax(blend):
    """The blend path (masks of at least blend_min_area canvas pixels: PIL's
    Gaussian blur, the 0.5 clamps, the f32 blend) and the plain path (small
    masks), with full backgrounds and pastes onto occupied pixels."""
    rng = np.random.RandomState(6 + blend)
    for k in range(8):
        fg = _example(rng, int(rng.randint(1, 5)), blob=8 if blend else 3)
        bg = _example(rng, int(rng.randint(0, 4)))
        kw = dict(blend_min_area=64 if blend else 10 ** 6)
        got = copypaste.copypaste(fg, bg, np.random.RandomState(k), **kw)
        want = j_copypaste.copypaste(fg, bg, np.random.RandomState(k), **kw)
        _same_paste(got, want)
        assert got["copypaste"] == 1


def _records(tmp_path, n=10, seed=7):
    js, root = write_dataset(tmp_path / "cp", n=n, seed=seed)
    return js, root, load_coco_json(js, root)


def test_copypaste_mapper_equals_jax(tmp_path):
    """About 10 records through CopyPasteMapper at prob 0.5 over their own
    pool: the draws (the base mapper's, then rand and randint, then the
    background's) in JAX's order, each example bit for bit."""
    _, _, dicts = _records(tmp_path)
    kw = dict(is_train=True, image_size=64, max_gt=8, mask_size=16, seed=2)
    port = copypaste.CopyPasteMapper(mapper.DatasetMapperDETR(**kw), dicts, prob=0.5, seed=3)
    jax_ = j_copypaste.CopyPasteMapper(j_mapper.DatasetMapperDETR(**kw), dicts, prob=0.5, seed=3)
    pasted = 0
    for rep in range(2):
        for d in dicts:
            got, want = port(d), jax_(d)
            _same_example({k: v for k, v in got.items() if k != "copypaste"},
                          {k: v for k, v in want.items() if k != "copypaste"})
            assert got.get("copypaste") == want.get("copypaste")
            pasted += got.get("copypaste", 0)
    assert 0 < pasted < 2 * len(dicts)


def test_copypaste_loader_equals_jax_and_resumes(tmp_path):
    """build_detection_train_loader with copypaste_prob=0.5 (the wiring of
    tests/test_data.py's copy-paste loader test): batches equal JAX's; a new
    loader restarted at the second batch's state (both generators) reads the
    same third and fourth batches."""
    js, root, _ = _records(tmp_path)
    register_coco_instances("port_cp_loader", {}, js, root)
    JDatasetCatalog.register("jax_cp_loader", lambda: j_load_coco_json(js, root))
    kw = dict(is_train=True, image_size=64, max_gt=8, mask_size=16, seed=1)

    def port_loader():
        return build.build_detection_train_loader(["port_cp_loader"], mapper.DatasetMapperDETR(**kw),
                                                  2, seed=4, copypaste_prob=0.5)

    port = port_loader()
    jax_ = j_build.build_detection_train_loader(["jax_cp_loader"], j_mapper.DatasetMapperDETR(**kw),
                                                2, seed=4, copypaste_prob=0.5)
    assert isinstance(port.mapper, copypaste.CopyPasteMapper)
    it, jit = iter(port), iter(jax_)
    got = [next(it) for _ in range(4)]
    for g in got:
        w = next(jit)
        assert g["image_id"] == w["image_id"]
        np.testing.assert_array_equal(g["images"], w["images"])
        for k, v in w["targets"].items():
            np.testing.assert_array_equal(g["targets"][k], v)
    assert sum(g["copypaste"] for g in got) > 0
    port.close()
    first = port_loader()
    fresh = iter(first)
    next(fresh), next(fresh)
    state = first.state_dict()
    first.close()
    resumed = port_loader()
    resumed.load_state_dict(state)
    rit = iter(resumed)
    for g in got[2:]:
        b = next(rit)
        np.testing.assert_array_equal(b["images"], g["images"])
        np.testing.assert_array_equal(b["targets"]["masks"], g["targets"]["masks"])
    resumed.close()


def test_blur_of_a_mask_box_equals_the_whole_blur():
    """The copy-paste blend blurs the mask's box grown by the blur's reach:
    the same pixels as PIL's blur of the whole canvas, masks at the edges
    and corners included."""
    rng = np.random.RandomState(8)
    for k in range(30):
        h, w = rng.randint(20, 200, 2)
        m = np.zeros((h, w), np.uint8)
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, 40), x:x + rng.randint(1, 40)] = 255
        want = np.asarray(Image.fromarray(m).filter(ImageFilter.GaussianBlur(5.0)))
        np.testing.assert_array_equal(copypaste._blurred_mask(m, 5.0), want)
