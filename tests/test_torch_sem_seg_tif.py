"""Reference trait 31 on the CPU: JAX's ``load_sem_seg`` globs label files
by ``gt_ext=".png"`` only, so a registered semantic dataset whose labels are
TIFF files (the repository's ADE20k-full and PASCAL-Context-459 preparation
scripts write them) loads no record, in JAX and in the port alike; and a
record that names a ``.tif`` label directly is read by both semantic
mappers the same way (uint16 labels as ``np.asarray(Image.open(f))`` gives
them)."""

import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data.datasets.coco import load_sem_seg as j_load_sem_seg
from ape_tpu_torch.data import mapper
from ape_tpu_torch.data.datasets.coco import load_sem_seg
from ape_tpu_torch.data.image_io import write_png
from test_torch_data import _same_example


def _labels(rng, h, w, top):
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((h, w), np.int64)
    for k in range(1, 6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, max(h, w) / 3)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(1, top)
    out[rng.rand(h, w) < 0.03] = 255
    return out


def _write(tmp_path, n=4):
    rng = np.random.RandomState(31)
    (tmp_path / "img").mkdir()
    (tmp_path / "gt").mkdir()
    records = []
    for k in range(n):
        h, w = ((40, 52), (37, 29))[k % 2]
        img = tmp_path / "img" / f"{k}.jpg"
        write_png(str(img), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))  # a PNG named .jpg
        labels = _labels(rng, h, w, 847)
        gt = tmp_path / "gt" / f"{k}.tif"
        if k % 2:  # LZW, predictor 2, as a TIFF tool may write it
            gt.write_bytes(W.tiff(labels.astype(np.uint16), photometric=1, bits=16,
                                  compression=5, predictor=2))
        else:  # PIL's writer, as the preparation scripts use it
            Image.fromarray(labels.astype(np.uint16)).save(gt, "TIFF")
        records.append({"file_name": str(img), "sem_seg_file_name": str(gt), "image_id": k})
    return records


def test_loaders_find_no_tif_labels(tmp_path):
    _write(tmp_path)
    gt, img = str(tmp_path / "gt"), str(tmp_path / "img")
    assert j_load_sem_seg(gt, img) == [] == load_sem_seg(gt, img)
    assert load_sem_seg(gt, img, gt_ext=".tif") == j_load_sem_seg(gt, img, gt_ext=".tif")
    assert len(load_sem_seg(gt, img, gt_ext=".tif")) == 4


@pytest.mark.parametrize("is_train", (True, False))
def test_semantic_mappers_read_a_named_tif_label_alike(tmp_path, is_train):
    records = _write(tmp_path)
    kw = dict(is_train=is_train, image_size=64, max_gt=8, mask_size=16, seed=4)
    port, jax_ = mapper.DatasetMapperSemantic(**kw), j_mapper.DatasetMapperSemantic(**kw)
    for r in records:
        _same_example(port(r), jax_(r))
