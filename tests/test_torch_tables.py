"""The constant tables of the forward are built once (``ops/tables.py``).

On a card each table built anew is a copy from host memory that ends in a
stream sync; ``chip_smoke.py`` counts those syncs per forward there. Here, on
the CPU, the cache's misses show the same thing: a second forward builds no
table, gives the first forward's outputs bit for bit, and a table is keyed
by its shapes, device and dtype.
"""

import numpy as np
import torch

from ape_tpu_torch.modeling.backbone.eva_vit import _rope_on
from ape_tpu_torch.modeling.backbone.vit_utils import _resize_matrix_on
from ape_tpu_torch.modeling.build import build_ape_ti
from ape_tpu_torch.ops import tables
from ape_tpu_torch.ops.msda_dispatch import _level_tables, grid_centers, level_sizes


def _clear():
    for cached in tables._CACHED:
        cached.cache_clear()


def test_second_forward_builds_no_table():
    _clear()
    torch.manual_seed(0)
    model = build_ape_ti(num_queries=60, embed_dim_language=32, mask_on=False,
                         scale_factors=(2.0, 1.0, 0.5), device="cpu").eval()
    rng = np.random.RandomState(0)
    inputs = (torch.from_numpy(rng.randn(1, 128, 128, 3).astype(np.float32)),
              torch.tensor([[128, 128]]),
              torch.from_numpy(rng.randn(1, 5, 32).astype(np.float32)),
              torch.ones(1, 5, dtype=torch.bool))
    with torch.no_grad():
        first = model(*inputs)
        built = tables.misses()
        second = model(*inputs)
    # the RoPE tables (window and global), the resize matrix (one: the grid
    # is square), the encoder's grid centers and level sizes, the select's
    # grid base; the kernels' level tables are built on a card only
    assert built == 6
    assert tables.misses() == built
    assert first.keys() == second.keys()
    for key, value in first.items():
        assert torch.equal(value, second[key]), key


def test_tables_are_keyed_by_shapes_device_and_dtype():
    shapes = ((4, 4), (2, 2))
    sizes = level_sizes(shapes, "cpu")
    assert level_sizes([[4, 4], [2, 2]], torch.device("cpu")) is sizes
    assert level_sizes(((4, 4), (2, 3)), "cpu").tolist() == [[4.0, 4.0], [3.0, 2.0]]
    assert sizes.tolist() == [[4.0, 4.0], [2.0, 2.0]]
    assert grid_centers(shapes, "cpu").shape == (20, 2)
    assert grid_centers(((4, 4),), "cpu").shape == (16, 2)
    level, starts = _level_tables(shapes, torch.device("cpu"))
    assert level.tolist() == [[4, 4], [2, 2]] and starts.tolist() == [0, 16]
    assert _level_tables(((2, 2), (4, 4)), torch.device("cpu"))[1].tolist() == [0, 4]
    f32 = _resize_matrix_on(14, 8, torch.device("cpu"), torch.float32)
    bf16 = _resize_matrix_on(14, 8, torch.device("cpu"), torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert _resize_matrix_on(14, 6, torch.device("cpu"), torch.float32).shape == (6, 14)
    assert _rope_on(16, 14, 16, torch.device("cpu"))[0].shape == (196, 32)
    assert _rope_on(16, 8, 16, torch.device("cpu"))[0].shape == (64, 32)


def test_a_table_built_in_inference_mode_serves_autograd():
    _clear()
    with torch.inference_mode():
        sizes = level_sizes(((6, 5),), "cpu")
    assert not sizes.is_inference()
    x = torch.ones(1, 2, requires_grad=True)
    (x / sizes).sum().backward()
    assert torch.allclose(x.grad, 1 / sizes)
