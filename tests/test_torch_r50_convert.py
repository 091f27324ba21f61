"""The R50 family's boundaries against ape_tpu on the CPU:

* the weight round trip over the R50 config trees at full size (shapes
  only): flax -> port -> flax exact, the port's builders taking the
  state_dict strictly; the builders' device rule;
* the Hungarian matcher of ``use_stage2=False``: the host auction's
  assignment equal to JAX's ``auction_assign`` on random costs (invalid
  gts, G < K, no near ties) and at its bid limit, its costs within 1e-5 of
  JAX's, one host copy a call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.ape_deta import matchers as j_matchers
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.modeling.ape_deta import matchers
from tests.torch_parity import R50_NECK_IN, flatten


def _t(x):
    return torch.from_numpy(np.array(x))


R50_CONFIGS = {
    "ape": ("configs/COCO_InstanceSegmentation/ape_deta/ape_deta_r50_12ep.py", {}),
    "ape_vlf": ("configs/COCO_InstanceSegmentation/ape_deta/ape_deta_r50_vlf_12ep.py",
                {"vl_fusion": True}),
    "deta": ("configs/COCO_InstanceSegmentation/deformable_deta/deformable_deta_segm_r50_12ep.py",
             {"num_learned_classes": 80}),
    "detr": ("configs/COCO_Detection/deformable_detr/deformable_detr_r50_50ep.py", {}),
    "detr_refine": ("configs/COCO_Detection/deformable_detr/"
                    "deformable_detr_r50_with_box_refinement_50ep.py", {"with_box_refine": True}),
    "detr_two_stage": ("configs/COCO_Detection/deformable_detr/"
                       "deformable_detr_r50_two_stage_50ep.py",
                       {"as_two_stage": True, "with_box_refine": True}),
}
# leaves JAX's converter has no rule for (it logs them and drops them)
NO_JAX_RULE = {"class_embedding", "transformer/query_embed", "transformer/reference_points/kernel",
               "transformer/reference_points/bias"}


@pytest.mark.parametrize("tree", list(R50_CONFIGS))
def test_r50_weight_round_trip(tree):
    """Each R50 config's JAX tree at full size (shapes only): flax -> port ->
    flax through both converters gives every leaf back exactly but the
    three JAX's converter has no rule for, which the port's state_dict holds
    as given; the port's builder of that config takes the state_dict
    strictly (FrozenBN's buffers included)."""
    from pathlib import Path

    from ape_tpu.checkpoint.convert import convert_torch_state_dict
    from ape_tpu.config import LazyConfig, instantiate
    from ape_tpu_torch.modeling.build import build_ape_r50, build_deformable_detr_r50

    path, kw = R50_CONFIGS[tree]
    jm = instantiate(LazyConfig.load(str(Path(__file__).resolve().parents[1] / path)).model)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)), jnp.asarray([[512, 512]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flatten(shapes).items()}
    sd = state_dict_from_jax(flat)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    neck_levels=R50_NECK_IN)
    assert sorted(back) == sorted(set(flat) - NO_JAX_RULE)
    for k in back:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for k in NO_JAX_RULE & set(flat):
        name = k.replace("/", ".").replace(".kernel", ".weight")
        want = flat[k].T if k.endswith("kernel") else flat[k]
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=k)
    build = build_ape_r50 if tree.startswith(("ape", "deta")) else build_deformable_detr_r50
    build(**kw, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("build", ["build_ape_r50", "build_deformable_detr_r50"])
def test_r50_builders_raise_without_a_card(build):
    """The builders place the model on the card by default and raise where
    there is none, rather than fall back to the CPU."""
    from ape_tpu_torch.modeling import build as port_build

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_build, build)(num_layers=1)


# (problems, K proposals, G gt slots, valid gts per problem)
AUCTION_CASES = {"k12_g5": (4, 12, 5, (5, 3, 0, 1)), "k40_g8": (3, 40, 8, (8, 4, 6)),
                 "k300_g8": (2, 300, 8, (4, 8))}


def _auction_costs(rng, p, k, g, n_valid):
    """Costs as the matcher's (focal + 5 L1 + 2 GIoU span about -2 to 12),
    no two of a row within 1e-2 of each other; invalid gts at 1e6."""
    cost = np.stack([np.stack([rng.permutation(k) for _ in range(g)], 1) for _ in range(p)])
    cost = (cost * (14.0 / k) - 2.0 + rng.uniform(0, 1e-3, cost.shape)).astype(np.float32)
    valid = np.arange(g)[None] < np.asarray(n_valid)[:, None]
    return np.where(valid[:, None, :], cost, np.float32(1e6)).astype(np.float32), valid


@pytest.mark.parametrize("case", list(AUCTION_CASES))
def test_auction_matches_jax(rng, case):
    """The host auction on P problems at once against JAX's auction_assign
    on each: identical assignments; every valid gt assigned, each to one
    proposal, no invalid gt."""
    p, k, g, n_valid = AUCTION_CASES[case]
    cost, valid = _auction_costs(rng, p, k, g, n_valid)
    got = matchers.auction_assign(cost, valid)
    want = np.stack([np.asarray(j_matchers.auction_assign(jnp.asarray(c), jnp.asarray(v)))
                     for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, want)
    for a, v in zip(got, valid):
        assert sorted(a[a >= 0].tolist()) == np.flatnonzero(v).tolist()


def test_auction_stops_at_its_bid_limit(rng):
    """With fewer rounds than the problem needs, both stop where JAX's scan
    stops: the same partial assignment."""
    cost, valid = _auction_costs(rng, 1, 30, 8, (8,))
    got = matchers.auction_assign(cost, valid, num_iters=5)
    want = np.asarray(j_matchers.auction_assign(jnp.asarray(cost[0]), jnp.asarray(valid[0]),
                                                num_iters=5))
    np.testing.assert_array_equal(got[0], want)
    assert (got[0] >= 0).sum() < 8


def test_hungarian_match_matches_jax(rng):
    """hungarian_match over three heads of two images against JAX's
    hungarian_match image by image: costs within 1e-5, identical
    assignments, one host copy."""
    b, k, c, g = 2, 20, 6, 5
    heads = [{"pred_logits": rng.randn(b, k, c).astype(np.float32),
              "pred_boxes": np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)),
                                            rng.uniform(0.05, 0.4, (b, k, 2))], -1).astype(np.float32)}
             for _ in range(3)]
    labels = rng.randint(0, c, (b, g))
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)),
                            rng.uniform(0.05, 0.4, (b, g, 2))], -1).astype(np.float32)
    valid = np.array([[True, True, True, False, False], [True, False, True, True, True]])
    before = matchers.SYNCS["hungarian"]
    got = matchers.hungarian_match([{kk: _t(v) for kk, v in h.items()} for h in heads],
                                   _t(labels).long(), _t(boxes), _t(valid))
    assert matchers.SYNCS["hungarian"] == before + 1
    for i, h in enumerate(heads):
        cost = matchers.hungarian_cost_matrix(_t(h["pred_logits"]), _t(h["pred_boxes"]),
                                              _t(labels).long(), _t(boxes), _t(valid))
        for j in range(b):
            args = (jnp.asarray(h["pred_logits"][j]), jnp.asarray(h["pred_boxes"][j]),
                    jnp.asarray(labels[j]), jnp.asarray(boxes[j]), jnp.asarray(valid[j]))
            np.testing.assert_allclose(cost[j].numpy(),
                                       np.asarray(j_matchers.hungarian_cost_matrix(*args)),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got[i, j].numpy(),
                                          np.asarray(j_matchers.hungarian_match(*args)))
