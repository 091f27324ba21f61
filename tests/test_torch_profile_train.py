"""``ape_tpu_torch/tools/profile_train.py`` on the CPU: its stage split of one
train step of a tiny APE-L_D, with host-clock events in place of the card's
CUDA events: the fusion layers' forward, the recompute inside the backward
(which module hooks do not see, and which checkpoint stops early) and the
fusion layers' backward spans; the wrappers gone after the step; and the
same split of a tiny R50 step (APE-DETA R50 masked, Deformable-DETR R50's
Hungarian); the APE-L setup's recipe. The profile itself needs a card."""

import pytest
import torch

from ape_tpu_torch.engine.optimizer import build_optimizer
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.tools import profile_train
from tests.test_torch_profile_forward import HostEvent
from tests.test_torch_train import NUM_TEXT, QUERIES, _port_batch, _slice_batch
from tests.torch_parity import torch_tiny_l_d


@pytest.mark.parametrize("recompute", [False, True], ids=["no_recompute", "recompute"])
def test_train_stage_split_times_the_fusion_and_the_recompute(monkeypatch, recompute):
    monkeypatch.setattr(profile_train, "_event", HostEvent)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    torch.manual_seed(0)
    model = torch_tiny_l_d()
    model.transformer.encoder.use_act_checkpoint = recompute
    model.transformer.decoder.use_act_checkpoint = recompute
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    opt, sched = build_optimizer(model)
    (split,) = profile_train.stage_split(model, crit, opt, sched, _port_batch(_slice_batch()),
                                         torch.Generator().manual_seed(0), steps=1)
    modules = split["forward_modules_ms"]
    assert 0 < modules["fusion"] < modules["encoder"] < split["forward_and_loss_ms"]
    assert 0 < split["criterion_ms"] < split["forward_and_loss_ms"]
    recomputed = split["recompute_ms"]
    assert sorted(recomputed) == ["decoder_layer", "encoder_layer", "fusion"]
    if recompute:
        assert all(v > 0 for v in recomputed.values())
        assert recomputed["fusion"] < split["fusion_backward_ms"] < split["backward_ms"]
    else:
        assert not any(recomputed.values())
        assert 0 < split["fusion_backward_ms"] < split["backward_ms"]
    assert not any("forward" in vars(m) for m in model.modules())  # the wrappers undone


@pytest.mark.parametrize("tree", ["ape", "detr"])
def test_train_stage_split_of_an_r50_step(monkeypatch, tree):
    """The stage split of one step of a tiny R50 tree under the R50 recipe's
    optimizer: the backbone (the ResNet), the pixel decoder where masked,
    and the criterion inside the forward with the loss; nothing recomputed
    without recompute, no fusion."""
    from ape_tpu_torch.engine.optimizer import R50_RECIPE
    from tests.test_torch_r50_train import _criterion_kw, _num_classes, _r50_batch
    from tests.torch_parity import torch_tiny_r50

    monkeypatch.setattr(profile_train, "_event", HostEvent)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    torch.manual_seed(0)
    model = torch_tiny_r50(tree)
    crit = DeformableCriterion(**_criterion_kw(tree, _num_classes(tree)))
    opt, sched = build_optimizer(model, **R50_RECIPE)
    (split,) = profile_train.stage_split(model, crit, opt, sched, _port_batch(_r50_batch(tree)),
                                         torch.Generator().manual_seed(0), steps=1)
    modules = split["forward_modules_ms"]
    assert sorted(modules) == sorted(["backbone", "neck", "encoder", "decoder"]
                                     + (["pixel_decoder"] if tree == "ape" else []))
    assert 0 < modules["backbone"] < split["forward_and_loss_ms"]
    assert 0 < split["criterion_ms"] < split["forward_and_loss_ms"]
    assert not any(split["recompute_ms"].values()) and split["fusion_backward_ms"] == 0
    assert not any("forward" in vars(m) for m in model.modules())


def test_l_setup_is_the_ade20k_recipe(monkeypatch):
    """``--model l``: build_ape_l (cut to 1 block and 1 + 1 layers on the
    CPU), the recipe's criterion (150 classes, masks), batch 2 at 1024^2
    with 150 valid texts of 160, the ViT-L layer decay, a CPU generator."""
    import chip_smoke as cs
    from ape_tpu_torch.modeling import build as port_build

    monkeypatch.setattr(profile_train, "build_ape_l", lambda **k: port_build.build_ape_l(
        **dict(k, depth=1, num_layers=1, device="cpu")))
    model, crit, opt, sched, batch, gen = profile_train.setup("l", False, None, "cpu")
    assert model.mask_on and model.transformer.two_stage_num_proposals == 900
    assert crit.num_classes == cs.L_CLASSES and "masks" in crit.losses
    assert batch["images"].shape == (cs.L_TRAIN_BATCH, cs.TRAIN_IMG, cs.TRAIN_IMG, 3)
    assert batch["text_valid"].sum(1).tolist() == [cs.L_CLASSES] * cs.L_TRAIN_BATCH
    assert int(batch["targets"]["labels"].max()) < cs.L_CLASSES
    assert gen.device.type == "cpu" and len(opt.param_groups) > 2


def test_vitl_setup_is_the_coco_recipe(monkeypatch):
    """``--model vitl``: build_ape_vit("vitl") (cut to 1 block and 1 + 1
    layers on the CPU), masked, 900 queries, the recipe's criterion (80
    classes, masks), batch 2 at 1024^2 with 80 valid texts of 96, the ViT-L
    layer decay, a CPU generator."""
    import chip_smoke as cs
    from ape_tpu_torch.modeling import build as port_build

    monkeypatch.setattr(profile_train, "build_ape_vit", lambda tree, **k: port_build.build_ape_vit(
        tree, **dict(k, depth=1, num_layers=1, device="cpu")))
    model, crit, opt, sched, batch, gen = profile_train.setup("vitl", False, None, "cpu")
    assert model.mask_on and model.transformer.two_stage_num_proposals == 900
    assert model.backbone.net.blocks[0].attn.use_rel_pos and not model.backbone.net.rope
    assert crit.num_classes == cs.VITL_CLASSES and "masks" in crit.losses
    assert crit.num_queries == cs.QUERIES
    assert batch["images"].shape == (cs.VITL_TRAIN_BATCH, cs.TRAIN_IMG, cs.TRAIN_IMG, 3)
    assert batch["text_valid"].sum(1).tolist() == [cs.VITL_CLASSES] * cs.VITL_TRAIN_BATCH
    assert batch["text_valid"].shape[1] == cs.VITL_TEXT_SLOTS
    assert gen.device.type == "cpu" and len(opt.param_groups) > 2
