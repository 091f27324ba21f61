"""``ape_tpu_torch/tools/profile_forward.py`` on the CPU: its module hooks
and stage split on tiny models of its cells (the protocol pyramid without
masks, the 4-scale pyramid with the mask head, a tiny APE-L_D whose
encoder fuses, a tiny APE-L (the non-CLIP tree, masked), and the tiny R50
trees: APE-DETA R50 masked and Deformable-DETR R50 single-stage), with
host-clock events in place of the card's CUDA events; the APE-L and R50
cells' build functions. The profile itself needs a card."""

import time

import pytest
import torch

from ape_tpu_torch.tools import profile_forward
from tests.torch_parity import (
    R50_DIMS,
    tiny_inputs,
    torch_tiny_l,
    torch_tiny_l_d,
    torch_tiny_masked,
    torch_tiny_protocol,
    torch_tiny_r50,
)


class HostEvent:
    """A stand-in for torch.cuda.Event: the host clock when it was made."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


@pytest.mark.parametrize("build,mask_on,dims", [
    (torch_tiny_protocol, False, None), (torch_tiny_masked, True, None),
    (torch_tiny_l_d, False, None), (torch_tiny_l, True, None),
    (lambda: torch_tiny_r50("ape"), True, R50_DIMS),
    (lambda: torch_tiny_r50("detr"), False, R50_DIMS)], ids=["protocol", "masked", "l_d", "l",
                                                             "r50", "detr_r50"])
def test_stage_hooks_split_the_forward(monkeypatch, build, mask_on, dims):
    monkeypatch.setattr(profile_forward, "_event", HostEvent)
    torch.manual_seed(0)
    model = build().eval()
    inputs = [torch.from_numpy(x) for x in tiny_inputs(*([dims] if dims else []))]
    marks = {}
    hooks = profile_forward.stage_hooks(model, marks)
    with torch.no_grad():
        marks["start"] = HostEvent()
        model(*inputs)
        marks["end"] = HostEvent()
    for h in hooks:
        h.remove()
    split = profile_forward.stages(marks, mask_on)
    fuses = model.transformer.encoder.vl_layers is not None
    parts = ["backbone", "neck", "pre_encoder", "encoder", "select", "decoder", "heads"]
    assert sorted(split) == sorted(parts + ["forward"] + (["mask_head"] if mask_on else [])
                                   + (["fusion"] if fuses else []))
    assert all(v >= 0 for v in split.values())
    # the stages are disjoint spans of the forward, in order; fusion lies
    # inside the encoder
    assert sum(v for k, v in split.items() if k not in ("forward", "fusion")) <= split["forward"]
    if fuses:
        assert 0 < split["fusion"] <= split["encoder"]
    assert not model._forward_hooks and not model.transformer.encoder._forward_pre_hooks
    summary = profile_forward.summary([3.0, 1.0, 2.0])
    assert summary == {"median": 2.0, "min": 1.0, "max": 3.0}


def test_r50_cells_build_the_r50_trees(monkeypatch):
    """The R50 cells' builders, their masks, queries and the class bank
    (the builders swapped for ones that cut the model to 1 + 1 layers on
    the CPU); the model list names them."""
    from ape_tpu_torch.modeling import build as port_build

    for name in ("build_ape_r50", "build_deformable_detr_r50"):
        real = getattr(port_build, name)
        monkeypatch.setattr(profile_forward, name, lambda *a, _f=real, **k: _f(
            *a, **dict(k, num_layers=1, device="cpu")))
    assert {"r50-protocol", "r50-full", "detr-r50"} <= set(profile_forward.MODELS)
    got = {n: profile_forward.build(n, "cpu") for n in ("r50-protocol", "r50-full", "detr-r50")}
    assert [m.mask_on for m, _ in got.values()] == [False, True, False]
    assert got["detr-r50"][0].num_learned_classes == 80
    assert not got["detr-r50"][0].transformer.as_two_stage
    assert got["r50-full"][0].transformer.two_stage_num_proposals == 900
    assert all(t == 80 and not m.training for m, t in got.values())


def test_l_cells_build_ape_l(monkeypatch):
    """The APE-L cells build the non-CLIP tree (cut to 1 block and 1 + 1
    layers on the CPU): the protocol without masks, the full one masked,
    both with L_D's 1203 texts, in eval mode."""
    import chip_smoke
    from ape_tpu_torch.modeling import build as port_build

    monkeypatch.setattr(profile_forward, "build_ape_l", lambda **k: port_build.build_ape_l(
        **dict(k, depth=1, num_layers=1, device="cpu")))
    assert {"l-protocol", "l-full"} <= set(profile_forward.MODELS)
    got = {n: profile_forward.build(n, "cpu") for n in ("l-protocol", "l-full")}
    assert [m.mask_on for m, _ in got.values()] == [False, True]
    assert all(t == chip_smoke.L_D_TEXT and not m.training for m, t in got.values())
    assert all(m.backbone.net.window_size == 16 and m.dtype == torch.bfloat16
               for m, _ in got.values())


def test_vit_cells_build_the_vit_slice_trees(monkeypatch):
    """The ViT cells build chip_smoke's vit_slice trees (cut to 1 block and
    1 + 1 layers on the CPU) at the protocol, each with its texts, class
    bank, fusion and image side, in eval mode."""
    import chip_smoke
    from ape_tpu_torch.modeling import build as port_build

    monkeypatch.setattr(profile_forward, "build_ape_vit", lambda tree, **k: port_build.build_ape_vit(
        tree, **dict(k, depth=1, num_layers=1, device="cpu")))
    monkeypatch.setattr(chip_smoke, "init_weights", lambda m, *a, **k: m)
    cells = {f"vit-{t[0]}": t for t in chip_smoke.VIT_SLICE}
    assert set(cells) <= set(profile_forward.MODELS) and len(cells) == 5
    for name, (tree, kw, img, texts, _, _, _) in cells.items():
        model, got_texts = profile_forward.build(name, "cpu")
        assert got_texts == texts and not model.training and not model.mask_on, name
        assert model.num_learned_classes == kw.get("num_learned_classes", 0), name
        assert (model.transformer.encoder.vl_layers is not None) == kw.get("vl_fusion", False)
        assert model.dtype == torch.bfloat16 and profile_forward.VIT_CELLS[name][2] == img
        tables = [p.shape[0] for n, p in model.named_parameters() if n.endswith("rel_pos_h")]
        assert all(t in (2 * (img // 16) - 1, 2 * model.backbone.net.window_size - 1)
                   for t in tables), name
