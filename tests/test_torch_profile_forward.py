"""``ape_tpu_torch/tools/profile_forward.py`` on the CPU: its module hooks
and stage split on tiny models of its cells (the protocol pyramid without
masks, the 4-scale pyramid with the mask head, and a tiny APE-L_D whose
encoder fuses), with host-clock events in place of the card's CUDA events.
The profile itself needs a card."""

import time

import pytest
import torch

from ape_tpu_torch.tools import profile_forward
from tests.torch_parity import tiny_inputs, torch_tiny_l_d, torch_tiny_masked, torch_tiny_protocol


class HostEvent:
    """A stand-in for torch.cuda.Event: the host clock when it was made."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


@pytest.mark.parametrize("build,mask_on", [(torch_tiny_protocol, False),
                                           (torch_tiny_masked, True),
                                           (torch_tiny_l_d, False)])
def test_stage_hooks_split_the_forward(monkeypatch, build, mask_on):
    monkeypatch.setattr(profile_forward, "_event", HostEvent)
    torch.manual_seed(0)
    model = build().eval()
    inputs = [torch.from_numpy(x) for x in tiny_inputs()]
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
