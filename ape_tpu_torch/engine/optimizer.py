"""AdamW with layerwise lr decay and per-parameter multipliers (counterpart of
``ape_tpu/engine/optimizer.py``).

The recipe (COCO 12ep config + get_vit_lr_decay_rate; APE-L_D with
``vit_num_layers=24``, the LVIS recipe's): AdamW lr 2e-4, weight
decay 0.05 except on norms, biases, 1-d tensors, ``pos_embed`` and
``level_embeds``; layerwise decay 0.8 over the ViT blocks (patch and
position embeddings are layer 0); 0.1x lr for ``sampling_offsets`` and
``reference_points``; multistep lr with linear warmup. The gradient clip
(global norm 0.1) is the train step's (``engine.train_step``).

JAX's chain is clip -> adam -> add decayed weights -> multiplier -> lr, i.e.
``p -= lr * mult * (adam(g) + wd * p)``. ``torch.optim.AdamW`` with
``lr = base_lr * mult`` per group computes ``p -= lr' * wd * p + lr' * adam(g)``,
the same update; one param group per (multiplier, decay) pair carries it.

Parameter names are torch's: flax ``blocks_3`` is ``blocks.3`` here and a
norm's flax ``scale`` is its ``weight`` (1-d, so without decay either way).

The R50 family's recipe (``R50_RECIPE``: weight decay 1e-4, no layer decay,
a flat 0.1x on ``backbone.*``) is JAX's ``build_optimizer`` with those
arguments. As optax, the optimizer steps every parameter, one the loss
does not read as one whose gradient is zero: Adam's moments stay 0 and only
the decay moves it (the R50 stem behind its ``stop_gradient``, ROADMAP
Queue 3). ``torch.optim.AdamW`` alone would skip it.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch

WEIGHT_DECAY = 0.05
LAYER_DECAY = 0.8
# the R50 family's optimizer (configs/COCO_InstanceSegmentation/ape_deta/
# ape_deta_r50_12ep.py:30-39 and the DETA and Deformable-DETR R50 recipes)
R50_RECIPE = dict(weight_decay=1e-4, vit_num_layers=0, layer_decay=1.0, backbone_lr_mult=0.1)


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id for lr decay: patch/pos embed -> 0, blocks.i -> i+1, rest -> L+1."""
    if "backbone" in name:
        if "pos_embed" in name or "patch_embed" in name:
            return 0
        m = re.search(r"blocks\.(\d+)\.", name)
        if m:
            return int(m.group(1)) + 1
    return num_layers + 1


def lr_multiplier(name: str, num_layers: int = 12, decay: float = LAYER_DECAY,
                  backbone_lr_mult: float = 1.0) -> float:
    """decay^(L+1-layer_id), x0.1 for sampling offsets and reference points,
    x backbone_lr_mult for the backbone's."""
    m = decay ** (num_layers + 1 - vit_layer_id(name, num_layers))
    if "sampling_offsets" in name or "reference_points" in name:
        m *= 0.1
    if name.startswith("backbone"):
        m *= backbone_lr_mult
    return m


def lr_multiplier_tree(model: torch.nn.Module, num_layers: int = 12, decay: float = LAYER_DECAY,
                       backbone_lr_mult: float = 1.0):
    """{parameter name: lr multiplier} over the trainable parameters."""
    return {n: lr_multiplier(n, num_layers, decay, backbone_lr_mult)
            for n, p in model.named_parameters() if p.requires_grad}


def decays(name: str, param: torch.Tensor) -> bool:
    """Weight decay applies: not a norm scale, bias, 1-d tensor or embedding table."""
    return not (param.dim() <= 1 or "bias" in name or "pos_embed" in name
                or "level_embeds" in name)


def lr_lambda(milestones: Sequence[int] = (), warmup_steps: int = 0, gamma: float = 0.1):
    """lr factor by step: linear warmup from 1e-3 to 1, then x gamma at each
    milestone counted from the end of the warmup (``make_lr_schedule``)."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return 1e-3 + (1.0 - 1e-3) * step / warmup_steps
        after = step - warmup_steps
        return gamma ** sum(after >= m for m in milestones)

    return factor


class AdamW(torch.optim.AdamW):
    """torch's AdamW stepping a parameter without a gradient as one with a
    zero gradient, as optax steps every leaf; the gradient is None again
    after the step."""

    def step(self, closure=None):
        missing = [p for g in self.param_groups for p in g["params"] if p.grad is None]
        for p in missing:
            p.grad = torch.zeros_like(p)
        try:
            return super().step(closure)
        finally:
            for p in missing:
                p.grad = None


def build_optimizer(
    model: torch.nn.Module,
    base_lr: float = 2e-4,
    weight_decay: float = WEIGHT_DECAY,
    vit_num_layers: int = 12,
    layer_decay: float = LAYER_DECAY,
    milestones: Sequence[int] = (),
    warmup_steps: int = 0,
    backbone_lr_mult: float = 1.0,
) -> Tuple[AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the model's trainable parameters and its LambdaLR schedule
    (step the scheduler once after every optimizer step). The defaults are
    APE-Ti's and APE-L_D's recipe; the R50 family passes ``R50_RECIPE``."""
    mults = lr_multiplier_tree(model, vit_num_layers, layer_decay, backbone_lr_mult)
    groups = {}
    for name, p in model.named_parameters():
        if name in mults:
            key = (mults[name], weight_decay if decays(name, p) else 0.0)
            groups.setdefault(key, []).append(p)
    param_groups = [{"params": ps, "lr": base_lr * mult, "weight_decay": wd}
                    for (mult, wd), ps in groups.items()]
    opt = AdamW(param_groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(milestones, warmup_steps))
