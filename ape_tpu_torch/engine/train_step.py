"""The training step: forward, criterion, backward, clip, optimizer step
(counterpart of ``ape_tpu/engine/train_step.py``).

``make_train_step`` returns ``step(batch, generator=None) -> metrics``. The
batch is a dict: images (B, H, W, 3), image_sizes (B, 2), text_features
(B, T, Cl), text_valid (B, T), targets {labels, boxes, valid}, optional
class_valid (B, T). With ``iter_size > 1`` the batch splits into that many
micro-batches along B; their gradients are summed and divided by
``iter_size`` (JAX: a ``lax.scan`` over micro-batches). ``num_boxes`` is the
micro-batch's count of valid targets, clamped to 1.

Across ranks (``parallel.mesh``) the step is told which ``rows`` of the
global batch its batch holds (``mesh.batch_rows``): ``num_boxes`` is the
global count over the chunks, the model and the criterion draw at the
global batch and reduce their own counts through ``rows``, the backward of
all but the last micro-batch skips the gradient reduction, and the logged
loss terms are the ranks' mean, so the NaN guard raises on every rank
together. The clip's norm is the global one (``clip_grad_norm_`` on
FSDP2's DTensor gradients).

``prompt`` is the loader group's prompt type, as in JAX: ``"name"`` aligns
the class logits to the original text features, a phrase or expression to
the fused ones (``align_on_fused=prompt != "name"``). The step's generator
serves both the model (drop path) and the criterion (assignment subsamples,
the federated class subset), as JAX's one ``rng`` does.

A non-finite total loss raises ``FloatingPointError`` before the update,
as ``ape_tpu/engine/trainer.py`` raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion
from ape_tpu_torch.parallel import mesh
from ape_tpu_torch.utils.rows import WHOLE, Rows

BATCH_KEYS = ("images", "image_sizes", "text_features", "text_valid")
GRAD_CLIP = 0.1  # global-norm clip of the recipe (ape_tpu build_optimizer's grad_clip)


def _micro(batch: Dict, i: int, n: int) -> Dict:
    """The i-th of n equal slices along the batch dimension, targets included."""
    if isinstance(batch, dict):
        return {k: _micro(v, i, n) for k, v in batch.items()}
    size = batch.shape[0] // n
    return batch[i * size : (i + 1) * size]


def loss_fn(model, criterion: DeformableCriterion, batch: Dict,
            generator: Optional[torch.Generator] = None, prompt: str = "name",
            rows: Rows = WHOLE):
    """(total, losses, outputs) of one batch, the ``rows`` of the step's
    global batch: the model, then the criterion."""
    outputs = model(*(batch[k] for k in BATCH_KEYS), align_on_fused=prompt != "name",
                    generator=generator, rows=rows)
    targets = batch["targets"]
    num_boxes = rows.normaliser(targets["valid"].float().sum())
    losses = criterion(outputs, targets, num_boxes, batch.get("class_valid"), generator, rows)
    return criterion.total(losses), losses, outputs


def make_train_step(
    model: torch.nn.Module,
    criterion: DeformableCriterion,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    iter_size: int = 1,
    ema_decay: float = 0.0,
    prompt: str = "name",
    ema: Optional[list] = None,
    rows: Rows = WHOLE,
) -> Callable:
    """Returns step(batch, generator=None) -> metrics (tensors, on the device).

    With ema_decay > 0, ``step.ema`` holds the exponential moving average of
    the trainable parameters, updated after every step: ``ema`` (one tensor
    a trainable parameter, in order) when given, so that the step functions
    of one run share it, else a copy of the parameters. ``rows``: the rows
    of each global micro-batch that the step's batches hold (module
    docstring)."""
    params = [p for p in model.parameters() if p.requires_grad]
    distributed = torch.distributed.is_initialized()
    if ema_decay > 0 and ema is None:
        ema = [p.detach().clone() for p in params]
    elif ema_decay <= 0:
        ema = None

    def step(batch: Dict, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        totals, losses = [], {}
        for i in range(iter_size):
            micro = _micro(batch, i, iter_size) if iter_size > 1 else batch
            with mesh.no_gradient_sync(model, i < iter_size - 1):
                total, losses, _ = loss_fn(model, criterion, micro, generator, prompt, rows)
                total.backward()
            totals.append(total.detach())
        total = torch.stack(totals).mean()
        if distributed:
            names = list(losses) if iter_size == 1 else []
            total, *terms = mesh.mean_over_ranks([total] + [losses[k] for k in names])
            losses = dict(zip(names, terms))
        if not bool(torch.isfinite(total)):
            raise FloatingPointError(f"Loss became non-finite: {float(total)}")
        if iter_size > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(iter_size)
        grad_norm = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
        if hasattr(grad_norm, "full_tensor"):  # FSDP2's: a replicated DTensor
            grad_norm = grad_norm.full_tensor()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if ema is not None:
            with torch.no_grad():
                for e, p in zip(ema, params):
                    e.lerp_(p.detach(), 1.0 - ema_decay)
        metrics = {"total_loss": total, "grad_norm": grad_norm}
        if iter_size == 1:
            metrics.update({k: v.detach() for k, v in losses.items()})
        return metrics

    step.ema = ema
    return step
