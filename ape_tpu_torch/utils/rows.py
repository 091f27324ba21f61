"""A training step's rows of its global batch (``Rows``).

Some of a step's draws must not depend on how its batch is split: drop
path's keep masks, the assigners' subsample noise, the point-sampled mask
loss's points. They are drawn at the global batch's size and cut to the
step's rows (``Rows.rand``), so a step on a chunk draws what the step on the
whole batch draws for those rows. A loss whose normaliser counts over the
batch takes the global count (``Rows.normaliser``), and the federated class
subset the classes of the global batch (``Rows.any``). One process holds the
whole batch (``WHOLE``); ``parallel.mesh.RankRows`` is a rank's chunk, whose
counts and masks are reduced over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """Chunk ``index`` of ``count`` equal chunks of the global batch."""

    index: int = 0
    count: int = 1

    def rand(self, shape: Sequence[int], dim: int, generator: Optional[torch.Generator],
             device) -> torch.Tensor:
        """``torch.rand(shape)`` on ``device``, drawn on the generator's device
        (``device`` without a generator) at the global batch's size along
        ``dim`` and cut to this chunk."""
        shape = list(shape)
        per = shape[dim]
        shape[dim] = per * self.count
        gen_device = generator.device if generator is not None else device
        u = torch.rand(shape, generator=generator, device=gen_device)
        if self.count > 1:
            u = u.narrow(dim, self.index * per, per)
        return u.to(device)

    def count_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A count over these rows summed over the global batch."""
        return x

    def any(self, mask: torch.Tensor) -> torch.Tensor:
        """A boolean mask over these rows OR-ed over the global batch."""
        return mask

    def normaliser(self, count: torch.Tensor) -> torch.Tensor:
        """A loss's normaliser from a count over these rows (``num_boxes``,
        the IoU losses' matched count): the global count clamped to 1, over
        the chunks, which averaging the chunks' gradients multiplies back."""
        return self.count_sum(count).clamp(min=1.0) / self.count


WHOLE = Rows()
