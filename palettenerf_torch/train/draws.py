"""The random draws of a training epoch, in the order the epoch makes them.

``Draws`` takes every draw from one ``torch.Generator`` (the trainer's). Each trainer's
epoch and step ask their draw source for the epoch's image order, the grid refresh's
jitter, and per step the pixel indices, the background, the march jitter, the palette
stage's smooth-loss jitter and the ``-O2`` encode draws, so that another source with the
same methods (a replay of another implementation's draws, say) can stand in for it:
``Trainer.train(..., draws=...)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.nerf import encode_rand_for
from ..ops.hashgrid_fast import EncodeRand


class Draws:
    """Every draw from ``generator``, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def _rand(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def order(self, n: int) -> List[int]:
        """The epoch's order of the ``n`` training images."""
        return torch.randperm(n, generator=self.generator, device=self.device).tolist()

    def refresh_noise(self, shape: Sequence[int]) -> torch.Tensor:
        """A grid refresh's jitter within each cell, uniform in [-1, 1): [CAS, cells, 3]."""
        return self._rand(shape) * 2.0 - 1.0

    def pixels(self, n: int, high: int) -> torch.Tensor:
        """A step's ``n`` pixel indices in [0, high): the first draw of a step."""
        return torch.randint(0, high, (n,), generator=self.generator, device=self.device)

    def background(self, n: int) -> torch.Tensor:
        """The per-ray background [n, 3] the RGBA ground truth is composited on."""
        return self._rand((n, 3))

    def jitter(self, n: int) -> torch.Tensor:
        """The march's start jitter [n]."""
        return self._rand((n,))

    def smooth_jitter(self, rows: int) -> torch.Tensor:
        """The palette smooth loss's jitter of each sample [rows, 3]."""
        return self._rand((rows, 3))

    def encode(self, spec, rows: int) -> Optional[EncodeRand]:
        """The ``-O2`` encode draws of ``rows`` network rows, or None for a spec that uses
        none."""
        return encode_rand_for(self.generator, spec, rows)
