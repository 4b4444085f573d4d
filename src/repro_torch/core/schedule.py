"""Synchronization (H) schedules — the JAX package's ``core/schedule.py``,
copied line for line.

The paper uses fixed H per stage (H=100 base, H=30 mid/SFT) and proposes
adaptive H as future work (§5): "dynamically adjusting H, reducing it during
critical stages (end of base training, mid-training, SFT) and increasing it
during stable pretraining".  ``AdaptiveH`` implements exactly that policy
from the observed loss slope.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional


class HSchedule:
    def should_sync(self, step: int, since_sync: int, loss: float) -> bool:
        raise NotImplementedError

    @property
    def current_h(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class FixedH(HSchedule):
    h: int

    def should_sync(self, step, since_sync, loss):
        return since_sync >= self.h

    @property
    def current_h(self):
        return self.h


@dataclasses.dataclass
class StagedH(HSchedule):
    """Fixed H with per-stage values — the paper's actual setup
    (base: H=100, mid-training/SFT: H=30)."""
    h: int

    def should_sync(self, step, since_sync, loss):
        return since_sync >= self.h

    @property
    def current_h(self):
        return self.h


class AdaptiveH(HSchedule):
    """Loss-slope-driven H (paper §5 future work).

    Keeps a window of recent losses; the fitted slope decides:
      steep descent (|slope| > hi)  -> critical phase  -> shrink H (×0.5)
      flat           (|slope| < lo) -> stable phase    -> grow   H (×1.25)
    H clamped to [h_min, h_max].  Synchronizes when since_sync >= current H.
    """

    def __init__(self, h0: int = 50, h_min: int = 10, h_max: int = 200,
                 window: int = 32, hi: float = 5e-3, lo: float = 5e-4):
        self.h = float(h0)
        self.h_min, self.h_max = h_min, h_max
        self.window = window
        self.hi, self.lo = hi, lo
        self.losses: Deque[float] = deque(maxlen=window)

    def _slope(self) -> Optional[float]:
        n = len(self.losses)
        if n < self.window:
            return None
        xs = range(n)
        mx = (n - 1) / 2.0
        my = sum(self.losses) / n
        num = sum((x - mx) * (y - my) for x, y in zip(xs, self.losses))
        den = sum((x - mx) ** 2 for x in xs)
        return num / den

    def should_sync(self, step, since_sync, loss):
        self.losses.append(loss)
        if since_sync < int(self.h):
            return False
        slope = self._slope()
        if slope is not None:
            if abs(slope) > self.hi:
                self.h = max(self.h_min, self.h * 0.5)
            elif abs(slope) < self.lo:
                self.h = min(self.h_max, self.h * 1.25)
        return True

    @property
    def current_h(self):
        return int(self.h)
