"""Synchronization (H) schedule — the fixed H of the JAX package's
``core/schedule.py``.  ``AdaptiveH`` and ``StagedH`` are not ported yet."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FixedH:
    h: int

    def should_sync(self, step: int, since_sync: int, loss: float) -> bool:
        return since_sync >= self.h

    @property
    def current_h(self) -> int:
        return self.h
