"""Streaming DiLoCo (Douillard et al., arXiv:2501.18512; the JAX
package's ``core/streaming.py``): partition the parameters into F
fragments and synchronize one fragment every H/F steps, staggered, so
each parameter still syncs every H steps while the instantaneous
bandwidth demand drops F×.

Fragments follow the layer stack: stacked ``layers/*`` leaves are cut
into F contiguous layer ranges; other leaves join the first fragment
(embeddings) or the last (``final_norm`` / ``unembed``).  The reference
holds a fragment as boolean masks over whole leaves and quantizes the
masked delta; here a fragment maps each leaf to a layer range (a slice of
its leading dim) or None, and only that range is encoded and shipped.
The masked zeros of the reference add nothing to a leaf's amax, quantize
to 0 and keep their residual, so the fragment's codes, scales and
residuals are the same bit for bit (the payload is the fragment's size,
as the reference's byte schedule counts it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.diloco import (DiLoCoState, DiLoCoTrainer, Flat,
                                     Fragment)
from repro_torch.models.transformer import flatten


def _is_stacked(path: str) -> bool:
    return "layers" in path.split("/")


def fragment_masks(params, num_fragments: int) -> List[Fragment]:
    """One fragment per slot: stacked layer leaves split along their
    leading (layer) dim, the rest assigned to the first (embeddings) or
    the last (output head) fragment.  ``params``: a tree or flat dict."""
    flat = flatten(params) if any(isinstance(v, dict)
                                  for v in params.values()) else params
    frags = []
    for f in range(num_fragments):
        frag: Fragment = {}
        for path, leaf in flat.items():
            if _is_stacked(path):
                n = leaf.shape[0]
                lo = f * n // num_fragments
                hi = (f + 1) * n // num_fragments
                frag[path] = slice(lo, hi) if hi > lo else None
            else:
                owner = (num_fragments - 1 if any(
                    k in ("final_norm", "unembed") for k in path.split("/"))
                    else 0)
                frag[path] = slice(None) if f == owner else None
        frags.append(frag)
    return frags


@dataclasses.dataclass(frozen=True)
class StreamingDiLoCoTrainer(DiLoCoTrainer):
    """DiLoCoTrainer whose outer step may touch ONE fragment: only that
    fragment's deltas are exchanged and averaged, and only its slots of
    the anchor and the workers are reset; the rest keep diverging until
    their fragment's slot comes up."""
    num_fragments: int = 4

    def fragment_schedule(self) -> int:
        """Steps between fragment syncs (every fragment syncs each H)."""
        return max(self.cfg.h_inner_steps // self.num_fragments, 1)

    def outer_step_fragment_ef(self, state: DiLoCoState, frag: Fragment,
                               residual: Optional[Flat] = None
                               ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """One fragment's outer sync through the codec transport; the
        error-feedback residual changes only on the fragment's slots.
        Returns (state, residual)."""
        return self.sync(state, residual, frag=frag)

    def outer_step_fragment_quorum(self, state: DiLoCoState, frag: Fragment,
                                   residual: Optional[Flat],
                                   contrib: Sequence[bool],
                                   adopt: Sequence[bool],
                                   reset: Sequence[bool]
                                   ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """``outer_step_fragment_ef`` under quorum masks (``sync``):
        ``contrib`` rows enter the fragment's average, ``adopt`` rows take
        the synced fragment slots, ``reset`` rows (rejoiners) take the
        WHOLE new anchor — every fragment, whatever the round's — with a
        fresh inner optimizer state and residual; dead rows stay frozen."""
        return self.sync(state, residual, frag=frag, contrib=contrib,
                         adopt=adopt, reset=reset)


def run_streaming_diloco(trainer: StreamingDiLoCoTrainer, state, data_fn,
                         num_steps: int, record_every: int = 1
                         ) -> Tuple[Any, Dict]:
    """Inner steps with a staggered fragment-sync schedule: fragment
    (t / (H/F)) mod F syncs every H/F steps.  A thin wrapper over the
    ``DistTrainer`` runtime."""
    from repro_torch.core.dist_trainer import DistTrainer
    from repro_torch.core.sync import StreamingSync
    dt = DistTrainer(trainer.loss_fn, trainer.opt_cfg, trainer.cfg,
                     StreamingSync(num_fragments=trainer.num_fragments))
    return dt.run(state, data_fn, num_steps, record_every=record_every)
