"""The once-per-round sync point (port of the JAX package's
``comms.py:63-112``, ``aggregate``).

The port runs one worker so far, and with one worker every one of the 12
modes (gradients | weights x equal | weighted x allreduce | ring |
double_ring) is the identity, exactly as ``comms.aggregate`` returns the
tree unchanged when the data axis has size 1.  The multi-worker matrix on
``torch.distributed`` is ROADMAP queue A.5.
"""

from __future__ import annotations

from typing import Sequence

import torch

HOWS = ("equal", "weighted")
TOPOLOGIES = ("allreduce", "ring", "double_ring")


def aggregate(tensors: Sequence[torch.Tensor], *, how: str = "equal",
              topology: str = "allreduce", local_weight: float = 0.5,
              world_size: int = 1) -> list[torch.Tensor]:
    """Aggregate one worker's tensors (parameters or gradients) across the
    ``world_size`` workers."""
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, got "
                         f"{topology!r}")
    if world_size == 1:
        return list(tensors)
    raise ValueError(
        f"aggregate over {world_size} workers: the multi-worker sync matrix "
        "on torch.distributed is ROADMAP queue A.5")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))
