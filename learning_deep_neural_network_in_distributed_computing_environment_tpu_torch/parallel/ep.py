"""Expert parallelism over the ``expert`` axis of the rank grid (the
collectives of the JAX package's ``models/moe.py:42-137`` under
``shard_map``).

Each rank of an ``expert`` line (``mesh.Group``) holds E/ep of the
experts of every MoE layer; the routing, the attention and every other
leaf are replicated along the line, and every rank sees the whole token
set.  An MoE layer is one region bracketed by Megatron's markers
(``parallel/tp.py``), here over the expert line and then the model line:

- ``enter`` (f) on the tokens entering the dispatch product and on the
  gate entering the combine: the identity forward, the gradient summed
  over ``expert`` and then over ``model`` (each rank's dispatch and
  combine see only its experts and its F slice, so each holds a share of
  those gradients);
- ``leave`` (g) on the layer's output: the partial outputs summed over
  ``expert`` and then over ``model`` (JAX: one ``psum`` over both axes),
  the gradient passed as it is.

With both, every replicated leaf (gate, norms, attention, embeddings) gets
the dense gradient on every rank and the expert stacks their own: no
gradient is summed over ``expert`` after the step, and the aux loss,
computed whole on every rank, is not counted ep times.  The expert
all-reduces stage through host memory over gloo, in fp32, and are counted
in ``STATS`` (the model line's in ``tp.STATS``).
"""

from __future__ import annotations

import torch

from .. import mesh
from . import tp as tp_lib

# per process: the expert-line all-reduces run, the bytes handed to gloo
# and their wall time (host staging included)
STATS = {"calls": 0, "bytes": 0, "ms": 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, ms=0.0)


def enter(x: torch.Tensor, ep: mesh.Group | None,
          tp: mesh.Group | None) -> torch.Tensor:
    """Megatron f over the expert line, then the model line: the
    gradient is summed over ``expert`` first."""
    return tp_lib.copy_to_tp_region(
        tp_lib.copy_to_tp_region(x, tp), ep, STATS)


def leave(x: torch.Tensor, ep: mesh.Group | None,
          tp: mesh.Group | None) -> torch.Tensor:
    """Megatron g over the expert line, then the model line."""
    return tp_lib.reduce_from_tp_region(
        tp_lib.reduce_from_tp_region(x, ep, STATS), tp)
