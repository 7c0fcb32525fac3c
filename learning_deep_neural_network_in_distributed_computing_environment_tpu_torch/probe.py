"""Timing probe: per-worker fwd+bwd step time -> shard-share ratios (port
of the JAX package's ``probe.py:195-219, 305-314``).

Times are host-clock seconds around work that ends in
``torch.cuda.synchronize()`` (PyTorch returns before the card finishes), so
they measure the card, not the launch queue; one untimed warm-up step
comes first (it also absorbs cuDNN's first use; its heuristics pick the
conv algorithms, since a ``cudnn.benchmark`` search found kernels no
faster on an H100 and cost seconds at first use).  The module runs in eval
mode, as the JAX probe applies it with ``train=False``, so BatchNorm
normalises with its running statistics and leaves them untouched.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch
from torch import nn

from . import mesh

log = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_step_time(model: nn.Module, sample_batch: torch.Tensor,
                      num_batches: int = 10) -> float:
    """Seconds for ``num_batches`` fwd+bwd executions after one warm-up,
    with ``model`` in eval mode (its mode is restored after)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd_bwd():
        return torch.autograd.grad(model(sample_batch).float().sum(), params)

    num_batches = max(num_batches, 1)
    was_training = model.training
    model.eval()
    try:
        t0 = time.perf_counter()
        fwd_bwd()
        _sync(sample_batch.device)
        log.info("probe warm-up pass (first call): %.3f s",
                 time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(num_batches):
            fwd_bwd()
        _sync(sample_batch.device)
        return time.perf_counter() - t0
    finally:
        model.train(was_training)


def gather_durations(local_duration: float, world_size: int,
                     simulated_durations=None, group=None) -> np.ndarray:
    """All workers' probe durations as a [world_size] vector, in rank
    order (JAX ``probe.py:222-251``): each rank's own measurement,
    gathered over ``group``; without a group the one measurement, tiled.  ``simulated_durations`` overrides (tests,
    heterogeneity experiments on homogeneous hardware)."""
    if simulated_durations is not None:
        d = np.asarray(simulated_durations, np.float64)
        if d.shape != (world_size,):
            raise ValueError(
                f"simulated_durations must have shape ({world_size},), "
                f"got {d.shape}")
        return d
    gathered = np.asarray(mesh.all_gather(group, float(local_duration)),
                          np.float64)
    if group is None:
        # no group: the one process measured for all ``world_size``
        # workers (one worker, or the scenario lab's simulated ones), so
        # its duration is every worker's, tiled as JAX tiles it
        # (probe.py:251)
        return np.full(world_size, gathered[0])
    return gathered


def estimate_epoch_duration(model: nn.Module, sample_batch: torch.Tensor,
                            world_size: int, num_batches: int = 10,
                            simulated_durations=None, group=None):
    """Returns (durations [world_size], sec_per_batch [world_size]).  With
    several workers on one card all ranks probe at once, so each duration
    includes the others' contention for the card and the host."""
    if simulated_durations is None:
        local = measure_step_time(model, sample_batch, num_batches)
    else:
        local = float(np.asarray(simulated_durations).ravel()[0])
    durations = gather_durations(local, world_size, simulated_durations,
                                 group)
    return durations, durations / max(num_batches, 1)


def joiner_sec_per_batch(survivor_spb: np.ndarray,
                         mode: str = "mean") -> float:
    """Probe-EMA seed for a worker joining mid-run (JAX
    ``probe.joiner_sec_per_batch``): a joiner has no probe measurement
    and no wall history, so its sec/batch is the survivors' ``mean``
    (default), ``max`` (conservative) or ``min``."""
    spb = np.asarray(survivor_spb, np.float64)
    if spb.size == 0 or np.any(spb <= 0):
        raise ValueError(
            f"survivor sec/batch vector must be non-empty and positive, "
            f"got {survivor_spb!r}")
    if mode == "mean":
        return float(spb.mean())
    if mode == "max":
        return float(spb.max())
    if mode == "min":
        return float(spb.min())
    raise ValueError(f"unknown joiner_sec_per_batch mode {mode!r}")
