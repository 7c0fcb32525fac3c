"""Timing probe: per-worker fwd+bwd step time -> shard-share ratios (port
of the JAX package's ``probe.py:195-219, 305-314``).

Times are host-clock seconds around work that ends in
``torch.cuda.synchronize()`` (PyTorch returns before the card finishes), so
they measure the card, not the launch queue; one untimed warm-up step
comes first.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_step_time(model: nn.Module, sample_batch: torch.Tensor,
                      num_batches: int = 10) -> float:
    """Seconds for ``num_batches`` fwd+bwd executions after one warm-up."""
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd_bwd():
        return torch.autograd.grad(model(sample_batch).float().sum(), params)

    num_batches = max(num_batches, 1)
    fwd_bwd()
    _sync(sample_batch.device)
    t0 = time.perf_counter()
    for _ in range(num_batches):
        fwd_bwd()
    _sync(sample_batch.device)
    return time.perf_counter() - t0


def gather_durations(local_duration: float, world_size: int,
                     simulated_durations=None) -> np.ndarray:
    """All workers' probe durations as a [world_size] vector;
    ``simulated_durations`` overrides (tests, heterogeneity experiments on
    homogeneous hardware)."""
    if simulated_durations is not None:
        d = np.asarray(simulated_durations, np.float64)
        if d.shape != (world_size,):
            raise ValueError(
                f"simulated_durations must have shape ({world_size},), "
                f"got {d.shape}")
        return d
    return np.full(world_size, local_duration, np.float64)


def estimate_epoch_duration(model: nn.Module, sample_batch: torch.Tensor,
                            world_size: int, num_batches: int = 10,
                            simulated_durations=None):
    """Returns (durations [world_size], sec_per_batch [world_size])."""
    if simulated_durations is None:
        local = measure_step_time(model, sample_batch, num_batches)
    else:
        local = float(np.asarray(simulated_durations).ravel()[0])
    durations = gather_durations(local, world_size, simulated_durations)
    return durations, durations / max(num_batches, 1)
