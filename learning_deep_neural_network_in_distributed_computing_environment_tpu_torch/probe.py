"""Timing probe: per-worker fwd+bwd step time -> shard-share ratios (port
of the JAX package's ``probe.py:195-219, 305-314``), and the memory rows
of the engines' programs (``TrackedProgram``, ``memory_report``; JAX
``probe.py:52-192``).

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
import threading
import time

import numpy as np
import torch
from torch import nn

from . import mesh

log = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Memory rows of the engines' programs (JAX probe.py:52-192)
# ----------------------------------------------------------------------
# XLA reports a compiled program's memory from the executable; an eager
# program has none, so a TrackedProgram measures its first call (per
# input shape) with the card's allocator statistics.  Measuring a peak
# means resetting the card's peak statistic, which the process peak that
# the rounds and the smoke report also reads: the probe keeps a running
# maximum, folded in before every reset it makes, and reports the process
# peak as max(running, the card's current peak).  The allocator and its
# statistics are per process, so the running maximum and the lock that
# keeps a measured call apart from the port's staging threads are too.
_RUNNING_PEAK: dict[int, int] = {}
MEASURE_LOCK = threading.Lock()


def _cuda_index(device) -> int | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def reset_peak_memory_stats(device) -> None:
    """Start a new process-peak window on ``device``: the card's peak
    statistic and the probe's running maximum (a no-op on the CPU).  Code
    that reads ``max_memory_allocated`` resets through this, never through
    ``torch.cuda.reset_peak_memory_stats`` alone."""
    idx = _cuda_index(device)
    if idx is None:
        return
    with MEASURE_LOCK:
        _RUNNING_PEAK.pop(idx, None)
        torch.cuda.reset_peak_memory_stats(idx)


def max_memory_allocated(device) -> int:
    """The process's peak allocation on ``device`` since the last
    ``reset_peak_memory_stats``, across the resets a ``TrackedProgram``
    makes; 0 on the CPU (its allocator keeps no statistics)."""
    idx = _cuda_index(device)
    if idx is None:
        return 0
    return max(_RUNNING_PEAK.get(idx, 0), torch.cuda.max_memory_allocated(idx))


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _unique(tensors) -> list[torch.Tensor]:
    seen, out = set(), []
    for t in tensors:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def memory_analysis_row(before: int, peak: int, inputs, outputs) -> dict:
    """One program call's memory row with XLA's ``memory_analysis`` keys,
    in their eager meaning:

    - ``argument_bytes`` / ``output_bytes``: the tensor bytes in and out
      (``inputs`` includes the state the program reads, ``outputs`` the
      state it writes, e.g. the parameters and Adam moments);
    - ``alias_bytes``: the output bytes that share storage with an input
      (in-place updates, such as Adam's, XLA's donated buffers);
    - ``temp_bytes``: the call's peak allocation above what was allocated
      before it (``peak - before``), minus the newly allocated outputs;
    - ``generated_code_bytes``: 0 (no compiled executable)."""
    ins, outs = _unique(inputs), _unique(outputs)
    in_storage = {t.untyped_storage().data_ptr() for t in ins}
    alias = _nbytes(t for t in outs
                    if t.untyped_storage().data_ptr() in in_storage)
    out_bytes = _nbytes(outs)
    return {"temp_bytes": max(0, int(peak) - int(before)
                              - (out_bytes - alias)),
            "argument_bytes": _nbytes(ins), "output_bytes": out_bytes,
            "alias_bytes": alias, "generated_code_bytes": 0}


class TrackedProgram:
    """An engine program (an eager callable) with the memory row of its
    first call, the counterpart of JAX's AOT-compiled ``TrackedProgram``.

    Single-shape (default): the first call is measured and every later
    call goes straight to ``fn``.  ``multi_shape=True`` (the serve prefill,
    one program per prompt bucket): the first call of each input-shape key
    is measured, one row per key.  ``state`` (optional), called with the
    call's arguments, returns the tensors the program reads and updates in
    place besides its tensor arguments (the module's parameters, the
    optimizer's moments, a KV cache); they count as arguments before the
    call and as outputs after it.

    A measurement needs the card's allocator statistics: on the CPU a call
    keeps its shape key but no row, and ``memory_report`` then says
    ``available: False``.  The measured call holds ``MEASURE_LOCK``, which
    the port's staging threads take before they allocate on the card, so
    their allocations stay out of the row."""

    def __init__(self, name: str, fn, *, multi_shape: bool = False,
                 state=None):
        self.name = name
        self._fn = fn
        self._multi = bool(multi_shape)
        self._state = state
        self._rows: dict = {}          # shape key -> row (None: unmeasured)

    @staticmethod
    def _shape_key(args) -> tuple:
        return tuple((tuple(t.shape), str(t.dtype)) for t in _tensors(args))

    def __call__(self, *args, **kwargs):
        if self._rows and not self._multi:
            return self._fn(*args, **kwargs)
        key = self._shape_key((args, kwargs)) if self._multi else ()
        if key in self._rows:
            return self._fn(*args, **kwargs)
        state = (list(self._state(*args, **kwargs))
                 if self._state is not None else [])
        inputs = _tensors((args, kwargs)) + state
        cuda = [t.device for t in inputs if t.is_cuda]
        if not cuda:
            out = self._fn(*args, **kwargs)
            self._rows[key] = None
            return out
        device = cuda[0]
        with MEASURE_LOCK:
            idx = _cuda_index(device)
            _RUNNING_PEAK[idx] = max(_RUNNING_PEAK.get(idx, 0),
                                     torch.cuda.max_memory_allocated(idx))
            torch.cuda.reset_peak_memory_stats(idx)
            before = torch.cuda.memory_allocated(idx)
            out = self._fn(*args, **kwargs)
            peak = torch.cuda.max_memory_allocated(idx)
        after = (list(self._state(*args, **kwargs))
                 if self._state is not None else [])
        self._rows[key] = memory_analysis_row(before, peak, inputs,
                                              _tensors(out) + after)
        return out

    def shape_keys(self) -> list:
        """The input-shape keys called so far (one for single-shape)."""
        return list(self._rows)

    def memory_rows(self) -> list[dict]:
        """One row per measured shape key (none on the CPU)."""
        return [r for r in self._rows.values() if r is not None]


def track(programs: dict, name: str, fn, **kw) -> TrackedProgram:
    """``programs[name]`` (an engine's label -> program registry, JAX
    ``_track``), registering ``fn`` under ``name`` at its first use."""
    tp = programs.get(name)
    if tp is None:
        tp = programs[name] = TrackedProgram(name, fn, **kw)
    return tp


def memory_report(programs: dict, *, state_bytes: dict | None = None,
                  n_workers: int = 1, sim: bool = False) -> dict:
    """The ``results["memory"]`` row with JAX's keys (``probe.py:140-192``),
    on every run: the per-program rows of ``programs`` (name ->
    ``TrackedProgram``; a program without a row, or no program at all,
    flips ``available`` off), and the analytic resident model from
    ``state_bytes`` (an engine's ``state_resident_bytes``): the per-worker
    resident bytes, the worker peak (resident plus the transient
    ``params_gathered_peak`` of the resident layout's entry gather), and
    ``state_bytes_total`` = workers x per worker, which on a simulated run
    is the one card's stacked state, the quantity that bounds N."""
    rows: dict[str, list[dict]] = {}
    missing: list[str] = []
    for name, tp in programs.items():
        r = tp.memory_rows()
        if r:
            rows[name] = r
        else:
            missing.append(name)
    report: dict = {
        "available": bool(rows) and not missing,
        "programs": rows,
        "programs_unavailable": missing,
        "temp_bytes_total": sum(r["temp_bytes"] for rs in rows.values()
                                for r in rs),
        "workers": int(n_workers),
        "simulated": bool(sim),
    }
    if state_bytes is not None:
        peak = int(state_bytes.get("params_gathered_peak", 0))
        resident = sum(int(v) for k, v in state_bytes.items()
                       if k != "params_gathered_peak")
        report["per_worker_state_bytes"] = dict(state_bytes)
        report["per_worker_resident_bytes"] = resident
        report["per_worker_peak_bytes"] = resident + peak
        report["state_bytes_total"] = resident * int(n_workers)
    return report


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
