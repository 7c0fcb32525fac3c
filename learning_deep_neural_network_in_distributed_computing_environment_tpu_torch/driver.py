"""``train_global``: the orchestration loop (port of the JAX package's
``driver.py:67-125, 235``, single worker, serial).

1. load -> 80/20 train/val split;
2. timing probe -> shard-share ratios;
3. proportional partition of train and val (non-IID skew when
   disbalanced);
4. per global epoch: pack the worker's capped shard, run the round
   (``epochs_local`` x train + validation, then the sync point), assemble
   the reference metrics;
5. straggler feedback: the measured round wall feeds the sec/batch EMA one
   round late (as in the JAX driver's overlapped pipeline, whose serial
   mode uses the same delay), and the shard is re-partitioned from
   ``prev_fraction`` of its own indices plus ``next_fraction`` of the pool.

Returns the reference's metric structures under their original names,
plus ``step_caps``, ``shard_sizes``, ``round_timings`` and the final
``model``, ``variables`` and ``test`` set.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from . import probe as probe_lib
from .config import Config
from .data import (
    adaptive_partition,
    budget_from_time_limit,
    efficiency_ratios,
    fixed_classes_for_rank,
    load_dataset,
    pack_window,
    repartition,
    skew_repartition,
    step_budget,
    train_val_split,
)
from .models import get_model
from .train import LocalSGDEngine

log = logging.getLogger(__name__)


def resolve_device(name: str | None) -> torch.device:
    """``cpu`` only when asked for; otherwise CUDA, or an error when there
    is no card (the port never falls back to the CPU on its own)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port runs on the GPU unless "
            "the CPU is asked for (--device cpu / device='cpu')")
    return torch.device("cuda")


def _assemble_round_metrics(results: dict, mx: dict, worker_ids) -> None:
    """One round's metric arrays (leading worker axis) -> the reference
    metric lists (the JAX driver's vectorized assembly, unchanged)."""
    if isinstance(worker_ids, (int, np.integer)):
        worker_ids = list(range(int(worker_ids)))
    bl = np.asarray(mx["batch_losses"])          # [N, E, S]
    valid = np.asarray(mx["batch_mask"]) > 0
    epochs_local = bl.shape[1]
    for pos, wid in enumerate(worker_ids):
        results["all_workers_losses"][wid].extend(
            bl[pos][valid[pos]].tolist())
    for e in range(epochs_local):
        results["all_epochs_losses"].append(bl[:, e][valid[:, e]].tolist())
    results["global_epoch_losses"].append(
        bl.transpose(1, 0, 2)[valid.transpose(1, 0, 2)].tolist())
    results["global_epoch_accuracies"].append(
        np.asarray(mx["avg_acc"])[0].tolist())
    results["global_train_losses"].append(float(mx["global_train_loss"][0]))
    results["global_train_accuracies"].append(float(mx["global_train_acc"][0]))
    results["global_val_losses"].append(float(mx["global_val_loss"][0]))
    results["global_val_accuracies"].append(float(mx["global_val_acc"][0]))
    results["worker_specific_train_losses"].extend(
        np.asarray(mx["train_loss"])[0].tolist())
    results["worker_specific_train_accuracies"].extend(
        np.asarray(mx["train_acc"])[0].tolist())
    results["worker_specific_val_losses"].extend(
        np.asarray(mx["val_loss"])[0].tolist())
    results["worker_specific_val_accuracies"].extend(
        np.asarray(mx["val_acc"])[0].tolist())


def build_model_for(cfg: Config, num_classes: int, device: torch.device):
    """The registry model at the configured compute dtype and attention,
    initialized from ``cfg.seed`` with a generator on ``device``."""
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    kw = {}
    if cfg.num_kv_heads > 0:
        # grouped-query attention (models/llama.py; the Llama-2/3 recipe)
        if not cfg.model.startswith("llama"):
            raise ValueError(
                f"--num_kv_heads applies to llama_* models; got --model "
                f"{cfg.model}")
        kw["num_kv_heads"] = cfg.num_kv_heads
    model = get_model(cfg.model, num_classes=num_classes, dtype=dtype,
                      attention_impl=cfg.attention_impl, device=device, **kw)
    model.init_parameters(torch.Generator(device=device).manual_seed(cfg.seed))
    return model


def _pack(ds, parts, batch: int, caps=None):
    """Worker-stacked [N, S, B, ...] arrays of each worker's (capped) shard,
    padded to the common step budget."""
    idxs = [p if caps is None else p[:caps[i] * batch]
            for i, p in enumerate(parts)]
    steps = max(step_budget([len(p) for p in idxs], batch), 1)
    packs = [pack_window(ds.images, ds.labels, p, batch, 0, steps)
             for p in idxs]
    return tuple(np.stack(a) for a in zip(*packs))


def train_global(cfg: Config, *, datasets=None, simulated_durations=None,
                 progress: bool = True) -> dict[str, Any]:
    """Run the experiment; returns the reference's metric structures.

    ``datasets``: optional (train, val, test) ``Dataset`` triple override.
    ``simulated_durations``: per-worker probe durations to use instead of
    measuring (tests, heterogeneity experiments)."""
    device = resolve_device(cfg.device)
    n = 1
    rng = np.random.default_rng(cfg.seed)
    if datasets is None:
        full_train, test = load_dataset(
            cfg.dataset, cfg.data_dir, cfg.seed,
            cfg.limit_train_samples, cfg.limit_eval_samples)
        trainset, valset = train_val_split(full_train, 0.2, cfg.seed)
    else:
        trainset, valset, test = datasets
    batch = cfg.batch_size
    model = build_model_for(cfg, trainset.num_classes, device)
    engine = LocalSGDEngine(model, cfg, device)
    state = engine.init_state()

    # --- probe -> ratios -> initial partition ---------------------------
    sample = torch.from_numpy(trainset.images[:batch]).to(device, torch.long)
    durations, sec_per_batch = probe_lib.estimate_epoch_duration(
        model, sample, n, cfg.probe_batches, simulated_durations)
    ratios = efficiency_ratios(durations, cfg.proportionality)
    log.info("probe durations %s -> ratios %s", durations, ratios)
    disbalanced = cfg.data_mode == "disbalanced"
    fixed_classes = ([fixed_classes_for_rank(r, trainset.num_classes)
                      for r in range(n)] if disbalanced else None)
    train_parts, val_parts = (
        adaptive_partition(len(ds), ratios, labels=ds.labels,
                           fixed_classes=fixed_classes,
                           fixed_ratio=cfg.fixed_ratio, rng=rng)
        for ds in (trainset, valset))

    results: dict[str, Any] = {
        "all_workers_losses": [[] for _ in range(n)],
        **{k: [] for k in (
            "all_epochs_losses", "global_epoch_losses",
            "global_epoch_accuracies", "global_train_losses",
            "global_train_accuracies", "global_val_losses",
            "global_val_accuracies", "worker_specific_train_losses",
            "worker_specific_train_accuracies", "worker_specific_val_losses",
            "worker_specific_val_accuracies", "step_caps", "shard_sizes",
            "round_timings")},
    }
    walls: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for epoch in range(cfg.epochs_global):
        # straggler protocol: per-worker step cap from the sec/batch EMA
        # and the time_limit budget
        caps = [budget_from_time_limit(int(np.ceil(len(p) / batch)),
                                       float(sec_per_batch[i]),
                                       cfg.time_limit)
                for i, p in enumerate(train_parts)]
        steps_run = np.array([min(int(np.ceil(len(p) / batch)), caps[i])
                              for i, p in enumerate(train_parts)],
                             np.float64)
        train_pack = _pack(trainset, train_parts, batch, caps)
        val_pack = _pack(valset, val_parts, batch)
        t0 = time.perf_counter()
        state, mx = engine.round(state, train_pack, val_pack)
        wall = time.perf_counter() - t0
        _assemble_round_metrics(results, mx, n)
        results["step_caps"].append(caps)
        results["shard_sizes"].append([len(p) for p in train_parts])
        results["round_timings"].append({
            "epoch": epoch, "compute_ms": wall * 1e3,
            "train_ms": mx["train_ms"], "train_steps": mx["train_steps"],
            "val_steps": mx["val_steps"]})
        if progress:
            _report(cfg, mx, epoch, wall, results)
        walls[epoch] = (np.full(n, wall), steps_run)
        if epoch + 1 == cfg.epochs_global:
            break
        # the EMA consumes walls one round late: rounds < epoch
        for r in sorted(k for k in walls if k < epoch):
            wall_r, steps_r = walls.pop(r)
            sec_per_batch = (0.5 * sec_per_batch
                             + 0.5 * wall_r / np.maximum(steps_r, 1.0))
        new_ratios = efficiency_ratios(
            sec_per_batch * np.maximum(steps_run, 1.0), cfg.proportionality)
        train_parts, val_parts = (
            [repartition(len(ds), parts[i], new_ratios[i], cfg.prev_fraction,
                         cfg.next_fraction, rng, replace=disbalanced)
             for i in range(n)]
            for ds, parts in ((trainset, train_parts), (valset, val_parts)))
        if disbalanced:
            train_parts, val_parts = (
                [skew_repartition(ds.labels, p, fixed_classes[i],
                                  cfg.fixed_ratio, rng)
                 for i, p in enumerate(parts)]
                for ds, parts in ((trainset, train_parts),
                                  (valset, val_parts)))

    results["state"] = state
    results["variables"] = engine.rank0_variables()
    results["model"] = model
    results["test"] = test
    return results


def _report(cfg: Config, mx: dict, epoch: int, wall: float,
            results: dict) -> None:
    """The reference's per-local-epoch report lines (trainer.py:109-110)
    and a global-epoch summary."""
    for e in range(np.asarray(mx["train_loss"]).shape[1]):
        print(f"Rank 0, Global Epoch {epoch + 1}, Local Epoch {e + 1}, "
              f"Loss: {mx['train_loss'][0, e]}, "
              f"Accuracy: {mx['train_acc'][0, e]}")
        print(f"Worker 0, Global Epoch {epoch + 1}, "
              f"Validation Loss: {mx['val_loss'][0, e]:.4f}, "
              f"Validation Accuracy: {mx['val_acc'][0, e]:.2f}%")
    print(f"Global Epoch {epoch + 1}/{cfg.epochs_global}: "
          f"loss={results['global_train_losses'][-1]:.4f} "
          f"acc={results['global_train_accuracies'][-1]:.2f}% "
          f"val_loss={results['global_val_losses'][-1]:.4f} "
          f"val_acc={results['global_val_accuracies'][-1]:.2f}% "
          f"({wall:.1f}s)")
