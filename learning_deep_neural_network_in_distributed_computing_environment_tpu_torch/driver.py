"""``train_global``: the orchestration loop (port of the JAX package's
``driver.py:67-125, 213-235``, serial), run by every rank of the worker
group (one call per process; ``group=None`` is the one-worker run).

1. load -> 80/20 train/val split;
2. timing probe -> shard-share ratios;
3. proportional partition of train and val (non-IID skew when
   disbalanced);
4. per global epoch: pack the worker's capped shard, run the round
   (``epochs_local`` x train + validation, then the sync point), assemble
   the reference metrics; with ``--stream_chunk_steps C`` the round
   streams fixed-shape windows of C steps instead (``chunk_feed``,
   ``LocalSGDEngine.round_streamed``; JAX ``driver.py:978-985, 1652``);
5. straggler feedback: every worker's measured round wall, divided by
   ``epochs_local``, feeds the sec/batch EMA one round late (as in the JAX
   driver's overlapped pipeline, whose serial mode uses the same delay),
   and each shard is re-partitioned from ``prev_fraction`` of its own
   indices plus ``next_fraction`` of the pool.

Every rank computes every worker's partition from the same
``np.random.default_rng(cfg.seed)`` stream and the same gathered inputs
(probe durations, walls), and packs its own worker's row of them, on
which its engine trains.  A float that differed between ranks would
desynchronise the shards without a sound, so the init and each round's
partition are checked by a gathered checksum.

With ``--sim_workers N`` the one process runs all N workers as the
scenario lab (``sim.SimEngine``; JAX ``driver.py:299-392, 762-765``): the
same probe (one measurement, tiled), partition and straggler feedback per
simulated worker, every worker's row packed into one [N, S, B, ...] pack,
the sync on the device, a drain of ``--sim_staleness``'s pending deltas
after the loop, and ``results["sim"]`` / ``results["sync_engine"]``.

With ``--checkpoint_dir`` every rank saves its worker row every
``--checkpoint_every`` rounds through ``checkpoint.CheckpointEngine`` (the
JAX package's format), and ``--resume`` restores the newest committed
epoch and runs only the rounds after it (JAX ``driver.py:799-862``,
without the chaos and elastic branches).

Returns the reference's metric structures under their original names,
plus ``step_caps``, ``shard_sizes``, ``round_timings`` (with
``ckpt_snapshot_ms``/``ckpt_write_ms``, zero on rounds that save nothing),
``checkpoint`` (the engine's summary), the final ``model``, ``variables``
and ``test`` set, and with several workers the round-0 train shards and
every rank's final parameter checksum.
"""

from __future__ import annotations

import hashlib
import logging
import os
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from . import comms, mesh
from . import probe as probe_lib
from . import weights
from .config import Config
from .data import (
    adaptive_partition,
    budget_from_time_limit,
    efficiency_ratios,
    fixed_classes_for_rank,
    load_dataset,
    pack_window,
    repartition,
    window_feed,
    skew_repartition,
    step_budget,
    train_val_split,
)
from .models import SHAPED_BY_INPUT, get_model, is_attention_model
from .sim import SimEngine
from .train import LocalSGDEngine, to_device

log = logging.getLogger(__name__)


def resolve_device(name: str | None) -> torch.device:
    """``cpu`` only when asked for; otherwise the card, or an error when
    there is none (the port never falls back to the CPU on its own)."""
    return mesh.worker_device(0, name)


def measured_worker_walls(walls_s, epochs_local: int) -> np.ndarray:
    """Every worker's measured round wall as the EMA takes it: divided by
    ``epochs_local``, since a round runs that many passes over the shard
    (JAX ``driver.py:1240-1241``)."""
    return np.asarray(walls_s, np.float64) / max(epochs_local, 1)


def _check_same(group, what: str, value: str) -> None:
    """Raise unless every rank of ``group`` holds the same ``value``."""
    values = mesh.all_gather(group, value)
    if len(set(values)) > 1:
        raise RuntimeError(
            f"the workers disagree on {what}: {values} (rank order); every "
            "rank must compute it from the same inputs")


def _partition_digest(train_parts, val_parts, caps) -> str:
    h = hashlib.sha256(np.asarray(caps, np.int64).tobytes())
    for p in (*train_parts, *val_parts):
        h.update(np.asarray(p, np.int64).tobytes())
    return h.hexdigest()


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


def build_model_for(cfg: Config, num_classes: int, device: torch.device,
                    input_shape: tuple | None = None):
    """The registry model at the configured compute dtype (and, for
    transformers, attention, remat policy and MoE FFN), initialized from
    ``cfg.seed`` with a generator on
    ``device``, in ``channels_last`` (a no-op for models without 4-D
    weights).  ``input_shape`` (one example's) sizes the first layer of
    the models flax sizes from their input (``mlp``, ``lenet5``)."""
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    kw = {}
    attention = is_attention_model(cfg.model)
    if attention:
        kw["attention_impl"] = cfg.attention_impl
    # the JAX driver's rules for the transformer knobs (driver.py:465-505,
    # 580-595): remat applies to the blocks of a transformer; the CNNs
    # have no blocks and run unrolled
    if cfg.remat_policy != "none":
        if not attention:
            raise ValueError(
                f"--remat_policy {cfg.remat_policy} applies to the layer "
                "stack of a homogeneous-block model (bert_*/gpt_*/llama_*/"
                f"vit_*); --model {cfg.model} runs unrolled")
        kw["remat_policy"] = cfg.remat_policy
    if cfg.grad_accum > 1 and not attention:
        raise ValueError(
            f"--grad_accum applies to attention models (bert_*/gpt_*/"
            f"vit_*/llama_* — no BatchNorm running stats to split across "
            f"microbatches); got --model {cfg.model}")
    if cfg.num_experts > 0:
        if not attention:
            raise ValueError(
                f"--num_experts applies to attention models (bert_*/gpt_*/"
                f"vit_*/llama_*); got --model {cfg.model}")
        kw.update(num_experts=cfg.num_experts,
                  capacity_factor=cfg.expert_capacity_factor)
    if cfg.num_kv_heads > 0:
        # grouped-query attention (models/llama.py; the Llama-2/3 recipe)
        if not cfg.model.startswith("llama"):
            raise ValueError(
                f"--num_kv_heads applies to llama_* models; got --model "
                f"{cfg.model}")
        kw["num_kv_heads"] = cfg.num_kv_heads
    if cfg.model_width:
        # the JAX driver's rule (driver.py:119-124)
        if cfg.model != "enhanced_cnn":
            raise ValueError(
                f"--model_width applies to --model enhanced_cnn; got "
                f"{cfg.model}")
        kw["width"] = cfg.model_width
    if input_shape is not None and cfg.model in SHAPED_BY_INPUT:
        kw["input_shape"] = tuple(input_shape)
    model = get_model(cfg.model, num_classes=num_classes, dtype=dtype,
                      device=device, **kw)
    model.init_parameters(torch.Generator(device=device).manual_seed(cfg.seed))
    return model.to(memory_format=torch.channels_last)


def checkpoint_metadata(cfg: Config, num_classes: int, model) -> dict:
    """The architecture facts MANIFEST.json carries, with the JAX driver's
    keys (``driver.py:128-187``), so ``main serve`` rebuilds the model from
    a checkpoint alone: one stacked layer collection for the transformers
    (``scan_layers``), no slices, the resolved optimizer placement and
    parameter residency (replicated: the resident layout is not ported)
    and the bucket size the round optimizer's rows follow;
    ``params_leaves`` lists every ``.params`` leaf as [path, per-worker
    shape, dtype]."""
    return {"model": cfg.model, "num_classes": int(num_classes),
            "scan_layers": is_attention_model(cfg.model),
            "compute_dtype": cfg.compute_dtype,
            "num_kv_heads": int(cfg.num_kv_heads),
            "num_experts": int(cfg.num_experts),
            "capacity_factor": float(cfg.expert_capacity_factor),
            "dataset": cfg.dataset,
            "opt_placement": cfg.resolve_opt_placement(),
            "param_residency": cfg.resolve_param_residency(),
            "sync_bucket_mb": float(cfg.sync_bucket_mb),
            "num_slices": 1,
            "params_leaves": weights.params_leaves(model)}


def _open_checkpoints(cfg: Config, model, num_classes: int, engine,
                      state, group):
    """The run's checkpoint engine (None without --checkpoint_dir) and,
    under --resume, the state restored from the newest committed epoch
    with the epoch to start at."""
    if not cfg.checkpoint_dir:
        return None, state, 0
    ckpt = ckpt_lib.CheckpointEngine(
        cfg.checkpoint_dir, keep=cfg.ckpt_keep, async_write=cfg.ckpt_async,
        metadata=checkpoint_metadata(cfg, num_classes, model), group=group)
    latest = ckpt.latest_checkpoint() if cfg.resume else None
    if not latest:
        return ckpt, state, 0
    # raises, naming both, when the worker count differs from the saved one
    restored, start = ckpt_lib.restore_checkpoint(
        latest, engine.checkpoint_state(state))
    state = engine.load_checkpoint_state(state, restored)
    log.info("resumed from %s at global epoch %d", latest, start)
    return ckpt, state, start


def _capped(parts, batch: int, caps=None) -> tuple[list, int]:
    """Each worker's (capped) indices and the common step budget."""
    idxs = [p if caps is None else p[:caps[i] * batch]
            for i, p in enumerate(parts)]
    return idxs, max(step_budget([len(p) for p in idxs], batch), 1)


def _pack(ds, parts, batch: int, rank: int, caps=None):
    """Worker ``rank``'s (capped) shard as a one-row pack [1, S, B, ...],
    padded to the common step budget: a process packs its own row only."""
    idxs, steps = _capped(parts, batch, caps)
    return tuple(a[None] for a in pack_window(ds.images, ds.labels,
                                              idxs[rank], batch, 0, steps))


def _pack_all(ds, parts, batch: int, caps=None):
    """Every worker's (capped) shard as one worker-stacked pack [N, S, B,
    ...] (the scenario lab's round input): ``_pack``'s rows, stacked."""
    rows = [_pack(ds, parts, batch, r, caps) for r in range(len(parts))]
    return tuple(np.concatenate(a) for a in zip(*rows))


def chunk_feed(ds, parts, batch: int, rank: int, chunk: int, caps=None):
    """The streamed alternative to ``_pack`` (JAX ``driver.py:978-985``):
    worker ``rank``'s per-epoch iterator of fixed-shape [chunk, B, ...]
    windows over the common step budget rounded up to whole windows."""
    idxs, steps = _capped(parts, batch, caps)
    steps = -(-steps // chunk) * chunk
    return window_feed(ds.images, ds.labels, idxs[rank], batch, chunk, steps)


def train_global(cfg: Config, *, datasets=None, simulated_durations=None,
                 simulated_round_durations: Callable | None = None,
                 group: mesh.Group | None = None, progress: bool = True
                 ) -> dict[str, Any]:
    """Run the experiment as worker ``group.rank`` of ``group`` (the one
    worker when None); returns the reference's metric structures.

    ``datasets``: optional (train, val, test) ``Dataset`` triple override.
    ``simulated_durations``: per-worker probe durations to use instead of
    measuring (tests, heterogeneity experiments).
    ``simulated_round_durations``: callable ``epoch -> [N] seconds`` used
    instead of the measured round walls (not divided by ``epochs_local``),
    as in the JAX driver (tests of the straggler feedback).
    ``progress``: the report lines and the "Global Epochs" bar (rank 0)."""
    if (cfg.serve_prefix_cache or cfg.serve_prefill_chunk
            or cfg.serve_draft_ckpt or cfg.serve_spec_tokens):
        # behaviour switches of the serving fast path: a training run
        # never runs the serve engine, so refuse them (JAX driver.py:255)
        raise ValueError(
            "--serve_prefix_cache/--serve_prefill_chunk/"
            "--serve_draft_ckpt/--serve_spec_tokens configure the "
            "serving fast path and only apply under `main serve` — the "
            "training driver never runs the serve engine; drop the flags "
            "from this run")
    sim = cfg.sim_workers > 0
    if sim and group is not None:
        raise ValueError(
            "--sim_workers runs every simulated worker in ONE process; "
            "it takes no worker group")
    if (not sim and group is None
            and mesh.resolve_num_workers(cfg.num_workers, cfg.device) > 1):
        raise ValueError(
            f"--num_workers {cfg.num_workers}: train_global runs one rank; "
            "N workers run through main.run (or driver.train_rank per rank)")
    n = (cfg.sim_workers if sim
         else 1 if group is None else group.world_size)
    rank = 0 if group is None else group.rank
    device = resolve_device(cfg.device) if group is None else group.device
    progress = progress and rank == 0
    rng = np.random.default_rng(cfg.seed)
    if datasets is None:
        full_train, test = load_dataset(
            cfg.dataset, cfg.data_dir, cfg.seed,
            cfg.limit_train_samples, cfg.limit_eval_samples)
        trainset, valset = train_val_split(full_train, 0.2, cfg.seed)
    else:
        trainset, valset, test = datasets
    batch = cfg.batch_size
    model = build_model_for(cfg, trainset.num_classes, device,
                            trainset.images.shape[1:])
    engine = (SimEngine(model, cfg, device) if sim
              else LocalSGDEngine(model, cfg, device, group))
    state = engine.init_state()
    if group is not None:
        # one init on every rank: the same seed gives the same init on one
        # device type; the JAX engine tiles one init (train.py:1187-1227)
        _check_same(group, "the initial parameters",
                    comms.checksum(engine.params))
    ckpt, state, start_epoch = _open_checkpoints(
        cfg, model, trainset.num_classes, engine, state, group)

    # --- probe -> ratios -> initial partition ---------------------------
    sample = to_device(trainset.images[:batch], device)
    durations, sec_per_batch = probe_lib.estimate_epoch_duration(
        model, sample, n, cfg.probe_batches, simulated_durations, group)
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
    if group is not None:
        results["initial_train_shards"] = [p.copy() for p in train_parts]
    epochs = range(start_epoch, cfg.epochs_global)
    pbar = None
    if progress:
        try:  # the reference's global-epoch bar (trainer.py:27,174)
            from tqdm import tqdm
            pbar = tqdm(epochs, desc="Global Epochs", initial=start_epoch,
                        total=cfg.epochs_global)
            epochs = pbar
        except ImportError:
            pass
    walls: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    if not sim:
        # the engine provenance of the run (JAX driver.py:925-951)
        results["sync_engine"] = {
            "mode": engine.sync_mode, "levels": cfg.resolve_sync_levels(),
            "num_slices": 1, "sync_bytes_ici": 0, "sync_bytes_dcn": 0,
            "opt_placement": engine.opt_placement,
            "param_residency": engine.param_residency,
            "per_worker_state_bytes": engine.state_resident_bytes(state)}
        log.info("round-sync engine: %s (topology=%s, wire=%s, "
                 "opt_placement=%s, param_residency=%s, shard_redundancy="
                 "%s, staleness=%d)", engine.sync_mode, cfg.topology,
                 cfg.sync_dtype, engine.opt_placement,
                 engine.param_residency, engine.shard_redundancy,
                 cfg.sync_staleness)
        sync_bytes = engine.sync_wire_bytes()
        # the dense path's own wire model (a ring all-reduce sends
        # 2(n-1)/n of the buffer); the fast engines send what they account
        wire_bytes = (comms.wire_bytes(
            sum(p.numel() for p in model.parameters()), cfg.topology, n)
            if engine.sync_mode == "dense" else sync_bytes)
    try:
        for epoch in epochs:
            # straggler protocol: per-worker step cap from the sec/batch EMA
            # and the time_limit budget
            caps = [budget_from_time_limit(int(np.ceil(len(p) / batch)),
                                           float(sec_per_batch[i]),
                                           cfg.time_limit)
                    for i, p in enumerate(train_parts)]
            steps_run = np.array([min(int(np.ceil(len(p) / batch)), caps[i])
                                  for i, p in enumerate(train_parts)],
                                 np.float64)
            if group is not None:
                _check_same(group, f"round {epoch}'s partition",
                            _partition_digest(train_parts, val_parts, caps))
            if cfg.stream_chunk_steps > 0:
                # the windows are packed inside the round, by its stager
                chunk = cfg.stream_chunk_steps
                run_round = engine.round_streamed
                inputs = (chunk_feed(trainset, train_parts, batch, rank,
                                     chunk, caps),
                          chunk_feed(valset, val_parts, batch, rank, chunk))
            else:
                run_round = engine.round
                inputs = ((_pack_all(trainset, train_parts, batch, caps),
                           _pack_all(valset, val_parts, batch)) if sim else
                          (_pack(trainset, train_parts, batch, rank, caps),
                           _pack(valset, val_parts, batch, rank)))
            t0 = time.perf_counter()
            state, mx = run_round(state, *inputs)
            wall = time.perf_counter() - t0
            _assemble_round_metrics(results, mx, n)
            results["step_caps"].append(caps)
            results["shard_sizes"].append([len(p) for p in train_parts])
            timing = {
                "epoch": epoch, "compute_ms": wall * 1e3,
                "train_ms": mx["train_ms"], "train_steps": mx["train_steps"],
                "val_steps": mx["val_steps"], "ckpt_snapshot_ms": 0.0,
                "ckpt_write_ms": 0.0}
            if sim:
                # the simulated fabric's row (JAX driver.py:1945-1950)
                timing.update(
                    {k: mx[k] for k in mx if k.startswith("workers_")},
                    **engine.last_sync_stats)
            else:
                # JAX's sync keys on every row (train.py:945-970): one flat
                # level, every byte intra-slice
                stats = engine.last_sync_stats
                timing.update(
                    {k: mx[k] for k in mx if k.startswith("workers_")},
                    sync_bytes=sync_bytes, sync_wire_bytes=wire_bytes,
                    sync_mode=stats["sync_mode"], sync_ms=stats["sync_ms"],
                    sync_hidden_ms=stats["sync_hidden_ms"],
                    sync_bytes_ici=sync_bytes, sync_bytes_dcn=0,
                    sync_ms_ici=stats["sync_ms"], sync_ms_dcn=0.0)
            results["round_timings"].append(timing)
            if ckpt is not None:
                if group is not None:
                    # publish the previous save's manifest now, in the
                    # same order on every rank (JAX driver.py:1764-1776)
                    ckpt.wait()
                if (cfg.checkpoint_every
                        and (epoch + 1) % cfg.checkpoint_every == 0):
                    ckpt.save(engine.checkpoint_state(state), epoch + 1,
                              timing=timing)
            if progress:
                _report(cfg, mx, epoch, wall, results, pbar)
            if simulated_round_durations is not None:
                worker_walls = np.asarray(simulated_round_durations(epoch),
                                          np.float64)
                if worker_walls.shape != (n,):
                    raise ValueError(
                        f"simulated_round_durations({epoch}) returned shape "
                        f"{worker_walls.shape}; the run has {n} workers")
            else:
                worker_walls = measured_worker_walls(mx["workers_wall_s"],
                                                     cfg.epochs_local)
            walls[epoch] = (worker_walls, steps_run)
            if epoch + 1 == cfg.epochs_global:
                break
            # the EMA consumes walls one round late: rounds < epoch
            for r in sorted(k for k in walls if k < epoch):
                wall_r, steps_r = walls.pop(r)
                sec_per_batch = (0.5 * sec_per_batch
                                 + 0.5 * wall_r / np.maximum(steps_r, 1.0))
            new_ratios = efficiency_ratios(
                sec_per_batch * np.maximum(steps_run, 1.0),
                cfg.proportionality)
            train_parts, val_parts = (
                [repartition(len(ds), parts[i], new_ratios[i],
                             cfg.prev_fraction, cfg.next_fraction, rng,
                             replace=disbalanced)
                 for i in range(n)]
                for ds, parts in ((trainset, train_parts),
                                  (valset, val_parts)))
            if disbalanced:
                train_parts, val_parts = (
                    [skew_repartition(ds.labels, p, fixed_classes[i],
                                      cfg.fixed_ratio, rng)
                     for i, p in enumerate(parts)]
                    for ds, parts in ((trainset, train_parts),
                                      (valset, val_parts)))
    finally:
        # success: drain the write in flight (N workers: the deferred
        # commit runs here, on every rank) and release the writer; while
        # unwinding: join the writer without the collective commit
        if ckpt is not None:
            if sys.exc_info()[0] is None:
                ckpt.close()
            else:
                ckpt.abort()
    if pbar is not None:
        pbar.close()
    state = engine.drain_pending(state)
    if not sim:
        results["sync_engine"]["sync_bytes_ici"] = (
            sync_bytes if results["round_timings"] else 0)
        results["sync_engine"]["per_worker_state_bytes"] = \
            engine.state_resident_bytes(state)
    results["async_rounds"] = async_rounds(
        cfg, getattr(engine, "stale_log", []))
    if sim:
        results["sim"] = engine.sim_summary(results["round_timings"], state)
        results["sync_engine"] = {
            "mode": "sim", "levels": {"inner": "sim", "outer": None},
            "num_slices": 1,
            "sync_bytes_ici": results["sim"]["per_worker_sync_bytes"],
            "sync_bytes_dcn": 0,
            # the lab's blend is stacked math on the whole rows (JAX
            # sim.py:117-118)
            "opt_placement": "replicated", "param_residency": "replicated",
            "per_worker_state_bytes": engine.state_resident_bytes(state)}
        log.info("scenario lab: %d simulated workers in one process, %s "
                 "rounds/s, %d bytes/worker sync wire",
                 results["sim"]["workers"], results["sim"]["rounds_per_s"],
                 results["sim"]["per_worker_sync_bytes"])
    if group is not None:
        results["param_checksums"] = mesh.all_gather(
            group, comms.checksum(engine.params))

    results["checkpoint"] = (ckpt.summary() if ckpt is not None
                             else {"enabled": False})
    results["state"] = state
    results["variables"] = (engine.rank0_variables(state) if sim
                            else engine.rank0_variables())
    results["model"] = model
    results["test"] = test
    return results


def async_rounds(cfg: Config, stale_log: list) -> dict:
    """``results["async_rounds"]`` with JAX's keys (``driver.py:1954-1980``):
    whether rounds overlapped their sync, how many deltas were delivered,
    and how much of the measured sync wall ran under compute."""
    if cfg.sync_staleness <= 0:
        return {"enabled": False}
    wall = sum(r["sync_ms"] for r in stale_log)
    hidden = sum(r["sync_hidden_ms"] for r in stale_log)
    out = {"enabled": True, "staleness": cfg.sync_staleness,
           "delivered": len(stale_log), "sync_ms_total": round(wall, 3),
           "sync_hidden_ms_total": round(hidden, 3),
           "hidden_fraction": round(hidden / wall, 4) if wall > 0 else 0.0}
    log.info("async rounds: staleness %d, %d consensus delta(s) delivered, "
             "%.1f ms sync wall, %.1f ms hidden under compute (%.0f%%)",
             cfg.sync_staleness, len(stale_log), wall, hidden,
             100.0 * out["hidden_fraction"])
    return out


def train_rank(rank: int, world_size: int, store_path: str,
               timeout_s: float, cfg: Config,
               train_kwargs: dict | None = None) -> dict[str, Any]:
    """Run ``train_global(cfg, **train_kwargs)`` as rank ``rank`` of a
    ``world_size``-worker group that meets at the FileStore
    ``store_path`` (``main.run``'s ranks; a spawn target)."""
    device = mesh.worker_device(rank, cfg.device)
    with mesh.init_group(rank, world_size, device, store_path,
                         timeout_s) as group:
        return train_global(cfg, group=group, **(train_kwargs or {}))


def round_worker(rank: int, world_size: int, store_path: str, cfgs: list,
                 num_classes: int, state_path: str, packs_path: str,
                 out_dir: str, timeout_s: float = mesh.GROUP_TIMEOUT_S,
                 rounds: list | None = None) -> None:
    """One rank of a round check (a spawn target): for each config of
    ``cfgs``, builds the model from the ``state_dict`` in ``state_path``
    (``torch.save``), runs ``rounds[i]`` engine rounds (default one) over
    the group on its row of the worker-stacked packs in ``packs_path``
    (npz: x, y, m, xv, yv, mv), drains what ``--sync_staleness`` left in
    flight, and saves ``{out_dir}/rank{rank}-{i}.pt``: the last round's
    metrics (``mx``) and every round's (``mxs``), the model's
    ``state_dict`` after the drain, the sync engine's state
    (``sync_residual``, ``round_opt``) and how many stale deltas were
    delivered in the rounds and in all."""
    state_dict = torch.load(state_path)
    with np.load(packs_path) as f:
        train_pack = (f["x"], f["y"], f["m"])
        val_pack = (f["xv"], f["yv"], f["mv"])
    device = mesh.worker_device(rank, cfgs[0].device)
    with mesh.init_group(rank, world_size, device, store_path,
                         timeout_s) as group:
        for i, cfg in enumerate(cfgs):
            model = build_model_for(cfg, num_classes, device,
                                    train_pack[0].shape[3:])
            model.load_state_dict(state_dict)
            engine = LocalSGDEngine(model, cfg, device, group)
            state, mxs = engine.init_state(), []
            for _ in range(rounds[i] if rounds else 1):
                state, mx = engine.round(state, train_pack, val_pack)
                mxs.append(mx)
            in_rounds = len(engine.stale_log)
            state = engine.drain_pending(state)
            torch.save({"mx": mxs[-1], "mxs": mxs,
                        "state_dict": model.state_dict(),
                        "opt_count": state.opt.count,
                        "sync_residual": state.sync_residual,
                        "round_opt": state.round_opt,
                        "stale_in_rounds": in_rounds,
                        "stale_log_len": len(engine.stale_log)},
                       os.path.join(out_dir, f"rank{rank}-{i}.pt"))


def _report(cfg: Config, mx: dict, epoch: int, wall: float,
            results: dict, pbar=None) -> None:
    """The reference's per-rank per-local-epoch report lines
    (trainer.py:109-110) for every worker, through ``pbar.write`` under
    the "Global Epochs" bar (its loss/accuracy/wall postfix then stands
    for the summary line), else ``print`` and a global-epoch summary."""
    say = pbar.write if pbar is not None else print
    n, epochs_local = np.asarray(mx["train_loss"]).shape
    for r in range(n):
        for e in range(epochs_local):
            say(f"Rank {r}, Global Epoch {epoch + 1}, Local Epoch {e + 1}, "
                f"Loss: {mx['train_loss'][r, e]}, "
                f"Accuracy: {mx['train_acc'][r, e]}")
            say(f"Worker {r}, Global Epoch {epoch + 1}, "
                f"Validation Loss: {mx['val_loss'][r, e]:.4f}, "
                f"Validation Accuracy: {mx['val_acc'][r, e]:.2f}%")
    if pbar is not None:  # trainer.py:174 postfix
        pbar.set_postfix(loss=results["global_train_losses"][-1],
                         accuracy=results["global_train_accuracies"][-1],
                         wall=f"{wall:.1f}s")
    else:
        print(f"Global Epoch {epoch + 1}/{cfg.epochs_global}: "
              f"loss={results['global_train_losses'][-1]:.4f} "
              f"acc={results['global_train_accuracies'][-1]:.2f}% "
              f"val_loss={results['global_val_losses'][-1]:.4f} "
              f"val_acc={results['global_val_accuracies'][-1]:.2f}% "
              f"({wall:.1f}s)")
