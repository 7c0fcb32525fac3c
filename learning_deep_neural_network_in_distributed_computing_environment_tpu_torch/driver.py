"""``train_global``: the orchestration loop (port of the JAX package's
``driver.py:67-125, 213-235``, with its overlapped round pipeline
:996-1208), run by every rank of the worker group (one call per process;
``group=None`` is the one-worker run).

1. load -> 80/20 train/val split;
2. timing probe -> shard-share ratios;
3. proportional partition of train and val (non-IID skew when
   disbalanced);
4. per global epoch: pack the worker's capped shard and stage it on the
   device, run the round (``epochs_local`` x train + validation, then the
   sync point), assemble the reference metrics; with
   ``--stream_chunk_steps C`` the round streams fixed-shape windows of C
   steps instead (``chunk_feed``, ``LocalSGDEngine.round_streamed``; JAX
   ``driver.py:978-985, 1652``);
5. straggler feedback: every worker's measured round wall, divided by
   ``epochs_local``, feeds the sec/batch EMA one round late, and each
   shard is re-partitioned from ``prev_fraction`` of its own indices plus
   ``next_fraction`` of the pool.

By default the rounds overlap their host work (JAX's default): while
round r runs, a prep thread builds round r+1's inputs (step 5, then the
pack and its staging), and a one-thread executor fetches, gathers and
assembles round r's metrics; ``--no_overlap_rounds`` runs the same data
flow inline, with bit-identical results.  ``round_timings`` carry JAX's
``stage_ms``, ``compute_ms``, ``fetch_ms``, ``assemble_ms``, ``prep_ms``
and ``gap_ms`` (the host time between a round's end and the next
dispatch; absent on the last round).  ``--sanitize`` runs each round under
the sync-debug guard (``_round_guard``; ``results["sanitize"]``),
``--profile_dir`` writes a ``torch.profiler`` trace of the round loop, and
every run reports ``results["memory"]`` (``probe.memory_report`` of the
engine's programs and its state bytes).

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
epoch and runs only the rounds after it (JAX ``driver.py:799-862``).

With ``--chaos`` the group is elastic (JAX ``driver.py:299-440,
1246-1600``): a schedule of kill/join/slow/stall/crash/nan faults keyed by
round (``chaos.py``), the straggler policy on the (perturbed) walls,
membership boundaries that regroup the processes through a snapshot
(``elastic.py``; ranks are roster positions, so the calling process stays
rank 0), the crash rollback that voids a round, rebuilds the crashed
positions' shard-resident rows from their buddies (or the newest
committed checkpoint) and re-runs it on the survivors, and the quarantine
of poisoned sync contributions with escalation to a departure.  The
per-worker metric lists are keyed by logical worker id, and
``results["elastic"]`` carries JAX's keys plus the roster of every round.
On the rank grid the roster is of worker blocks: a boundary writes each
rank's shards keyed by (position, inner coordinate), reshards every
coordinate by the one change, closes the grid's lines, re-forms the world
at D' x inner (``mesh.Membership.regroup``: a process keeps its inner
coordinates; a join spawns a whole block) and every rank installs through
``install``, which builds the grid anew; the screen's verdict is the AND
over each block.

On the rank grid (``--mesh_shape`` with ``fsdp``, ``seq``, ``pipe``,
``expert`` or ``model``; JAX ``driver.py:459-736``) the world of D x F x
S x P x E x T processes is cut by
``mesh.make_grid`` into per-axis gloo groups: each worker is the block of
ranks with one data coordinate, and everything above keyed by worker runs
on the data line (``group``) with one answer per worker that every rank
of it agrees on: the probe is the worker's first rank's, the partitions
and the initial parameters are checked across ranks, and the round's
metrics are gathered over every rank (``LocalSGDEngine.finish_metrics``).
Each rank builds the dense twin from the seed (the init, the probe), its
module (tensor-parallel over ``model``; with ``--sequence_parallel`` its
attention runs over the ``seq`` line; without it the seq ranks are
replicas of the whole step, as in JAX; over ``pipe`` its stage's L/P
blocks, the microbatches of each step run by ``--pp_schedule``; over
``expert`` its E/ep experts of every MoE layer) and its shards of the
dense twin's
parameters (``parallel.shards.GridParams``); the dense twin's parameters
are released after the probe and get the worker's whole parameters back
at the end, for the final evaluation.  Under ``--sanitize`` (or
``round_checksums``) the parameters are checked bitwise equal along
``seq`` after every round; the leaves every pipe stage holds are checked
bitwise equal along ``pipe``, and those every expert rank holds along
``expert``, after every round.  ``results["grid"]`` has the axes, every
rank's state bytes and its TP, FSDP, SP, PP and EP counters.

Launched (``run_launched``; JAX ``mesh.initialize_distributed``): P
independently started processes, one a host, told the coordinator by
JAX's three variables, make one world of the mesh's ranks at a
``TCPStore`` (``mesh.Launch``), process-major, every worker block within
one process; each process runs its first rank and spawns its others.
The run is the single launch's, in the serial round flow (JAX
``driver.py:1035``); ``--sim_workers``, ``--chaos`` and a worker count
the processes do not divide are refused before the rendezvous
(``check_launch``).  Each rank writes its shard into its own process's
``--checkpoint_dir`` and every rank the manifest (``--resume`` needs the
directory shared).

Returns the reference's metric structures under their original names,
plus ``step_caps``, ``shard_sizes``, ``round_timings`` (with
``ckpt_snapshot_ms``/``ckpt_write_ms``, zero on rounds that save nothing),
``checkpoint`` (the engine's summary), ``round_flow`` ("overlapped" or
"serial"), the final ``model``, ``variables`` and ``test`` set, and with
several workers the round-0 train shards and every rank's final
parameter checksum.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import logging
import os
import shutil
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from contextlib import contextmanager
from typing import Any, Callable

import numpy as np
import torch

from . import chaos as chaos_lib
from . import checkpoint as ckpt_lib
from . import comms, mesh
from . import elastic as elastic_lib
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
                    input_shape: tuple | None = None, tp=None, sp=None,
                    num_layers: int | None = None, ep=None):
    """The registry model at the configured compute dtype (and, for
    transformers, attention, remat policy and MoE FFN), initialized from
    ``cfg.seed`` with a generator on
    ``device``, in ``channels_last`` (a no-op for models without 4-D
    weights).  ``input_shape`` (one example's) sizes the first layer of
    the models flax sizes from their input (``mlp``, ``lenet5``).  ``tp``
    (the rank's ``model`` line) builds a transformer's tensor-parallel
    shard; its init is not the dense model's (``GridParams`` fills it).
    ``sp`` (the rank's ``seq`` line) builds a token model whose attention
    is ``--sequence_parallel``'s over that line.  ``num_layers`` builds a
    transformer with that many blocks: a pipeline stage's module.  ``ep``
    (the rank's ``expert`` line) builds MoE layers holding the rank's
    experts."""
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    kw = {}
    attention = is_attention_model(cfg.model)
    if attention:
        kw["attention_impl"] = cfg.attention_impl
    # the JAX driver's rules for the transformer knobs (driver.py:465-505,
    # 580-595): remat applies to the blocks of a transformer; the CNNs
    # have no blocks and run unrolled
    remat_policy = cfg.resolve_remat_policy()
    if remat_policy != "none":
        if not attention:
            raise ValueError(
                f"--remat_policy {remat_policy} applies to the layer "
                "stack of a homogeneous-block model (bert_*/gpt_*/llama_*/"
                f"vit_*); --model {cfg.model} runs unrolled")
        kw["remat_policy"] = remat_policy
    if cfg.grad_accum > 1 and not attention:
        raise ValueError(
            f"--grad_accum applies to attention models (bert_*/gpt_*/"
            f"vit_*/llama_* — no BatchNorm running stats to split across "
            f"microbatches); got --model {cfg.model}")
    if cfg.num_experts > 0:
        # (Config refuses experts on the non-attention models)
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
    if tp is not None:
        kw["tp"] = tp
    if ep is not None:
        kw["ep"] = ep
    if num_layers is not None:
        kw["num_layers"] = num_layers
    if sp is not None:
        # JAX driver.py:733-736: the train module's attention is the
        # sequence-parallel one (the dense twin keeps --attention_impl)
        kw.update(sp=sp, attention_impl=cfg.sequence_parallel)
    model = get_model(cfg.model, num_classes=num_classes, dtype=dtype,
                      device=device, **kw)
    if device.type != "meta":      # a meta model only propagates shapes
        model.init_parameters(
            torch.Generator(device=device).manual_seed(cfg.seed))
    return model.to(memory_format=torch.channels_last)


def checkpoint_metadata(cfg: Config, num_classes: int, model,
                        param_residency: str | None = None) -> dict:
    """The architecture facts MANIFEST.json carries, with the JAX driver's
    keys (``driver.py:128-187``), so ``main serve`` rebuilds the model from
    a checkpoint alone: one stacked layer collection for the transformers
    (``scan_layers``), the slice count (a restore re-lays resident rows
    across slice layouts, JAX ``driver.py:164-167``), the resolved
    optimizer placement and parameter residency (the engine's) and the
    bucket size the round optimizer's and the resident layout's rows
    follow;
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
            "param_residency": (param_residency
                                or cfg.resolve_param_residency()),
            "sync_bucket_mb": float(cfg.sync_bucket_mb),
            "num_slices": int(cfg.num_slices),
            "params_leaves": weights.params_leaves(model)}


def _open_checkpoints(cfg: Config, model, num_classes: int, engine,
                      state, group, *, schedule=None,
                      from_snapshot: bool = False, n: int = 1):
    # ``group``: every rank that writes a file (the grid's world)
    """The run's checkpoint engine (None without --checkpoint_dir) and,
    under --resume, the state restored from the newest committed epoch
    with the epoch to start at (JAX ``driver.py:799-862``, with its
    refusals of a resume across earlier membership events)."""
    if not cfg.checkpoint_dir:
        return None, state, 0
    ckpt = ckpt_lib.CheckpointEngine(
        cfg.checkpoint_dir, keep=cfg.ckpt_keep, async_write=cfg.ckpt_async,
        metadata=checkpoint_metadata(cfg, num_classes, model,
                                     engine.param_residency), group=group)
    if cfg.resume and from_snapshot:
        raise ValueError(
            "--resume and elastic_snapshot are mutually exclusive: a "
            "membership snapshot already fixes the starting state")
    latest = ckpt.latest_checkpoint() if cfg.resume else None
    if not latest:
        return ckpt, state, 0
    if schedule is not None:
        resume_epoch = int(os.path.basename(latest).removesuffix(".msgpack")
                           .rsplit("_", 1)[1])
        past = [e.describe() for e in schedule.events
                if e.kind in ("kill", "join", "crash")
                and e.round < resume_epoch]
        if past:
            raise ValueError(
                f"cannot resume at epoch {resume_epoch} across earlier "
                f"membership events {past}: checkpoint resume replays "
                "--chaos from the resume epoch, so membership events must "
                "land at rounds >= it")
        axis = (ckpt_lib.manifest_worker_axis(latest)
                if os.path.isdir(latest) else None)
        if axis is not None and axis != n:
            raise ValueError(
                f"cannot resume: checkpoint {latest} was written with "
                f"{axis} worker(s) but this run starts with {n} — a "
                "membership change (straggler departure or kill/join) "
                "happened before it was saved; restart fresh or resume a "
                "pre-change epoch")
    if engine.gp is not None:
        # the rank grid: whole leaves of this worker's row, cut for the
        # mesh being restored
        restored, start = ckpt_lib.restore_grid(
            latest, engine.checkpoint_state(state))
        state = engine.load_checkpoint_state(state, restored)
        log.info("resumed from %s at global epoch %d", latest, start)
        return ckpt, state, start
    # raises, naming both, when the worker count differs from the saved one
    restored, start = ckpt_lib.restore_checkpoint(
        latest, engine.checkpoint_state(state),
        params_template=engine.params_template,
        bucket_bytes=engine.sync_bucket_bytes, num_slices=cfg.num_slices)
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


def _snapshot_arg(elastic_snapshot, rank: int, coord: int | None = None):
    """``(snapshot, this rank's host row)`` of ``train_global``'s
    ``elastic_snapshot`` argument: a directory ``elastic.save_snapshot``
    wrote (what a spawned position gets), or a ``MembershipSnapshot``
    with its worker-stacked host state.  ``rank`` is the position,
    ``coord`` the inner coordinate on a rank grid."""
    if elastic_snapshot is None:
        return None, None
    if isinstance(elastic_snapshot, str):
        return elastic_lib.load_snapshot(elastic_snapshot, rank, coord)
    return (elastic_snapshot,
            elastic_lib.host_row(elastic_snapshot.host_state, rank, coord))


def _host_row_of(ws) -> dict:
    """A restored ``checkpoint.WorkerState`` (host arrays) as a host row
    (``LocalSGDEngine.host_row``'s dict)."""
    return {"params": ws.params or None, "buffers": ws.buffers,
            "mu": ws.mu, "nu": ws.nu, "count": int(ws.count),
            "lr_epoch": int(ws.lr_epoch), "rng": np.asarray(ws.rng),
            "sync_residual": ws.residual, "round_opt": ws.round_opt,
            "params_resident": ws.params_resident, "buddy": None}


# the sanitizer checks of the JAX driver that watch XLA (retraces,
# recompiles, declined donations): an eager round has none of them, so
# their counters stay 0 and results["sanitize"] names them
_XLA_ONLY_CHECKS = ("retrace_count", "recompile_count", "donation_failures")
# the message of torch's sync-debug error (c10 ``warn_or_error_on_sync``)
SYNC_DEBUG_ERROR = "called a synchronizing CUDA operation"


@contextmanager
def _round_guard(san: dict, device: torch.device):
    """``--sanitize``'s guard around one round (JAX ``_round_guard``):
    ``torch.cuda.set_sync_debug_mode("error")``, under which an implicit
    host<->device sync (``.item()``, a blocking copy, ``nonzero``) raises.
    An error of that kind is counted into
    ``san["transfer_guard_violations"]`` and re-raised; any other error
    passes uncounted.  The round's explicit staging (``stage_pack``) and
    its metric fetch (``finish_metrics``) run outside it, as JAX's
    explicit ``device_put``/``device_get`` pass its transfer guard.  The
    mode is process-wide, so the threads beside a round wait for the card
    by polling events, never by a blocking sync.  No-op when the sanitizer
    is off or the round runs on the CPU (no device to sync with)."""
    if not san["enabled"] or device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if SYNC_DEBUG_ERROR in str(e):
            san["transfer_guard_violations"] += 1
            log.error("sanitizer: implicit host-device sync in the round "
                      "loop: %s", e)
        raise
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _start_profile(profile_dir: str, device: torch.device):
    """``--profile_dir``: a ``torch.profiler`` trace of the round loop
    (JAX ``driver.py:987-994``), CPU and, on a card, CUDA activity; an
    unavailable CUDA tracer on the card is an error.  None when off."""
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile, supported_activities
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "--profile_dir: torch.profiler cannot trace the card here "
                f"(supported activities: {supported_activities()})")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, rank: int, write: bool) -> None:
    """Stop the trace; when ``write``, export it as
    ``{profile_dir}/trace_rank{rank}.json`` (one file per process)."""
    prof.stop()
    if write:
        path = os.path.join(profile_dir, f"trace_rank{rank}.json")
        prof.export_chrome_trace(path)
        log.info("profile: round-loop trace written to %s", path)


def train_global(cfg: Config, *, datasets=None, simulated_durations=None,
                 simulated_round_durations: Callable | None = None,
                 group: mesh.Group | None = None, progress: bool = True,
                 membership: mesh.Membership | None = None,
                 elastic_snapshot=None, initial_state_dict=None,
                 round_checksums: bool = False) -> dict[str, Any]:
    """Run the experiment as worker ``group.rank`` of ``group`` (the one
    worker when None); returns the reference's metric structures.

    ``datasets``: optional (train, val, test) ``Dataset`` triple override.
    ``simulated_durations``: per-worker probe durations to use instead of
    measuring (tests, heterogeneity experiments).
    ``simulated_round_durations``: callable ``epoch -> [N] seconds`` used
    instead of the measured round walls (not divided by ``epochs_local``),
    as in the JAX driver (tests of the straggler feedback); under
    elastic membership a vector indexed by logical worker id also works.
    ``progress``: the report lines and the "Global Epochs" bar (rank 0).
    ``membership``: the rank's ``mesh.Membership`` (``train_rank``'s), which
    an elastic run regroups at its boundaries; ``group`` is then its
    group.  ``elastic_snapshot``: a ``MembershipSnapshot`` (or the
    directory ``elastic.save_snapshot`` wrote) to start from: the fresh
    twin of an in-run membership transition, through the same install.
    ``initial_state_dict``: the module's starting ``state_dict`` (host
    arrays or tensors) in place of the seeded init (tests holding the port
    against the JAX driver).  ``round_checksums``: after every round,
    every rank's checksum of the parameters it holds for the next one
    (``results["round_checksums"]``; a resident run gathers for it)."""
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
    if cfg.pp_remat and "pipe" not in cfg.inner_axes():
        # JAX driver.py:460-464 (its config takes the flag)
        raise ValueError(
            "--pp_remat applies under pipeline parallelism (a 'pipe' "
            "mesh axis of size >= 2); without one the flag would "
            "silently do nothing — use --remat_policy with --layer_scan "
            "instead")
    if cfg.num_slices > 1 and elastic_snapshot is not None:
        raise ValueError(
            "elastic_snapshot cannot combine with --num_slices > 1 in "
            "v1: membership snapshots describe the flat worker axis "
            "(--chaos is likewise rejected at config time) — per-slice "
            "membership is the ROADMAP follow-on")
    if membership is not None:
        group = membership.group
    sim = cfg.sim_workers > 0
    # the rank grid (built below, with the rank's module): its data line
    # is the worker group from then on; ``rank`` is the position (the
    # data coordinate), ``coord`` the place in the worker's block
    grid = coord = None
    gridded = bool(cfg.inner_axes()) and not sim
    world = group
    if gridded:
        if group is None:
            raise ValueError(
                f"--mesh_shape {cfg.mesh_shape} runs a grid of processes: "
                "run it through main.run or driver.run_group")
        from .parallel import ep as ep_lib
        from .parallel import fsdp as fsdp_lib
        from .parallel import pp as pp_lib
        from .parallel import sp as sp_lib
        from .parallel import tp as tp_lib
        tp_lib.reset_stats()            # results["grid"] counts this run
        ep_lib.reset_stats()
        fsdp_lib.reset_stats()
        sp_lib.reset_stats()
        pp_lib.reset_stats()

    def grid_axes_of(world_group: mesh.Group) -> dict:
        """The mesh axes of a world of ``world_group.world_size`` ranks:
        the inner axes as the flag gives them, the data size the number
        of worker blocks (the roster's after a membership boundary)."""
        axes = mesh.grid_axes(cfg)
        axes["data"] = world_group.world_size // mesh.inner_size(axes)
        return axes
    if sim and group is not None:
        raise ValueError(
            "--sim_workers runs every simulated worker in ONE process; "
            "it takes no worker group")
    # the hierarchical sync's slice grid (JAX driver.py:349-385): every
    # partition, pack, probe and metric row below is per total worker
    # (the world of S x W ranks); the engine syncs over the two lines
    slices = None
    if cfg.num_slices > 1:
        if group is None:
            raise ValueError(
                f"--num_slices {cfg.num_slices} runs S x W worker "
                "processes: run it through main.run or driver.run_group")
        slices = mesh.make_grid(group, mesh.grid_axes(cfg, group.processes))
    if (not sim and group is None
            and mesh.world_size_of(mesh.grid_axes(cfg)) > 1):
        raise ValueError(
            f"--num_workers {cfg.num_workers}: train_global runs one rank; "
            "N workers run through main.run (or driver.train_rank per rank)")
    if gridded:
        axes0 = grid_axes_of(world)
        rank = mesh.coords_of(axes0, world.rank)["data"]
        coord = mesh.inner_index(axes0, world.rank)
    else:
        rank = 0 if group is None else group.rank
    # --- elastic membership + chaos (JAX driver.py:299-440) ------------
    schedule = chaos_lib.ChaosSchedule.from_config(cfg)
    snap, snap_row = _snapshot_arg(elastic_snapshot, rank, coord)
    if snap is not None and schedule is not None:
        # the snapshot IS the post-event state: membership events at
        # rounds <= its epoch are baked into its roster
        schedule = chaos_lib.ChaosSchedule(
            [e for e in schedule.events
             if e.kind not in ("kill", "join", "crash")
             or e.round > snap.epoch])
    crash_armed = schedule is not None and schedule.has_kind("crash")
    nan_armed = schedule is not None and schedule.has_kind("nan")
    policy = (chaos_lib.StragglerPolicy(
        cfg.time_limit, cfg.chaos_grace, cfg.chaos_retries,
        cfg.chaos_backoff) if schedule is not None else None)
    elastic_on = schedule is not None or snap is not None
    if elastic_on and membership is None:
        raise ValueError(
            "elastic membership (--chaos, elastic_snapshot) regroups the "
            "worker processes: run it through main.run or "
            "driver.run_group, which give every rank its membership")
    n = (cfg.sim_workers if sim else axes0["data"] if gridded
         else 1 if group is None else group.world_size)
    if snap is not None and snap.n_workers != n:
        raise ValueError(
            f"the membership snapshot holds {snap.n_workers} worker(s) but "
            f"this group has {n}")
    worker_ids = list(snap.worker_ids) if snap is not None else list(range(n))
    n_round0 = snap.n_round0 if snap is not None and snap.n_round0 else n
    if schedule is not None:
        schedule.pin_wall_targets(range(n_round0))
    # the capacity ceiling of a process group: none (a joiner is a new
    # process; on one card every process shares it)
    plan = elastic_lib.MembershipPlan(
        n, min_workers=cfg.elastic_min_workers, worker_ids=worker_ids,
        next_id=snap.next_worker_id if snap is not None else None)
    n_start = n
    pending_departs: list = []
    quarantine_strikes: dict[int, int] = {}
    el: dict[str, Any] = {"enabled": elastic_on, "events": [],
                          "rejected": [], "sync_retries": [],
                          "reshard_ms": [], "rounds_degraded": 0,
                          "snapshots": [], "crashes": 0, "recoveries": 0,
                          "recovery_source": [], "recovery_ms": [],
                          "quarantined_rounds": 0, "rosters": [],
                          "boundary_ms": []}
    device = resolve_device(cfg.device) if group is None else group.device
    progress = progress and (0 if world is None else world.rank) == 0
    rng = np.random.default_rng(cfg.seed)
    if datasets is None:
        full_train, test = load_dataset(
            cfg.dataset, cfg.data_dir, cfg.seed,
            cfg.limit_train_samples, cfg.limit_eval_samples)
        trainset, valset = train_val_split(full_train, 0.2, cfg.seed)
    else:
        trainset, valset, test = datasets
    batch = cfg.batch_size
    num_classes = trainset.num_classes
    model = build_model_for(cfg, num_classes, device,
                            trainset.images.shape[1:])
    if initial_state_dict is not None:
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(torch.from_numpy(np.array(initial_state_dict[name])))
    train_model, gp, vocab_parallel = model, None, False
    # the dense twin's parameter shapes: a grid built at a membership
    # boundary, when the twin holds none, cuts zeros of them (the row
    # staged next overwrites every shard)
    dense_shapes = {k: (tuple(p.shape), p.dtype)
                    for k, p in model.named_parameters()}

    def build_grid(world_group: mesh.Group) -> None:
        """The rank grid over ``world_group``, the rank's module and its
        shards of the dense twin's parameters (``model``, which keeps the
        init, the probe and the final evaluation); at setup and at every
        membership boundary (the new world's lines)."""
        nonlocal grid, group, train_model, gp, vocab_parallel
        grid = mesh.make_grid(world_group, grid_axes_of(world_group))
        group = grid.groups["data"]
        tp = grid.groups["model"] if grid.size("model") > 1 else None
        # seq splits the sequences only under --sequence_parallel (JAX
        # train.py:455-459); without it its ranks are replicas
        split_seq = cfg.sequence_parallel != "none"
        sp = (grid.groups["seq"] if grid.size("seq") > 1 and split_seq
              else None)
        # a pipe stage's module holds its L/P blocks (Config checks that
        # P divides L, as JAX models/bert.py:231 does)
        stage = (None if grid.size("pipe") == 1
                 else len(model.blocks) // grid.size("pipe"))
        # the MoE layers hold the rank's E/ep experts (Config checks that
        # ep divides E, as JAX models/moe.py:71 does)
        ep = grid.groups["expert"] if grid.size("expert") > 1 else None
        train_model = build_model_for(cfg, num_classes, device,
                                      trainset.images.shape[1:], tp=tp,
                                      sp=sp, num_layers=stage, ep=ep)
        train_model.load_state_dict(
            {k: b for k, b in model.state_dict().items()
             if k not in dict(model.named_parameters())}, strict=False)
        from .parallel.shards import GridParams
        dense = {k: (p.detach() if p.numel() else
                     torch.zeros(dense_shapes[k][0],
                                 dtype=dense_shapes[k][1]))
                 for k, p in model.named_parameters()}
        gp = GridParams(dense, weights.state_layout(model), train_model,
                        grid, device,
                        shard_tok_emb=cfg.model.startswith("gpt"),
                        split_seq=split_seq)
        # the tensor-parallel decode's output is its vocab slice (ViT's
        # classifier stays whole)
        vocab_parallel = tp is not None and cfg.model.startswith(
            ("bert", "gpt", "llama"))
        log.info("rank grid %s: rank %d at %s, %d of %d parameter "
                 "elements held", grid.axes, grid.world.rank, grid.coords,
                 sum(p.numel() for p in gp.params),
                 sum(int(np.prod(s)) for s, _d in dense_shapes.values()))

    if gridded and snap is None:
        build_grid(world)
    results: dict[str, Any] = {
        # keyed by LOGICAL worker id (JAX driver.py:80-82)
        "all_workers_losses": [[] for _ in range(max(worker_ids) + 1)],
        **{k: [] for k in (
            "all_epochs_losses", "global_epoch_losses",
            "global_epoch_accuracies", "global_train_losses",
            "global_train_accuracies", "global_val_losses",
            "global_val_accuracies", "worker_specific_train_losses",
            "worker_specific_train_accuracies", "worker_specific_val_losses",
            "worker_specific_val_accuracies", "step_caps", "shard_sizes",
            "round_timings")},
    }
    engine = state = ckpt = None
    sec_per_batch = train_parts = val_parts = fixed_classes = None
    disbalanced = cfg.data_mode == "disbalanced"

    def new_engine(grp):
        return (SimEngine(model, cfg, device) if sim
                else LocalSGDEngine(train_model, cfg, device, grp,
                                    nan_screen=nan_armed, grid_params=gp,
                                    vocab_parallel=vocab_parallel,
                                    slices=slices))

    def install(snapshot, row, grp) -> None:
        """Adopt a membership snapshot (JAX ``install_from_snapshot``):
        a fresh engine on ``grp`` (the new group: the sync's buckets and
        the gossip ring follow its size; on a rank grid the new world,
        whose grid, module and shards are built anew), this rank's row
        restaged, and the snapshot's roster, EMA, partitions and partition
        stream.  A fresh run from a snapshot calls this at setup, the
        continued run at the boundary: the same staging."""
        nonlocal engine, state, group, world, n, worker_ids, \
            sec_per_batch, train_parts, val_parts, fixed_classes
        world = group = grp
        if gridded:
            build_grid(grp)
        engine = new_engine(group)
        state = engine.stage_state(row)
        n = snapshot.n_workers
        worker_ids = list(snapshot.worker_ids)
        sec_per_batch = np.asarray(snapshot.sec_per_batch, np.float64).copy()
        train_parts = [np.asarray(p).copy() for p in snapshot.train_parts]
        val_parts = [np.asarray(p).copy() for p in snapshot.val_parts]
        fixed_classes = copy.deepcopy(snapshot.fixed_classes)
        rng.bit_generator.state = copy.deepcopy(snapshot.rng_state)
        for wid in worker_ids:   # joiners get lists of their own
            while len(results["all_workers_losses"]) <= wid:
                results["all_workers_losses"].append([])
        # every rank holds its row before the first round
        mesh.all_gather(world, None)

    if snap is None:
        engine = new_engine(group)
        state = engine.init_state()
        if group is not None:
            # one init on every rank: the same seed gives the same init on
            # one device type; the JAX engine tiles one init
            _check_same(group, "the initial parameters",
                        comms.checksum(engine.params))
    else:
        install(snap, snap_row, group)
        log.info("continuing from membership snapshot: round %d, workers "
                 "%s", snap.epoch, worker_ids)
    ckpt, state, start_epoch = _open_checkpoints(
        cfg, model, num_classes, engine, state, world, schedule=schedule,
        from_snapshot=snap is not None, n=n)

    if snap is None:
        # --- probe -> ratios -> initial partition -----------------------
        sample = to_device(trainset.images[:batch], device)
        if grid is not None and simulated_durations is None:
            # the dense twin's step on every rank; a worker's duration is
            # its first rank's, the same on each of its ranks
            local = probe_lib.measure_step_time(model, sample,
                                                cfg.probe_batches)
            durations = np.asarray(mesh.all_gather(grid.world, local),
                                   np.float64)[grid.block_leads()]
            sec_per_batch = durations / max(cfg.probe_batches, 1)
        else:
            durations, sec_per_batch = probe_lib.estimate_epoch_duration(
                model, sample, n, cfg.probe_batches, simulated_durations,
                group)
        ratios = efficiency_ratios(durations, cfg.proportionality)
        log.info("probe durations %s -> ratios %s", durations, ratios)
        fixed_classes = ([fixed_classes_for_rank(r, num_classes)
                          for r in range(n)] if disbalanced else None)
        train_parts, val_parts = (
            adaptive_partition(len(ds), ratios, labels=ds.labels,
                               fixed_classes=fixed_classes,
                               fixed_ratio=cfg.fixed_ratio, rng=rng)
            for ds in (trainset, valset))
        if group is not None:
            results["initial_train_shards"] = [p.copy() for p in train_parts]
    else:
        start_epoch = int(snap.epoch)
    if grid is not None:
        # the dense twin's parameters are the shards' now: its memory goes
        # until the end of the run gives it the whole parameters back
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.new_empty(0)
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
    # round -> (its walls, or a thunk that waits for its metric job; the
    # steps it ran): the EMA consumes them one round late
    walls: dict[int, tuple[Any, np.ndarray]] = {}
    walls_lock = threading.Lock()
    # the round pipeline's work beside the main thread: the next round's
    # prep (a dict, or its future while it runs) and the metric jobs
    prep: Any = None
    pending: list[Future] = []

    def engine_summary() -> None:
        # the engine provenance of the run (JAX driver.py:925-951)
        results["sync_engine"] = {
            "mode": engine.sync_mode, "levels": cfg.resolve_sync_levels(),
            "num_slices": int(cfg.num_slices), "sync_bytes_ici": 0,
            "sync_bytes_dcn": 0,
            "opt_placement": engine.opt_placement,
            "param_residency": engine.param_residency,
            "per_worker_state_bytes": engine.state_resident_bytes(state)}

    def wire_bytes_of() -> tuple[int, int, tuple[int, int]]:
        sync_bytes = engine.sync_wire_bytes()
        # the dense path's own wire model (a ring all-reduce sends
        # 2(n-1)/n of the buffer); the fast engines send what they account
        wire = (comms.wire_bytes(
            sum(p.numel() for p in engine.params), cfg.topology, n)
            if engine.sync_mode == "dense" else sync_bytes)
        return sync_bytes, wire, engine.sync_wire_split()

    if not sim:
        engine_summary()
        # (JAX driver.py:776-780: the wire per level and the slices)
        wires = cfg.resolve_sync_wire_dtypes()
        log.info("round-sync engine: %s (topology=%s, wire=%s, "
                 "opt_placement=%s, param_residency=%s, shard_redundancy="
                 "%s, staleness=%d%s)", engine.sync_mode, cfg.topology,
                 "/".join(wires) if cfg.num_slices > 1 else wires[0],
                 engine.opt_placement, engine.param_residency,
                 engine.shard_redundancy, cfg.sync_staleness,
                 f", num_slices={cfg.num_slices}" if cfg.num_slices > 1
                 else "")
        sync_bytes, wire_bytes, wire_split = wire_bytes_of()

    def consume_walls(upto: int) -> None:
        """Blend the recorded walls of rounds < ``upto`` into the EMA, in
        round order (one round late, as the JAX driver's pipeline does).
        Runs on the prep thread while a round computes: a round's walls
        may still be the thunk that waits for its metric job."""
        nonlocal sec_per_batch
        with walls_lock:
            due = [walls.pop(r) for r in sorted(k for k in walls if k < upto)]
        for wall_r, steps_r in due:
            if callable(wall_r):
                wall_r = wall_r()
            sec_per_batch = (0.5 * sec_per_batch
                             + 0.5 * wall_r / np.maximum(steps_r, 1.0))

    def settle_pipeline() -> None:
        """Finish what runs beside the main thread (before a membership
        boundary): the prep in flight, whose repartition has drawn from
        ``rng`` (so the partitions the snapshot takes are final), and every
        metric job (every wall on record, the metric group idle before
        the group is re-formed)."""
        nonlocal prep
        if isinstance(prep, Future):
            prep = prep.result()
        while pending:
            pending.pop(0).result()

    def transition(rnd: int, change, row: dict, lost=None):
        """Move the group to ``change``'s roster (module docstring of
        ``elastic.py``); returns the recovery source of a crash (None
        otherwise) and whether this rank retired."""
        work = membership.boundary_dir()
        old_row = lambda p, c: os.path.join(
            work, f"old{p}.pkl" if c is None else f"old{p}_c{c}.pkl")
        # 1. every rank's row, keyed by (position, inner coordinate)
        elastic_lib.write_row(old_row(rank, coord), row)
        mesh.all_gather(world, None)
        status: tuple = ("ok", None, 0.0)
        if world.rank == 0:
            try:
                t0 = time.perf_counter()
                # 2. the rows stacked over the workers, per coordinate on
                # a grid; the one change applied to each coordinate
                stack = lambda c: elastic_lib.stack_rows(
                    [elastic_lib.read_row(old_row(p, c)) for p in range(n)])
                host = ({c: stack(c)
                         for c in range(mesh.inner_size(grid.axes))}
                        if grid is not None else stack(None))
                source = None
                if lost is not None:
                    host, source = recover_rows(host, lost, rnd)
                opt_pl = (engine.opt_placement if engine.round_opt_on
                          else None)
                new = elastic_lib.build_snapshot(
                    epoch=rnd, change=change, old_state=host,
                    sec_per_batch=sec_per_batch, seed=cfg.seed,
                    num_classes=num_classes, trainset_len=len(trainset),
                    valset_len=len(valset),
                    proportionality=cfg.proportionality,
                    data_mode=cfg.data_mode, fixed_ratio=cfg.fixed_ratio,
                    rng=rng, trainset_labels=trainset.labels,
                    valset_labels=valset.labels, next_worker_id=plan.next_id,
                    n_round0=n_round0, round_opt_placement=opt_pl,
                    sync_bucket_bytes=engine.sync_bucket_bytes,
                    params_template=engine.params_template)
                elastic_lib.save_snapshot(new, os.path.join(work, "new"))
                el["snapshots"].append(elastic_lib.snapshot_copy(new))
                status = ("ok", source, (time.perf_counter() - t0) * 1e3)
            except Exception as err:   # every rank raises it below
                log.exception("elastic: round %d transition failed", rnd)
                status = ("error", f"{type(err).__name__}: {err}", 0.0)
        status = mesh.all_gather(world, status)[0]
        if status[0] != "ok":
            raise RuntimeError(
                f"the round-{rnd} membership transition failed on rank 0: "
                f"{status[1]}")
        # 3. the old lines closed and the world left; the new world of
        # D' blocks (each process keeps its inner coordinates), the
        # joiners' blocks spawned, the surplus blocks retired
        axes = None
        if grid is not None:
            axes = dict(grid.axes)
            grid.close()
        new_world = membership.regroup(len(change.worker_ids),
                                       os.path.join(work, "new"), axes)
        if new_world is None:
            return status[1], True
        # 4. every rank installs its row (a grid: its lines made anew)
        new_snap, new_row = elastic_lib.load_snapshot(
            os.path.join(work, "new"), rank, coord)
        install(new_snap, new_row, new_world)
        if ckpt is not None:
            ckpt.rebind(world)
        if world.rank == 0:
            shutil.rmtree(work, ignore_errors=True)
        el["boundary_ms"].append(round(status[2], 3))
        return status[1], False

    def recover_rows(host, lost: list[int], rnd: int):
        """Rank 0: the crashed positions' rows from their buddies, or the
        newest committed checkpoint's rows (JAX ``recover_from_crash``'s
        ladder)."""
        uniquely_held = (engine.resident_on
                         or (engine.round_opt_on
                             and engine.opt_placement == "sharded"))
        try:
            host = elastic_lib.per_coordinate(
                lambda h: elastic_lib.restore_crashed_rows(
                    h, lost, params_template=engine.params_template,
                    sync_bucket_bytes=engine.sync_bucket_bytes,
                    round_opt_placement=(engine.opt_placement
                                         if engine.round_opt_on else None)),
                host)
            return host, "buddy" if uniquely_held else "snapshot"
        except ValueError as e:
            log.warning("elastic: in-memory buddy recovery unavailable (%s)"
                        " — degrading to the newest committed checkpoint",
                        e)
            if ckpt is None:
                raise RuntimeError(
                    f"crash at round {rnd} is unrecoverable: {e}; no "
                    "--checkpoint_dir is configured to degrade to") from e
            latest = ckpt_lib.latest_checkpoint(cfg.checkpoint_dir)
            if latest is None:
                raise RuntimeError(
                    f"crash at round {rnd} is unrecoverable: {e}; no "
                    "committed checkpoint exists yet") from e
            template = engine.checkpoint_state(state)
            rows, ck_epoch = [], 0
            for w in range(n):
                ws, ck_epoch = ckpt_lib.restore_checkpoint(
                    latest, dataclasses.replace(template, worker=w),
                    params_template=engine.params_template,
                    bucket_bytes=engine.sync_bucket_bytes)
                rows.append(_host_row_of(ws))
            if ck_epoch < rnd:
                log.warning(
                    "elastic: checkpoint fallback rewound %d round(s) "
                    "(checkpoint epoch %d < crash round %d)", rnd - ck_epoch,
                    ck_epoch, rnd)
            return elastic_lib.stack_rows(rows), "checkpoint"

    def membership_boundary(rnd: int) -> bool:
        """The boundary entering ``rnd`` (JAX ``membership_boundary``):
        scripted kill/join events plus last round's departures; on a
        change, the transition.  Returns whether this rank retired."""
        nonlocal prep
        events = list(pending_departs)
        if schedule is not None:
            events += schedule.membership_events(rnd)
        if not events:
            return False
        change = plan.apply(events, resolve=(schedule.resolve_target
                                             if schedule is not None
                                             else None))
        pending_departs.clear()
        if change.rejected:
            el["rejected"].extend(change.rejected)
            for r in change.rejected:
                log.warning("elastic: membership event rejected: %s", r)
        if not change.changed:
            return False
        t0 = time.perf_counter()
        settle_pipeline()
        consume_walls(rnd)
        walls.clear()
        if policy is not None:
            policy.reset()
        if ckpt is not None:
            ckpt.wait()
        _source, retired = transition(rnd, change, engine.host_row(state))
        # the prep built for the old roster is dead: the round's inputs
        # are made again from the snapshot's partitions (as JAX does)
        prep = None
        el["events"].extend(change.applied)
        reshard_ms = round((time.perf_counter() - t0) * 1e3, 3)
        el["reshard_ms"].append(reshard_ms)
        log.info("elastic: round %d boundary applied %s -> %d worker(s) %s;"
                 " reshard stall %.1f ms", rnd, change.applied,
                 len(change.worker_ids), change.worker_ids, reshard_ms)
        return retired

    def recover_from_crash(rnd: int, crashed: list[int], row: dict) -> bool:
        """Round ``rnd`` is void (JAX ``recover_from_crash``): roll back to
        the boundary rows, rebuild the crashed positions' shard-resident
        rows, remove the workers through the same plan -> snapshot ->
        install path, and let the caller re-run the round.  Returns
        whether this rank retired."""
        nonlocal prep
        t0 = time.perf_counter()
        el["crashes"] += len(crashed)
        log.warning("elastic: worker(s) %s missed the round-%d fence "
                    "(CRASHED mid-round) — rolling back to the round "
                    "boundary", crashed, rnd)
        consume_walls(rnd)
        walls.clear()
        if policy is not None:
            policy.reset()
        pending_departs.clear()
        quarantine_strikes.clear()
        positions = [worker_ids.index(c) for c in crashed]
        change = plan.apply([chaos_lib.ChaosEvent(kind="crash", round=rnd,
                                                  worker=int(c))
                             for c in crashed])
        if change.rejected or not change.applied:
            el["rejected"].extend(change.rejected)
            raise RuntimeError(
                f"crash of worker(s) {crashed} cannot be applied to the "
                f"membership {worker_ids} (quorum floor "
                f"{cfg.elastic_min_workers}): {change.rejected} — a "
                "crashed worker is gone regardless, so the run cannot "
                "continue")
        if ckpt is not None:
            ckpt.wait()
        source, retired = transition(rnd, change, row, lost=positions)
        prep = None                # the re-run's inputs, from the snapshot
        el["events"].extend(change.applied)
        el["recoveries"] += 1
        el["recovery_source"].append(source)
        recovery_ms = round((time.perf_counter() - t0) * 1e3, 3)
        el["recovery_ms"].append(recovery_ms)
        log.info("elastic: round %d crash recovery via %s -> %d worker(s) "
                 "%s; stall %.1f ms (the round re-runs)", rnd, source,
                 len(change.worker_ids), change.worker_ids, recovery_ms)
        return retired

    def process_quarantine(rnd: int, okv) -> None:
        """Per-worker sync validity -> quarantine strikes (JAX
        ``process_quarantine``): more than ``--chaos_retries`` consecutive
        strikes depart the worker at the next boundary."""
        for pos, wid in enumerate(worker_ids):
            if okv[pos] > 0:
                quarantine_strikes.pop(wid, None)
                continue
            k = quarantine_strikes.get(wid, 0) + 1
            quarantine_strikes[wid] = k
            el["quarantined_rounds"] += 1
            log.warning("elastic: worker %d's round-%d sync contribution "
                        "was quarantined (poisoned/non-finite) — blend "
                        "renormalized over the survivors; strike %d "
                        "(budget %d)", wid, rnd, k, cfg.chaos_retries)
            if k > cfg.chaos_retries:
                quarantine_strikes.pop(wid, None)
                log.warning("elastic: worker %d exhausted the quarantine "
                            "strike budget — departing at the next round "
                            "boundary", wid)
                pending_departs.append(chaos_lib.ChaosEvent(
                    kind="depart", round=rnd + 1, worker=int(wid)))

    def round_walls(epoch: int, mx, n_: int, ids: list) -> np.ndarray:
        """Round ``epoch``'s per-worker walls on roster ``ids`` (``n_``
        workers): measured (``mx``, its metrics or their future) or
        simulated, then the chaos schedule's perturbation."""
        if simulated_round_durations is None:
            if isinstance(mx, Future):
                mx = mx.result()
            worker_walls = measured_worker_walls(mx["workers_wall_s"],
                                                 cfg.epochs_local)
        else:
            worker_walls = np.asarray(simulated_round_durations(epoch),
                                      np.float64)
            if worker_walls.shape != (n_,):
                # elastic runs: a vector indexed by logical id also works
                # (JAX driver.py:1214-1228)
                if (elastic_on and worker_walls.ndim == 1
                        and len(worker_walls) > max(ids)):
                    worker_walls = worker_walls[ids]
                else:
                    raise ValueError(
                        f"simulated_round_durations({epoch}) returned shape "
                        f"{worker_walls.shape}; the run has {n_} workers")
        if schedule is not None:
            worker_walls = schedule.perturb_walls(epoch, ids, worker_walls)
        return worker_walls

    # --- the round pipeline (JAX driver.py:996-1208) ---------------------
    # Overlapped (the default): while round r runs on the main thread, a
    # prep thread builds round r+1's inputs (the walls through r-1 into
    # the EMA, repartition, skew, caps, pack, and the copy to the card
    # through pinned memory on a side stream), and after it a one-thread
    # executor fetches, gathers (on the engine's own metric group) and
    # assembles round r's metrics.  --no_overlap_rounds runs the same data
    # flow inline; the EMA takes the walls one round late in both, so the
    # two give bit-identical results.  An eager round is fenced when it
    # returns, so there is no counterpart of JAX's two rounds in flight.
    # Crash and NaN arming force the serial flow, as in JAX: a crash voids
    # a round before its metrics are assembled, and the quarantine reads
    # each round's validity flags before the next boundary.
    # a launched world runs the serial flow, as JAX's multi-process
    # driver does (driver.py:1035)
    launched = world is not None and world.processes > 1
    overlap = (cfg.overlap_rounds and not launched
               and not (crash_armed or nan_armed))
    results["round_flow"] = "overlapped" if overlap else "serial"
    streaming = cfg.stream_chunk_steps > 0
    prep_pool = metrics_pool = None
    if overlap:
        prep_pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="round-prep")
        metrics_pool = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="round-metrics")

    def make_prep(tparts, vparts) -> dict:
        """Caps and staged inputs of the round about to run, from the
        current sec/batch EMA (the straggler protocol: per-worker step
        cap from the EMA and the time_limit budget)."""
        caps = [budget_from_time_limit(
            int(np.ceil(len(p) / batch)), float(sec_per_batch[i]),
            cfg.time_limit) for i, p in enumerate(tparts)]
        steps_run = np.array([min(int(np.ceil(len(p) / batch)), caps[i])
                              for i, p in enumerate(tparts)], np.float64)
        if streaming:
            # the windows are packed inside the round, by its stager
            chunk = cfg.stream_chunk_steps
            inputs = (chunk_feed(trainset, tparts, batch, rank, chunk, caps),
                      chunk_feed(valset, vparts, batch, rank, chunk))
        elif sim:
            inputs = engine.stage_pack(_pack_all(trainset, tparts, batch,
                                                 caps),
                                       _pack_all(valset, vparts, batch))
        else:
            inputs = engine.stage_pack(
                _pack(trainset, tparts, batch, rank, caps),
                _pack(valset, vparts, batch, rank))
        return dict(caps=caps, steps_run=steps_run,
                    sizes=[len(p) for p in tparts], inputs=inputs,
                    digest=(_partition_digest(tparts, vparts, caps)
                            if group is not None else None))

    def prepare_next(epoch: int, steps_run: np.ndarray,
                     timing: dict) -> dict:
        """Round ``epoch + 1``'s prep: the walls through ``epoch - 1``
        into the EMA, then every worker's shard re-partitioned from
        ``prev_fraction`` of its own indices plus ``next_fraction`` of the
        pool, with the round durations modeled as EMA sec/batch x the
        steps round ``epoch`` runs (JAX ``prepare_next``)."""
        nonlocal train_parts, val_parts
        t0 = time.perf_counter()
        consume_walls(epoch)
        new_ratios = efficiency_ratios(
            sec_per_batch * np.maximum(steps_run, 1.0), cfg.proportionality)
        train_parts, val_parts = (
            [repartition(len(ds), parts[i], new_ratios[i],
                         cfg.prev_fraction, cfg.next_fraction, rng,
                         replace=disbalanced)
             for i in range(len(parts))]
            for ds, parts in ((trainset, train_parts), (valset, val_parts)))
        if disbalanced:
            train_parts, val_parts = (
                [skew_repartition(ds.labels, p, fixed_classes[i],
                                  cfg.fixed_ratio, rng)
                 for i, p in enumerate(parts)]
                for ds, parts in ((trainset, train_parts),
                                  (valset, val_parts)))
        out = make_prep(train_parts, val_parts)
        timing["prep_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    def fetch(finish, handle, timing: dict) -> dict:
        t0 = time.perf_counter()
        mx = finish(handle)
        timing["fetch_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        timing.update({k: mx[k] for k in mx
                       if k.startswith(("workers_", "ranks_"))})
        return mx

    def assemble(mx: dict, epoch: int, t_disp: float, timing: dict,
                 ids: list) -> None:
        t0 = time.perf_counter()
        _assemble_round_metrics(results, mx, ids)
        timing["assemble_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        if progress:
            _report(cfg, mx, epoch, time.perf_counter() - t_disp, results,
                    pbar, ids)

    def metrics_job(finish, handle, epoch: int, t_disp: float,
                    timing: dict, ids: list) -> dict:
        """The overlapped flow's metric job (JAX ``metrics_job``): fetch
        (``finish``: the round's engine's ``finish_metrics``), assemble and
        report round ``epoch`` on the executor thread, with the round's
        own roster ``ids``."""
        mx = fetch(finish, handle, timing)
        assemble(mx, epoch, t_disp, timing, ids)
        return mx

    seq_checked = (0 if grid is not None and grid.size("seq") > 1
                   and (cfg.sanitize or round_checksums) else None)
    # the leaves every pipe stage holds: checked bitwise equal along pipe
    # after every round
    pipe_checked = (0 if grid is not None and grid.size("pipe") > 1
                    else None)
    # the leaves every expert rank holds: checked bitwise equal along
    # expert after every round
    expert_checked = (0 if grid is not None and grid.size("expert") > 1
                      else None)
    san: dict[str, Any] = {"enabled": cfg.sanitize,
                           "transfer_guard_violations": 0,
                           "retrace_count": 0, "recompile_count": 0,
                           "donation_failures": 0,
                           "not_applicable": list(_XLA_ONLY_CHECKS)}
    profiler = t_ready = None
    retired = False
    # the train and validation steps this rank ran, a voided (crashed)
    # round's among them
    steps_ran = [0, 0]
    try:
        profiler = _start_profile(cfg.profile_dir, device)
        if start_epoch < cfg.epochs_global:
            prep = make_prep(train_parts, val_parts)
        for epoch in epochs:
            # a metric job's error ends the run within a round
            while pending and pending[0].done():
                pending.pop(0).result()
            if elastic_on:
                if membership_boundary(epoch):
                    retired = True
                    break
                if n < n_start:
                    el["rounds_degraded"] += 1
            last_round = epoch + 1 == cfg.epochs_global
            while True:
                if prep is None:
                    prep = make_prep(train_parts, val_parts)
                elif isinstance(prep, Future):
                    prep = prep.result()
                boundary_row = (engine.host_row(state) if crash_armed
                                else None)
                if group is not None:
                    # every rank (the grid's world, or the roster's group)
                    _check_same(world, f"round {epoch}'s partition",
                                prep["digest"])
                if nan_armed:
                    # on a grid the fault poisons one shard of the
                    # worker's contribution, its first rank's: the
                    # screen's block-wide verdict quarantines the worker
                    engine.stage_poison(
                        worker_ids[rank] in schedule.nan_targets(
                            epoch, worker_ids) and not coord)
                timing: dict[str, Any] = {"epoch": epoch,
                                          "ckpt_snapshot_ms": 0.0,
                                          "ckpt_write_ms": 0.0}
                nxt = None
                if overlap and not last_round:
                    # round epoch + 1's prep runs beside this round
                    nxt = prep_pool.submit(prepare_next, epoch,
                                           prep["steps_run"], timing)
                t_disp = time.perf_counter()
                if t_ready is not None:
                    # the host gap between the previous round's end and
                    # this dispatch: what the overlap exists to shrink
                    results["round_timings"][-1]["gap_ms"] = round(
                        (t_disp - t_ready) * 1e3, 3)
                with _round_guard(san, device):
                    state, handle = (engine.round_streamed_start
                                     if streaming else engine.round_start)(
                        state, *prep["inputs"])
                t_ready = time.perf_counter()
                steps_ran[0] += handle["train_steps"]
                steps_ran[1] += handle["val_steps"]
                timing.update(stage_ms=handle["stage_ms"],
                              compute_ms=(t_ready - t_disp) * 1e3,
                              train_ms=handle["train_ms"],
                              train_steps=handle["train_steps"],
                              val_steps=handle["val_steps"])
                ids = list(worker_ids)
                if overlap:
                    mx = metrics_pool.submit(
                        metrics_job, engine.finish_metrics, handle, epoch,
                        t_disp, timing, ids)
                    pending.append(mx)
                else:
                    mx = fetch(engine.finish_metrics, handle, timing)
                crashed: list[int] = []
                walls_src: Any = functools.partial(round_walls, epoch, mx,
                                                   n, ids)
                if policy is not None:
                    # overruns past the backoff-extended deadline are
                    # logged retries, then a departure at the next
                    # boundary; a non-finite wall is the CRASHED verdict:
                    # the round is void.  The verdict must stand before
                    # the next boundary, so the walls are read now
                    walls_src = walls_src()
                    departed, crashed, retries = policy.observe(ids,
                                                                walls_src)
                    if not crashed:
                        el["sync_retries"].extend(retries)
                        for r in retries:
                            log.warning("elastic: straggler retry %s", r)
                        for wid in departed:
                            log.warning(
                                "elastic: worker %d overran its straggler "
                                "budget in round %d — departing at the next "
                                "round boundary", wid, epoch)
                            pending_departs.append(chaos_lib.ChaosEvent(
                                kind="depart", round=epoch + 1,
                                worker=int(wid)))
                if not crashed:
                    break
                if boundary_row is None:
                    raise RuntimeError(
                        f"worker(s) {crashed} reported a non-finite "
                        f"round-{epoch} wall but no crash fault is armed "
                        "(--chaos has no crash events), so no rollback "
                        "boundary rows exist — fix the wall injection or "
                        "script the crash")
                # the voided attempt wrote the previous round's gap; the
                # re-run must not overwrite it with the recovery stall
                t_ready = None
                if recover_from_crash(epoch, crashed, boundary_row):
                    retired = True
                    break
            if retired:
                break
            if elastic_on:
                el["rosters"].append(list(worker_ids))
            if not overlap:
                assemble(mx, epoch, t_disp, timing, ids)
            results["step_caps"].append(prep["caps"])
            results["shard_sizes"].append(prep["sizes"])
            if sim:
                # the simulated fabric's row (JAX driver.py:1945-1950)
                timing.update(engine.last_sync_stats)
            else:
                if elastic_on:
                    # the engine (and its wire) follows the roster
                    sync_bytes, wire_bytes, wire_split = wire_bytes_of()
                # JAX's sync keys on every row (train.py:945-970): a flat
                # engine's bytes are all intra-slice (ICI), the
                # hierarchical sync's split by level; the ms split is a
                # byte-proportional model (probe.attribute_sync_wall)
                stats = engine.last_sync_stats
                timing.update(
                    sync_bytes=sync_bytes, sync_wire_bytes=wire_bytes,
                    sync_buddy_bytes=engine.buddy_wire_bytes(),
                    sync_mode=stats["sync_mode"], sync_ms=stats["sync_ms"],
                    sync_hidden_ms=stats["sync_hidden_ms"],
                    gather_ms=stats.get("gather_ms", 0.0),
                    sync_bytes_ici=wire_split[0],
                    sync_bytes_dcn=wire_split[1],
                    sync_ms_ici=stats["sync_ms_ici"],
                    sync_ms_dcn=stats["sync_ms_dcn"])
                if elastic_on:
                    timing["worker_ids"] = list(worker_ids)
            results["round_timings"].append(timing)
            if round_checksums and group is not None:
                results.setdefault("round_checksums", []).append(
                    mesh.all_gather(group, engine.params_checksum(state)))
            if seq_checked is not None:
                # the seq ranks of a worker apply the same summed
                # gradients and sync the same shards: bitwise equal
                _check_same(grid.groups["seq"],
                            f"the parameters after round {epoch} (along "
                            "seq)", engine.params_checksum(state))
                seq_checked += 1
            if pipe_checked is not None:
                # the stages sum those leaves' gradients over pipe, take
                # the same Adam step and sync the same shards
                _check_same(grid.groups["pipe"],
                            f"the replicated parameters after round {epoch} "
                            "(along pipe)", comms.checksum(
                                engine.gp.pipe_replicated_params()))
                pipe_checked += 1
            if expert_checked is not None:
                # the MoE markers give those leaves their whole gradients
                # on every expert rank: the same Adam step, the same sync
                _check_same(grid.groups["expert"],
                            f"the replicated parameters after round {epoch} "
                            "(along expert)", comms.checksum(
                                engine.gp.expert_replicated_params()))
                expert_checked += 1
            if nan_armed and "sync_ok" in mx:
                timing["sync_ok"] = [float(x) for x in mx["sync_ok"]]
                process_quarantine(epoch, np.asarray(mx["sync_ok"]))
            if ckpt is not None:
                if group is not None:
                    # publish the previous save's manifest now, in the
                    # same order on every rank: the commit window is one
                    # round, never --checkpoint_every rounds of a durable
                    # but unrestorable epoch (JAX driver.py:1764-1776)
                    ckpt.wait()
                if (cfg.checkpoint_every
                        and (epoch + 1) % cfg.checkpoint_every == 0):
                    ckpt.save(engine.checkpoint_state(state), epoch + 1,
                              timing=timing)
            with walls_lock:
                walls[epoch] = (walls_src, prep["steps_run"])
            if last_round:
                # leaving the loop closes the progress bar: the last
                # round's report lands first
                while pending:
                    pending.pop(0).result()
                break
            prep = (nxt if overlap
                    else prepare_next(epoch, prep["steps_run"], timing))
    finally:
        # settle the pipeline (a worker thread's error is raised on the
        # way out of a run that went well), then the checkpoints: drain
        # the write in flight (N workers: the deferred commit runs here,
        # on every rank) and release the writer; while unwinding: join the
        # writer without the collective commit
        ok = sys.exc_info()[0] is None
        try:
            for fut in ([prep] if isinstance(prep, Future) else []) + pending:
                if ok:
                    fut.result()
                else:
                    wait([fut])
            pending.clear()
            for pool in (prep_pool, metrics_pool):
                if pool is not None:
                    pool.shutdown(wait=True)
        finally:
            if profiler is not None:
                _stop_profile(profiler, cfg.profile_dir, rank, ok)
            if ckpt is not None:
                if ok and not retired:
                    ckpt.close()
                else:
                    ckpt.abort()
    if pbar is not None:
        pbar.close()
    if retired:
        # this position left the roster: its process is done
        return {"retired": True, "elastic": el}
    state = engine.drain_pending(state)
    if not sim:
        # a resident run's module gets the consensus back (a collective)
        state = engine.materialize_params(state)
        # (JAX driver.py:1844-1851: zeros when no round ran)
        ran = bool(results["round_timings"])
        results["sync_engine"]["sync_bytes_ici"] = (
            wire_split[0] if ran else 0)
        results["sync_engine"]["sync_bytes_dcn"] = (
            wire_split[1] if ran else 0)
        results["sync_engine"]["param_residency"] = engine.param_residency
        results["sync_engine"]["per_worker_state_bytes"] = \
            engine.state_resident_bytes(state)
    # the memory row of every run, a zero-round run too (JAX
    # driver.py:1866-1890)
    results["memory"] = probe_lib.memory_report(
        engine.memory_programs(),
        state_bytes=engine.state_resident_bytes(state), n_workers=n, sim=sim)
    mem = results["memory"]
    log.info("program memory: %d program(s), %.2f MB temp total; per-worker "
             "resident state %.2f MB (+%.2f MB transient gather peak), %s "
             "total %.2f MB", len(mem["programs"]),
             mem["temp_bytes_total"] / 2**20,
             mem["per_worker_resident_bytes"] / 2**20,
             mem["per_worker_state_bytes"].get("params_gathered_peak", 0)
             / 2**20, "one-device stacked" if sim else "fleet",
             mem["state_bytes_total"] / 2**20)
    results["sanitize"] = san
    if san["enabled"]:
        log.info("sanitizer clean: 0 implicit host-device syncs in the "
                 "round loop (the retrace, recompile and donation checks "
                 "are XLA's: not applicable)")
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
    el["final_worker_ids"] = list(worker_ids)
    results["elastic"] = el
    if el["events"]:
        log.info("elastic: %d membership event(s), %d rejected, %d "
                 "straggler retries, reshard stalls %s ms, %d round(s) "
                 "degraded, final membership %s", len(el["events"]),
                 len(el["rejected"]), len(el["sync_retries"]),
                 el["reshard_ms"], el["rounds_degraded"],
                 el["final_worker_ids"])
    results["checkpoint"] = (ckpt.summary() if ckpt is not None
                             else {"enabled": False})
    results["state"] = state
    results["variables"] = (engine.rank0_variables(state) if sim
                            else engine.rank0_variables())
    if grid is not None:
        # the dense twin with the worker's whole parameters: the final
        # evaluation's model (JAX evaluates its dense twin)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = results["variables"][name]
        from .ops import flash as flash_lib
        results["grid"] = {
            "axes": dict(grid.axes), "coords": dict(grid.coords),
            "ranks": grid.world.world_size,
            "coords_of": [grid.coords_of(r)
                          for r in range(grid.world.world_size)],
            "state_bytes": mesh.all_gather(
                grid.world, engine.state_resident_bytes(state)),
            "tp": mesh.all_gather(grid.world, dict(tp_lib.STATS)),
            # the expert line's all-reduces of the MoE layers (f and g)
            "ep": mesh.all_gather(grid.world, dict(ep_lib.STATS)),
            # every rank's flash launches and the train and validation
            # steps it ran, a voided round's too (the launches of
            # main.run's final evaluation on rank 0 come after)
            "launches": mesh.all_gather(grid.world, dict(flash_lib.LAUNCHES)),
            "steps": mesh.all_gather(grid.world, steps_ran),
            # every rank's BatchNorm statistics (equal along fsdp)
            "buffer_checksums": mesh.all_gather(
                grid.world, comms.checksum(list(train_model.buffers()))
                if list(train_model.buffers()) else None),
            "fsdp": mesh.all_gather(grid.world, dict(fsdp_lib.STATS)),
            "sp": mesh.all_gather(grid.world, dict(sp_lib.STATS)),
            # rounds after which the parameters were checked bitwise
            # equal along seq (None: not checked)
            "seq_bitwise_rounds": seq_checked,
            # the pipeline: the schedule, the microbatches of a step, the
            # stage hops per pass, the replicated leaves' all-reduce and
            # the most microbatches in flight, by rank
            "pp": mesh.all_gather(grid.world, dict(
                pp_lib.STATS, schedule=cfg.pp_schedule,
                microbatches=engine.pp_microbatches)),
            # rounds after which the replicated leaves were checked
            # bitwise equal along pipe (None: no pipe axis)
            "pipe_bitwise_rounds": pipe_checked,
            # ... and along expert (None: no expert axis)
            "expert_bitwise_rounds": expert_checked}
        grid.close()
    if slices is not None:
        slices.close()
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


def train_rank(rank: int, world_size: int, store_path: str | mesh.Launch,
               timeout_s: float, cfg: Config,
               train_kwargs: dict | None = None, spawn=None,
               generation: int = 0, snapshot_dir: str | None = None
               ) -> dict[str, Any]:
    """Run ``train_global(cfg, **train_kwargs)`` as rank ``rank`` of a
    ``world_size``-worker group that meets at the FileStore
    ``store_path`` (generation ``generation`` of an elastic group; a spawn
    target), or under a launch at the coordinator's store (a
    ``mesh.Launch``; the device follows the rank's local rank).
    ``snapshot_dir``: the membership snapshot this position starts from
    (a joiner's, or a fresh twin's).  ``spawn``: rank 0's callback that
    starts the joiners of an elastic boundary (``run_group``'s)."""
    device = mesh.worker_device(mesh.local_rank(store_path, rank),
                                cfg.device)
    member = mesh.Membership(rank, world_size, device, store_path,
                             timeout_s, spawn=spawn, generation=generation)
    member.join()
    try:
        kw = dict(train_kwargs or {})
        if snapshot_dir is not None:
            kw["elastic_snapshot"] = snapshot_dir
        return train_global(cfg, membership=member, **kw)
    finally:
        member.leave(ok=sys.exc_info()[0] is None)


def rank_entry(rank: int, world_size: int, cfg: Config, store_path: str,
               timeout_s: float, train_kwargs: dict | None,
               generation: int, snapshot_dir: str | None) -> None:
    """A spawned rank of ``run_group`` (its results stay in the child)."""
    train_rank(rank, world_size, store_path, timeout_s, cfg, train_kwargs,
               generation=generation, snapshot_dir=snapshot_dir)


def run_group(cfg: Config, n: int, *, train_kwargs: dict | None = None,
              elastic_snapshot=None, timeout_s: float | None = None,
              target: Callable = rank_entry) -> dict[str, Any]:
    """Run ``train_global`` as an ``n``-process gloo group: ranks 1..n-1
    spawned (``target``, a module-level function of the port taking
    ``rank_entry``'s arguments), rank 0 in the caller with its share of
    the threads; an elastic boundary spawns its joiners the same way.
    ``elastic_snapshot``: a ``MembershipSnapshot`` (saved for the
    children) or its directory: a fresh run from it on its roster.
    Returns rank 0's results; raises, naming the exit codes, when a child
    failed (a dead peer ends the others' collectives at the timeout)."""
    timeout_s = mesh.GROUP_TIMEOUT_S if timeout_s is None else timeout_s
    store = mesh.new_store_path()
    snapshot_dir = None
    if isinstance(elastic_snapshot, str):
        snapshot_dir = elastic_snapshot
    elif elastic_snapshot is not None:
        snapshot_dir = os.path.join(os.path.dirname(store), "start")
        elastic_lib.save_snapshot(elastic_snapshot, snapshot_dir)
    if snapshot_dir is not None:
        # the snapshot's roster: its workers, each a block of ranks on a
        # grid
        snap = elastic_lib.load_snapshot(snapshot_dir)[0]
        n = snap.n_workers * max(snap.blocks, 1)
    threads = torch.get_num_threads()
    procs: list = []

    def spawn(ranks, world: int, generation: int, snap_dir) -> None:
        procs.extend(mesh.spawn_workers(
            target, world, (cfg, store, timeout_s, train_kwargs, generation,
                            snap_dir),
            ranks=ranks, threads=max(1, threads // world)))

    spawn(range(1, n), n, 0, snapshot_dir)
    try:
        return _lead_rank(procs, mesh.rank_threads(n), timeout_s,
                          lambda: train_rank(0, n, store, timeout_s, cfg,
                                             train_kwargs, spawn=spawn,
                                             snapshot_dir=snapshot_dir))
    finally:
        mesh.remove_store(store)


def _lead_rank(procs: list, threads: int, timeout_s: float,
               run: Callable) -> Any:
    """``run()``, the caller's rank, on ``threads`` intra-op threads beside
    its spawned ranks ``procs`` (a list an elastic run may extend): joined
    when it returns; stopped when it raises, naming a child that failed
    first (the likelier cause)."""
    caller = torch.get_num_threads()
    try:
        torch.set_num_threads(threads)
        out = run()
    except BaseException as err:
        failed = mesh.stop_workers(procs, wait_s=5.0)
        if failed:
            raise RuntimeError(
                f"worker process(es) failed, exit codes {failed}") from err
        raise
    finally:
        torch.set_num_threads(caller)
    mesh.join_workers(procs, timeout_s)
    return out


def check_launch(cfg: Config, launch: mesh.Launch,
                 elastic_snapshot=None) -> int:
    """The refusals of a launched run, with the JAX driver's messages
    (``driver.py:315-319, 393-406``), raised before any rendezvous;
    returns the world's rank count."""
    if cfg.sim_workers:
        raise NotImplementedError(
            "--sim_workers is single-process by construction: the "
            "simulated worker axis lives on one chip (that is the "
            "point) — run multi-process fleets on the real driver")
    axes = mesh.grid_axes(cfg, launch.num_processes)
    ranks = mesh.world_size_of(axes)
    n = ranks // mesh.inner_size(axes)
    if n % launch.num_processes:
        raise ValueError(
            f"worker axis ({n}) must be divisible by the process count "
            f"({launch.num_processes}): per-process probe/wall attribution "
            "maps whole worker-row blocks to whole processes")
    if cfg.chaos or elastic_snapshot is not None:
        raise NotImplementedError(
            "elastic membership / --chaos drives the simulated N-worker "
            "single-process driver; multi-process membership changes need "
            "a coordinated mesh rebuild across hosts (ROADMAP follow-on)")
    return ranks


def run_launched(cfg: Config, *, launch: mesh.Launch | None = None,
                 train_kwargs: dict | None = None,
                 timeout_s: float | None = None,
                 target: Callable = rank_entry) -> dict[str, Any]:
    """Run ``train_global`` as this process's ranks of a launched world
    (JAX ``mesh.initialize_distributed``): ``launch`` (default: the
    environment's three variables, ``mesh.launch_from_env``) names the
    coordinator, the process count P and this process's id p; the world
    of R ranks (the mesh's) is laid out process-major, so this process
    holds global ranks p*L .. p*L+L-1 (L = R/P): its first in the caller,
    the other L-1 spawned (``target``, ``rank_entry``'s arguments), each
    with 1/L of the caller's threads and the device of its local rank.
    The run is the single launch's, on one world, in the serial round
    flow (JAX ``driver.py:1035``); every process returns its first rank's
    results (the global metric lists are every rank's) with
    ``results["launch"]``."""
    launch = launch if launch is not None else mesh.launch_from_env()
    if launch is None:
        raise ValueError(
            f"run_launched needs a launch: set {mesh.COORDINATOR_ENV}, "
            f"{mesh.NUM_PROCESSES_ENV} and {mesh.PROCESS_ID_ENV}")
    launch = launch.with_world(check_launch(cfg, launch))
    timeout_s = mesh.GROUP_TIMEOUT_S if timeout_s is None else timeout_s
    first, *rest = launch.ranks
    share = mesh.rank_threads(launch.ranks_per_process)
    procs = mesh.spawn_workers(
        target, launch.world_size,
        (cfg, launch, timeout_s, train_kwargs, 0, None), ranks=rest,
        threads=share)
    results = _lead_rank(procs, share, timeout_s,
                         lambda: train_rank(first, launch.world_size, launch,
                                            timeout_s, cfg, train_kwargs))
    results["launch"] = {
        "coordinator": launch.address, "processes": launch.num_processes,
        "process_id": launch.process_id, "ranks": list(launch.ranks),
        "world_size": launch.world_size}
    return results


def fresh_rank() -> None:
    """Between two runs in one process: what the last run left on the
    card freed, the process-peak window and the kernel launch counters
    started anew, so each run's memory and launch numbers are its own (a
    process whose jobs so far ran on the host has no CUDA context)."""
    import gc
    from .ops import flash as flash_lib
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        probe_lib.reset_peak_memory_stats(
            torch.device("cuda", torch.cuda.current_device()))
    flash_lib.reset_launch_counts()


def ranks_in_turn(rank: int, world_size: int, jobs: list) -> None:
    """A spawned rank of ``SharedStart``: each ``(target, args, ranks)`` of
    ``jobs`` in turn (``target(rank, ranks, *args)``; a job of fewer ranks
    than this one's is skipped), each from a fresh process state
    (``fresh_rank``)."""
    for i, (target, args, ranks) in enumerate(jobs):
        if rank >= ranks:
            continue
        if i:
            fresh_rank()
        target(rank, ranks, *args)


class SharedStart:
    """Several jobs of ``n`` ranks from ONE start of the ranks: ranks
    1..n-1 are spawned once and run every job in turn (``ranks_in_turn``),
    each job on a gloo group of its own (a FileStore each); rank 0 runs in
    the caller, one ``run()`` per job, in order, and the caller may do its
    own work between them.  A job is a ``train_global`` run, given as a
    ``Config`` or ``(Config, train_kwargs)`` (its spawned ranks run
    ``target``, ``rank_entry``'s arguments, and ``run()`` returns rank 0's
    results), or a spawn target of the port with its arguments after the
    store path, ``(fn, args)`` (every rank calls ``fn(rank, n, store,
    *args)``; ``run()`` returns None).  A third element, ``(job, rest,
    ranks)``, runs the job on the first ``ranks`` ranks only (at most
    ``n``).  A context manager: leaving it joins the ranks, or terminates
    them when it is left by an error.  Elastic runs (chaos) regroup: rank
    0 spawns a join's ranks as ``run_group`` does (each runs that one job)
    and the retired ranks go on to the next job; a fresh run from a
    membership snapshot gives its directory as the job's
    ``elastic_snapshot`` (written before its ``run()``) and its roster's
    rank count as the job's ``ranks``."""

    def __init__(self, n: int, jobs: list, *, target: Callable = rank_entry):
        self.n = int(n)
        self.timeout_s = mesh.GROUP_TIMEOUT_S
        self.target = target
        self.jobs = []
        for job in jobs:
            if isinstance(job, Config):
                job = (job, None)
            if isinstance(job[0], Config) and job[0].sim_workers:
                raise ValueError(
                    "a shared start runs worker processes: --sim_workers "
                    "runs in one; run it through train_global")
            first, rest, ranks = (*job, self.n)[:3]
            if not 1 <= int(ranks) <= self.n:
                raise ValueError(f"a job of {ranks} ranks on a shared start "
                                 f"of {self.n}")
            self.jobs.append((first, rest, int(ranks)))
        self.stores: list[str] = []
        self.procs: list = []
        self.done = 0

    def _spawn_args(self, job, store: str) -> tuple:
        first, rest, ranks = job
        if isinstance(first, Config):
            return (self.target, (first, store, self.timeout_s, rest, 0,
                                  None), ranks)
        return first, (store, *rest), ranks

    def __enter__(self) -> "SharedStart":
        self.stores = [mesh.new_store_path() for _ in self.jobs]
        self.threads = torch.get_num_threads()
        self.procs = mesh.spawn_workers(
            ranks_in_turn, self.n,
            ([self._spawn_args(j, st) for j, st in zip(self.jobs,
                                                        self.stores)],),
            threads=max(1, self.threads // self.n))
        return self

    def run(self):
        """Rank 0 of the next job: a run's results (None for a spawn
        target's job)."""
        i = self.done
        if i >= len(self.jobs):
            raise RuntimeError(f"all {len(self.jobs)} jobs have run")
        self.done += 1
        first, rest, ranks = self.jobs[i]
        target, args, _ = self._spawn_args(self.jobs[i], self.stores[i])
        if i:
            fresh_rank()
        torch.set_num_threads(mesh.rank_threads(self.n))
        try:
            if isinstance(first, Config):
                return train_rank(0, ranks, self.stores[i], self.timeout_s,
                                  first, rest,
                                  spawn=self._joiners(first, self.stores[i],
                                                      rest))
            target(0, ranks, *args)
            return None
        except BaseException as err:
            # a child that failed first is the likelier cause: name it
            failed = mesh.stop_workers(self.procs, wait_s=5.0)
            if failed:
                raise RuntimeError(
                    f"worker process(es) failed, exit codes {failed}"
                ) from err
            raise
        finally:
            torch.set_num_threads(self.threads)

    def _joiners(self, cfg: Config, store: str, train_kwargs):
        """Rank 0's spawner of a job's joiners (a join's ranks)."""

        def spawn(ranks, world: int, generation: int, snap_dir) -> None:
            self.procs.extend(mesh.spawn_workers(
                self.target, world, (cfg, store, self.timeout_s,
                                     train_kwargs, generation, snap_dir),
                ranks=ranks, threads=max(1, self.threads // world)))
        return spawn

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                if self.done != len(self.jobs):
                    raise RuntimeError(
                        f"{self.done} of the shared start's "
                        f"{len(self.jobs)} jobs ran")
                mesh.join_workers(self.procs, self.timeout_s)
            else:
                mesh.stop_workers(self.procs, wait_s=5.0)
        finally:
            for store in self.stores:
                mesh.remove_store(store)


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
    (``sync_residual``, ``round_opt``, ``sync_residual_outer``) and how
    many stale deltas were delivered in the rounds and in all.  Under
    ``--num_slices`` the world is the slice grid's, and a gradients run
    (its sync leaves the parameters as trained) also saves ``hier_twin``:
    the dense twin ``comms.aggregate_hier`` of its parameters, which a
    weights run of the same round must equal."""
    state_dict = torch.load(state_path)
    with np.load(packs_path) as f:
        train_pack = (f["x"], f["y"], f["m"])
        val_pack = (f["xv"], f["yv"], f["mv"])
    device = mesh.worker_device(rank, cfgs[0].device)
    with mesh.init_group(rank, world_size, device, store_path,
                         timeout_s) as group:
        grids = {}
        for cfg in cfgs:
            if cfg.num_slices > 1 and cfg.num_slices not in grids:
                grids[cfg.num_slices] = mesh.make_grid(
                    group, {"slice": cfg.num_slices,
                            "data": world_size // cfg.num_slices})
        for i, cfg in enumerate(cfgs):
            model = build_model_for(cfg, num_classes, device,
                                    train_pack[0].shape[3:])
            model.load_state_dict(state_dict)
            slices = grids.get(cfg.num_slices)
            engine = LocalSGDEngine(model, cfg, device, group, slices=slices)
            state, mxs = engine.init_state(), []
            for _ in range(rounds[i] if rounds else 1):
                state, mx = engine.round(state, train_pack, val_pack)
                mxs.append(mx)
            in_rounds = len(engine.stale_log)
            state = engine.drain_pending(state)
            # the resident layout's consensus back in the module
            state = engine.materialize_params(state)
            twin = None
            if slices is not None and cfg.aggregation_by == "gradients":
                twin = comms.aggregate_hier(
                    engine.params, inner_group=slices.groups["data"],
                    outer_group=slices.groups["slice"],
                    topology=cfg.topology, how=cfg.aggregation_type,
                    local_weight=cfg.local_weight)
                twin = dict(zip(engine.names, twin))
            torch.save({"mx": mxs[-1], "mxs": mxs,
                        "state_dict": model.state_dict(),
                        "opt_count": state.opt.count,
                        "sync_residual": state.sync_residual,
                        "sync_residual_outer": state.sync_residual_outer,
                        "round_opt": state.round_opt,
                        "hier_twin": twin,
                        "stale_in_rounds": in_rounds,
                        "stale_log_len": len(engine.stale_log),
                        "last_sync_stats": engine.last_sync_stats},
                       os.path.join(out_dir, f"rank{rank}-{i}.pt"))
        for grid in grids.values():
            grid.close()


def _report(cfg: Config, mx: dict, epoch: int, wall: float,
            results: dict, pbar=None, worker_ids=None) -> None:
    """The reference's per-rank per-local-epoch report lines
    (trainer.py:109-110) for every worker (by logical id), through
    ``pbar.write`` under the "Global Epochs" bar (its loss/accuracy/wall
    postfix then stands for the summary line), else ``print`` and a
    global-epoch summary."""
    say = pbar.write if pbar is not None else print
    n, epochs_local = np.asarray(mx["train_loss"]).shape
    wids = list(range(n)) if worker_ids is None else worker_ids
    for r, wid in enumerate(wids):
        for e in range(epochs_local):
            say(f"Rank {wid}, Global Epoch {epoch + 1}, Local Epoch {e + 1}, "
                f"Loss: {mx['train_loss'][r, e]}, "
                f"Accuracy: {mx['train_acc'][r, e]}")
            say(f"Worker {wid}, Global Epoch {epoch + 1}, "
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
