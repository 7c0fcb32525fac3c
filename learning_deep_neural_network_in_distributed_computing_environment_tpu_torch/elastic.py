"""Elastic worker membership (port of the JAX package's ``elastic.py``).

In the JAX package the N workers are rows of one device mesh in one
process; a membership change rebuilds the mesh in place.  Here every
worker is a process of a gloo group, and a position in the roster is a
rank: after a boundary, position p of the new roster runs on rank p of a
newly formed group.  The driver (``driver.train_global``), at a boundary
with a change and in the same order on every rank:

1. settles what is in flight and folds the walls into the EMA;
2. fences and writes each rank's host row (``LocalSGDEngine.host_row``)
   into the boundary's directory;
3. on rank 0, stacks the rows into a worker-stacked ``HostState`` and
   builds the ``MembershipSnapshot`` (``build_snapshot``: the survivor
   EMA edit, the re-partition, ``reshard_state``'s row edit) and writes
   it, one file per new position (``save_snapshot``);
4. destroys the old group; rank 0 spawns the joiners, surplus ranks
   retire;
5. every rank installs itself from the snapshot (``load_snapshot``) —
   the one function a fresh ``train_global(cfg, elastic_snapshot=snap)``
   also calls at setup.

That shared install path is what makes the bitwise twin gate mechanical,
as in JAX: the continued run and a fresh run started from the same
snapshot stage the same bytes and run the same rounds.

On a rank grid (``--mesh_shape`` with inner axes) the roster is of worker
blocks, and each rank's row holds its shards: the rows are keyed by
(position, inner coordinate), stacked per coordinate over the workers,
and the one ``MembershipChange`` is applied to every coordinate's stack
(a grid host state is ``{coordinate: HostState}``), so a joiner's rows at
coordinate c clone the first survivor's at c and its seed words are the
worker's on every coordinate.

The host state is worker-stacked numpy, as JAX's: per-worker rows
(parameters, BatchNorm buffers, Adam moments and count, the StepLR clock,
the seed words, the EF residual) are row-edited; the shared layouts (the
round optimizer's moments, the scatter-resident parameters) are re-laid
out for the new worker count; the buddy rows are dropped and re-derived.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import pickle
from typing import Any

import numpy as np

from . import comms

log = logging.getLogger(__name__)

# Test hook (JAX ``JAX_GRAFT_ELASTIC_TEST_CRASH``): raise at a defined
# point INSIDE the membership transition — after the old roster's rows
# are resharded, before the new group exists — so the recovery (resume
# from the last committed checkpoint, replaying --chaos from its epoch)
# runs end to end.  Value: "mid_reshard".
_CRASH_ENV = "PORT_ELASTIC_TEST_CRASH"


def _maybe_crash(point: str) -> None:
    if os.environ.get(_CRASH_ENV) == point:
        raise RuntimeError(
            f"elastic test crash hook fired at {point!r} ({_CRASH_ENV})")

# the per-worker rows of a HostState (row-edited at a boundary); the other
# fields are shared layouts (re-laid out) or derived (re-derived)
ROW_FIELDS = ("params", "buffers", "mu", "nu", "count", "lr_epoch", "rng",
              "sync_residual")


@dataclasses.dataclass
class HostState:
    """Worker-stacked host copy of the workers' train states: every array
    carries a leading worker axis [N, ...].  ``params``, ``buffers``,
    ``mu``, ``nu`` and ``sync_residual`` map ``state_dict`` names to
    arrays (``params`` is None under the resident layout);
    ``round_opt`` is ``{bucket: {"mu", "nu"}}``, ``params_resident``
    ``{bucket: [N, row]}``, ``buddy`` ``{bucket: {comp: [N, row]}}``."""

    params: dict | None
    buffers: dict
    mu: dict
    nu: dict
    count: np.ndarray
    lr_epoch: np.ndarray
    rng: np.ndarray
    sync_residual: dict | None = None
    round_opt: dict | None = None
    params_resident: dict | None = None
    buddy: dict | None = None

    def replace(self, **kw) -> "HostState":
        return dataclasses.replace(self, **kw)

    @property
    def n_workers(self) -> int:
        return int(np.shape(self.rng)[0])


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def map_rows(fn, host: HostState, fields=ROW_FIELDS) -> HostState:
    """``host`` with ``fn`` applied to every array of ``fields``."""
    return host.replace(**{f: _map(fn, getattr(host, f)) for f in fields})


def stack_rows(rows: list[dict]) -> HostState:
    """Per-worker host rows (``LocalSGDEngine.host_row``'s dicts, in
    position order) -> one worker-stacked ``HostState``."""
    def stack(*leaves):
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves))
                    for k in leaves[0]}
        return np.stack([np.asarray(x) for x in leaves])
    return HostState(**{f.name: stack(*(r[f.name] for r in rows))
                        for f in dataclasses.fields(HostState)})


def host_row(host, position: int, coord: int | None = None) -> dict:
    """Row ``position`` of a worker-stacked ``HostState`` (of coordinate
    ``coord`` of a grid host state) as a host row dict (copies)."""
    if isinstance(host, dict):
        host = host[int(coord)]
    return {f.name: _map(lambda a: a[position].copy(),
                         getattr(host, f.name))
            for f in dataclasses.fields(HostState)}


def per_coordinate(fn, host):
    """``fn`` applied to a ``HostState``, or to each coordinate's of a grid
    host state (``{coordinate: HostState}``, in coordinate order)."""
    if isinstance(host, dict):
        return {c: fn(h) for c, h in sorted(host.items())}
    return fn(host)


@dataclasses.dataclass
class MembershipSnapshot:
    """Everything a run needs to continue from a membership boundary (JAX
    ``MembershipSnapshot``): ``host_state`` is the worker-stacked
    ``HostState`` of the NEW roster; ``epoch`` the next round to run;
    ``rng_state`` the partition stream's numpy bit-generator state;
    ``next_worker_id`` the id allocator's position (never recycled);
    ``n_round0`` the run's round-0 worker count; ``params_template`` the
    ``comms.ParamsTemplate`` the resident layout needs; ``blocks`` the
    ranks of a worker's block on a rank grid (0: one rank a worker), whose
    ``host_state`` is then ``{inner coordinate: HostState}``."""

    epoch: int
    worker_ids: list[int]
    host_state: Any
    sec_per_batch: np.ndarray
    train_parts: list[np.ndarray]
    val_parts: list[np.ndarray]
    fixed_classes: list | None
    rng_state: dict
    next_worker_id: int = 0
    n_round0: int = 0
    params_template: Any = None
    blocks: int = 0

    @property
    def n_workers(self) -> int:
        return len(self.worker_ids)


@dataclasses.dataclass
class MembershipChange:
    """Resolved outcome of one boundary's membership events."""

    kept_positions: list[int]     # old roster positions that survive
    worker_ids: list[int]         # new logical-id order (survivors+joins)
    joiner_ids: list[int]
    applied: list[dict]           # event descriptions, as applied
    rejected: list[dict]          # events refused (quorum/capacity/...)

    @property
    def changed(self) -> bool:
        return bool(self.joiner_ids) or bool(self.applied)


class MembershipPlan:
    """The logical worker roster and its events against the quorum floor
    and the capacity ceiling (JAX ``MembershipPlan``).  Logical ids are
    stable for the life of the run: the initial workers are 0..N-1, and
    every joiner takes the next free id (never recycled, so a joiner's
    seed stream never collides with any worker's, past or present)."""

    def __init__(self, n_workers: int, *, min_workers: int = 1,
                 max_workers: int | None = None,
                 worker_ids: list[int] | None = None,
                 next_id: int | None = None):
        self.worker_ids = (list(worker_ids) if worker_ids is not None
                           else list(range(n_workers)))
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max_workers
        floor = max(self.worker_ids) + 1 if self.worker_ids else 0
        self._next_id = floor if next_id is None else max(floor,
                                                          int(next_id))

    @property
    def n_workers(self) -> int:
        return len(self.worker_ids)

    @property
    def next_id(self) -> int:
        """The allocator position to persist into snapshots."""
        return self._next_id

    def apply(self, events, resolve=None) -> MembershipChange:
        """Resolve kill/join/depart/crash events into a
        ``MembershipChange``; departures resolve before joins (a kill
        frees the position a join may take).  An event that would sink
        the roster below ``min_workers`` or grow it past ``max_workers`` is
        REJECTED and recorded, never partially applied."""
        ids = list(self.worker_ids)
        joiners: list[int] = []
        applied: list[dict] = []
        rejected: list[dict] = []
        next_id = self._next_id
        order = {"kill": 0, "depart": 0, "crash": 0}
        events = sorted(events, key=lambda e: order.get(
            e.kind if hasattr(e, "kind") else e["kind"], 1))
        for e in events:
            kind = e.kind if hasattr(e, "kind") else e["kind"]
            desc = e.describe() if hasattr(e, "describe") else dict(e)
            if kind in ("kill", "depart", "crash"):
                target = (resolve(e, ids) if resolve is not None
                          and getattr(e, "worker", None) is None
                          else getattr(e, "worker", None))
                if target is None or target not in ids:
                    rejected.append({**desc, "reason":
                                     f"worker {target} not in membership"})
                    continue
                if len(ids) + len(joiners) - 1 < self.min_workers:
                    rejected.append({**desc, "reason":
                                     f"quorum floor {self.min_workers}"})
                    continue
                ids.remove(target)
                applied.append({**desc, "worker": int(target)})
            elif kind == "join":
                if (self.max_workers is not None
                        and len(ids) + len(joiners) + 1 > self.max_workers):
                    rejected.append({**desc, "reason":
                                     f"device capacity {self.max_workers}"})
                    continue
                joiners.append(next_id)
                applied.append({**desc, "worker": int(next_id)})
                next_id += 1
            else:
                rejected.append({**desc, "reason":
                                 f"not a membership event kind {kind!r}"})
        kept_positions = [self.worker_ids.index(w) for w in ids]
        change = MembershipChange(
            kept_positions=kept_positions, worker_ids=ids + joiners,
            joiner_ids=joiners, applied=applied, rejected=rejected)
        if change.applied:
            self.worker_ids = change.worker_ids
            self._next_id = next_id
        return change


# ----------------------------------------------------------------------
# State reshard: the host row edit
# ----------------------------------------------------------------------

def joiner_rng(seed: int, worker_id: int) -> np.ndarray:
    """A joiner's seed words: its augmentation stream keyed by its LOGICAL
    id (the twin of JAX's ``fold_in(key(seed), logical_id)``; a run
    without membership changes has logical id = rank)."""
    from .train import seed_words, worker_seed
    return seed_words(worker_seed(seed, int(worker_id)))


def reshard_state(host_state: HostState, kept_positions: list[int],
                  joiner_ids: list[int], *, seed: int,
                  round_opt_placement: str | None = None,
                  sync_bucket_bytes: int | None = None,
                  params_template=None) -> HostState:
    """Row-edit a worker-stacked ``HostState`` for a membership change
    (JAX ``reshard_state``).  Survivor rows are taken bit-exact in their
    old relative order.  Each joiner clones the FIRST survivor's row with
    two exceptions: its seed words are a fresh stream keyed by its
    logical id (``joiner_rng``), and its EF residual is zero.  The round
    optimizer's rows and the scatter-resident parameters are shared
    state, re-laid out for the new count (``comms.round_opt_relayout``,
    ``comms.resident_relayout``; a quorum of one demotes resident to
    replicated: the consensus is materialized and tiled); buddy rows are
    dropped and re-derived against the new tiling."""
    if not kept_positions:
        raise ValueError("membership change left no surviving workers")
    had_buddy = host_state.buddy is not None
    if had_buddy:
        host_state = host_state.replace(buddy=None)
    n_new = len(kept_positions) + len(joiner_ids)
    resident = host_state.params_resident
    if resident is not None:
        if params_template is None or sync_bucket_bytes is None:
            raise ValueError(
                "host_state carries scatter-resident params: "
                "reshard_state needs params_template and "
                "sync_bucket_bytes to re-tile them")
        if n_new < 2:
            log.info("elastic: a quorum of one holds nothing to shard: the "
                     "resident parameters become replicated")
            n_old = host_state.n_workers
            full = comms.resident_to_tree(
                resident, template=params_template,
                bucket_bytes=int(sync_bucket_bytes))
            host_state = host_state.replace(
                params={name: np.broadcast_to(
                    a[None], (n_old, *a.shape)).copy()
                    for name, a in zip(params_template.names, full)},
                params_resident=None)
            resident = None
        else:
            resident = comms.resident_relayout(
                resident, params_template.leaves, n_new,
                bucket_bytes=int(sync_bucket_bytes))
            host_state = host_state.replace(params_resident=None)
    round_opt = host_state.round_opt
    if round_opt is not None:
        if (round_opt_placement is None or sync_bucket_bytes is None
                or params_template is None):
            raise ValueError(
                "host_state carries a round-optimizer tracker: "
                "reshard_state needs round_opt_placement, params_template "
                "and sync_bucket_bytes to re-lay it out")
        round_opt = comms.round_opt_relayout(
            round_opt, params_template.leaves, n_new,
            placement=round_opt_placement,
            bucket_bytes=int(sync_bucket_bytes))
        host_state = host_state.replace(round_opt=None)
    out = map_rows(lambda x: np.take(x, kept_positions, axis=0),
                   host_state)
    k = len(joiner_ids)
    if k:
        out = map_rows(lambda x: np.concatenate(
            [x, np.repeat(x[:1], k, axis=0)], axis=0), out)
        nk = len(kept_positions)
        rng = out.rng.copy()
        rng[nk:] = np.stack([joiner_rng(seed, wid) for wid in joiner_ids])

        def zero_joiners(x):
            y = x.copy()
            y[nk:] = 0
            return y
        out = out.replace(rng=rng,
                          sync_residual=_map(zero_joiners, out.sync_residual))
    out = out.replace(round_opt=round_opt, params_resident=resident)
    return _rebuild_buddy(out, had_buddy, params_template,
                          sync_bucket_bytes, round_opt_placement)


def _residual_rows(host: HostState, template) -> list | None:
    if host.sync_residual is None:
        return None
    return [host.sync_residual[name] for name in template.names]


def _rebuild_buddy(out: HostState, had_buddy: bool, params_template,
                   sync_bucket_bytes, round_opt_placement) -> HostState:
    """Re-derive the buddy rows against the post-change tiling (a no-op
    when the source carried none, or nothing stays shard-resident)."""
    if not had_buddy:
        return out
    n_new = out.n_workers
    sharded_opt = (out.round_opt is not None
                   and round_opt_placement == "sharded")
    if n_new < 2 or not (out.params_resident is not None or sharded_opt):
        return out
    return out.replace(buddy=comms.derive_buddy(
        params_template, n_new, bucket_bytes=int(sync_bucket_bytes),
        params_resident=out.params_resident,
        round_opt=out.round_opt if sharded_opt else None,
        residual=(_residual_rows(out, params_template)
                  if out.params_resident is not None else None),
        opt_placement=round_opt_placement or "sharded"))


def restore_crashed_rows(host_state: HostState, lost_positions: list[int], *,
                         params_template=None,
                         sync_bucket_bytes: int | None = None,
                         round_opt_placement: str | None = None
                         ) -> HostState:
    """Patch a boundary ``HostState`` for CRASHED positions (JAX
    ``restore_crashed_rows``): their uniquely held rows (scatter-resident
    params, sharded round-optimizer moments) come back from the ring
    successor's buddy copy, and the residual's pending span folds into
    the holder's residual; replicated tracker rows are repaired from a
    survivor.  Their per-worker rows need nothing: ``reshard_state``
    drops them as a kill would.  Raises on a double fault or when the
    state carries no buddy rows (the caller falls back to the newest
    committed checkpoint)."""
    lost = sorted(set(int(p) for p in lost_positions))
    resident = host_state.params_resident
    round_opt = host_state.round_opt
    sharded_opt = round_opt is not None and round_opt_placement == "sharded"
    if resident is None and round_opt is None:
        return host_state
    if round_opt is not None and not sharded_opt:
        n = host_state.n_workers
        survivor = next(p for p in range(n) if p not in lost)

        def fix(a):
            out = np.asarray(a).copy()
            for r in lost:
                out[r] = a[survivor]
            return out
        host_state = host_state.replace(round_opt=_map(fix, round_opt))
    if resident is None and not sharded_opt:
        return host_state
    if host_state.buddy is None:
        raise ValueError(
            "state carries shard-resident rows but no buddy copy "
            "(--shard_redundancy off?) — the crashed spans exist "
            "nowhere else in memory")
    if params_template is None or sync_bucket_bytes is None:
        raise ValueError(
            "restore_crashed_rows needs params_template and "
            "sync_bucket_bytes to address the bucket spans")
    parts: dict = {}
    if resident is not None:
        parts["params_resident"] = resident
        if host_state.sync_residual is not None:
            parts["residual"] = _residual_rows(host_state, params_template)
    if sharded_opt:
        parts["round_opt"] = host_state.round_opt
    patched = comms.buddy_restore_rows(
        parts, host_state.buddy, lost, params_template,
        bucket_bytes=int(sync_bucket_bytes))
    residual = host_state.sync_residual
    if "residual" in patched:
        residual = dict(zip(params_template.names, patched["residual"]))
    return host_state.replace(
        params_resident=patched.get("params_resident",
                                    host_state.params_resident),
        round_opt=patched.get("round_opt", host_state.round_opt),
        sync_residual=residual)


def build_snapshot(*, epoch: int, change: MembershipChange,
                   old_state: HostState, sec_per_batch: np.ndarray,
                   seed: int, num_classes: int, trainset_len: int,
                   valset_len: int, proportionality: str, data_mode: str,
                   fixed_ratio: float, rng: np.random.Generator,
                   trainset_labels=None, valset_labels=None,
                   joiner_spb_mode: str = "mean", next_worker_id: int = 0,
                   n_round0: int = 0,
                   round_opt_placement: str | None = None,
                   sync_bucket_bytes: int | None = None,
                   params_template=None) -> MembershipSnapshot:
    """The full post-event configuration for round ``epoch`` (JAX
    ``build_snapshot``): the survivor EMA edit (joiners seeded by
    ``probe.joiner_sec_per_batch``), the adaptive re-partition drawn from
    that EMA, and the row-edited host state (every coordinate's of a grid
    host state, by the one change).  ``rng`` is consumed by the skew
    draws and its state captured LAST, so a fresh run from this snapshot
    continues the identical stream."""
    from . import probe as probe_lib
    from .data import (adaptive_partition, efficiency_ratios,
                       fixed_classes_for_rank)

    spb = np.asarray(sec_per_batch, np.float64)[change.kept_positions]
    if change.joiner_ids:
        fill = probe_lib.joiner_sec_per_batch(spb, mode=joiner_spb_mode)
        spb = np.concatenate([spb, np.full(len(change.joiner_ids), fill)])
    ratios = efficiency_ratios(spb, proportionality)
    fixed_classes = None
    if data_mode == "disbalanced":
        fixed_classes = [fixed_classes_for_rank(wid, num_classes)
                         for wid in change.worker_ids]
    train_parts = adaptive_partition(
        trainset_len, ratios, labels=trainset_labels,
        fixed_classes=fixed_classes, fixed_ratio=fixed_ratio, rng=rng)
    val_parts = adaptive_partition(
        valset_len, ratios, labels=valset_labels,
        fixed_classes=fixed_classes, fixed_ratio=fixed_ratio, rng=rng)
    host_state = per_coordinate(lambda h: reshard_state(
        h, change.kept_positions, change.joiner_ids, seed=seed,
        round_opt_placement=round_opt_placement,
        sync_bucket_bytes=sync_bucket_bytes,
        params_template=params_template), old_state)
    _maybe_crash("mid_reshard")
    return MembershipSnapshot(
        epoch=int(epoch), worker_ids=list(change.worker_ids),
        host_state=host_state, sec_per_batch=spb,
        train_parts=train_parts, val_parts=val_parts,
        fixed_classes=fixed_classes,
        rng_state=copy.deepcopy(rng.bit_generator.state),
        next_worker_id=int(next_worker_id), n_round0=int(n_round0),
        params_template=params_template,
        blocks=len(old_state) if isinstance(old_state, dict) else 0)


def snapshot_copy(snap: MembershipSnapshot) -> MembershipSnapshot:
    """Deep copy for ``results``: the driver keeps mutating the live
    partition lists the snapshot references."""
    fields = [f.name for f in dataclasses.fields(HostState)]
    return dataclasses.replace(
        snap, worker_ids=list(snap.worker_ids),
        host_state=(None if snap.host_state is None
                    else per_coordinate(
                        lambda h: map_rows(np.copy, h, fields),
                        snap.host_state)),
        sec_per_batch=snap.sec_per_batch.copy(),
        train_parts=[p.copy() for p in snap.train_parts],
        val_parts=[p.copy() for p in snap.val_parts],
        fixed_classes=copy.deepcopy(snap.fixed_classes),
        rng_state=copy.deepcopy(snap.rng_state))


# ----------------------------------------------------------------------
# Snapshots on disk: how the positions of a new roster (each its own
# process) receive their rows
# ----------------------------------------------------------------------

_MANIFEST = "snapshot.pkl"


def _row_file(directory: str, position: int, coord: int | None) -> str:
    return os.path.join(directory, f"row{position}.pkl" if coord is None
                        else f"row{position}_c{coord}.pkl")


def _coords(snap: MembershipSnapshot) -> list:
    return list(range(snap.blocks)) if snap.blocks else [None]


def save_snapshot(snap: MembershipSnapshot, directory: str) -> None:
    """Write ``snap`` into ``directory``: the manifest (everything but the
    host state) and one file per position (per position and inner
    coordinate on a grid) with that rank's host row."""
    os.makedirs(directory, exist_ok=True)
    for p in range(snap.n_workers):
        for c in _coords(snap):
            write_row(_row_file(directory, p, c),
                      host_row(snap.host_state, p, c))
    write_row(os.path.join(directory, _MANIFEST),
              dataclasses.replace(snap, host_state=None))


def write_row(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def read_row(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_snapshot(directory: str, position: int | None = None,
                  coord: int | None = None
                  ) -> tuple[MembershipSnapshot, dict | None]:
    """``(snapshot without its host state, the host row of position
    ``position`` at inner coordinate ``coord``)`` from ``directory`` (the
    row is None when ``position`` is None)."""
    snap = read_row(os.path.join(directory, _MANIFEST))
    row = (None if position is None else read_row(_row_file(
        directory, position, coord if snap.blocks else None)))
    return snap, row


def load_full_snapshot(directory: str) -> MembershipSnapshot:
    """A snapshot with its whole worker-stacked host state."""
    snap, _ = load_snapshot(directory)
    host = {c: stack_rows([read_row(_row_file(directory, p, c))
                           for p in range(snap.n_workers)])
            for c in _coords(snap)}
    return dataclasses.replace(
        snap, host_state=host if snap.blocks else host[None])
