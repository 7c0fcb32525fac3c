"""Async sharded checkpoints in the JAX package's format 2 (port of its
``checkpoint.py:1-43, 84-156, 156-617``), read and written with the port's
own MessagePack codec (``serialization.py``).

On disk, exactly as the JAX package lays it out::

    ckpt_dir/
      ckpt_<E>/
        shard_<P>.msgpack   {"format": 2, "process": P,
                             "leaves": {key: [[index, array], ...]}}
        MANIFEST.json       the commit marker, written last

Every leaf is a ``TrainState`` leaf of the JAX package under its key path
(``weights.state_to_jax_leaves``) with the leading worker axis [N, ...];
``index`` is the piece's global [[start, stop], ...].  Rank r of an
N-worker group writes ``shard_r.msgpack`` holding its worker row; a
one-worker run writes ``shard_0``.  So a checkpoint the port writes
restores into the JAX package (``restore_checkpoint``, ``host_tree``,
``ServeEngine.from_checkpoint``), and one the JAX package writes restores
here.

The commit, as in the JAX engine: the round loop pays only the snapshot
(device-to-host copies behind ``torch.cuda.synchronize()``); one writer
thread converts the layout, serializes, checksums (crc32), fsyncs and
renames the shard into place; then the manifest is written to a temporary
file, fsynced and renamed over ``MANIFEST.json`` (the commit point).  At
most one write is in flight: the next save waits for it (backpressure).
With N worker processes the commit needs every rank's (bytes, crc32,
payload bytes): a gather over the group, run on the main thread at the
next ``save``/``wait``/``close`` in the same order on every rank.  A crash
anywhere before the manifest's rename leaves an unmanifested directory
that ``latest_checkpoint`` ignores and the next engine open sweeps.

The fast sync engines' state rides along in JAX's layouts: the
error-feedback residual as ``.sync_residual[...]`` (laid out like
``.params``), the round optimizer's moments as
``.round_opt['b<i>']['mu'|'nu']`` (one row per worker: its shard under
the sharded placement, the whole padded vector under the replicated one;
a restore converts between the two) and the scatter-resident parameters
as ``.params_resident['b<i>']`` (row w: worker w's 1/N shard of the
consensus; such a checkpoint has no ``.params`` leaves, and a restore
converts between the resident and replicated layouts).  The hierarchical
sync's state rides too: the manifest records ``num_slices``, its resident
rows hold each worker's 1/W shard of its SLICE's consensus (rows
slice-major), its outer residual is ``.sync_residual_outer['b<i>']``, and
a restore re-lays the rows across slice layouts as JAX does
(``_relayout_resident_slices``).  The buddy rows are derived state: never
saved, re-derived after a restore.  The legacy single-file format 1
(``ckpt_<E>.msgpack``: ``{"state": the worker-stacked TrainState,
"global_epoch": E}``, JAX ``save_checkpoint_legacy``) restores too, as a
flat replicated epoch, as JAX's ``restore_checkpoint`` reads it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from . import mesh, serialization, weights

log = logging.getLogger(__name__)

_LEGACY_RE = re.compile(r"ckpt_(\d+)\.msgpack$")
_DIR_RE = re.compile(r"ckpt_(\d+)$")
MANIFEST = "MANIFEST.json"
FORMAT = 2

# Test hook: crash the process at a defined point inside a save, so the
# files on disk are what a SIGKILL there leaves.  Values: "mid_shard" (the
# shard's temporary file written, not renamed), "before_manifest" (the
# shard in place, no manifest).
_CRASH_ENV = "PORT_CKPT_TEST_CRASH"

def _maybe_crash(point: str) -> None:
    if os.environ.get(_CRASH_ENV) == point:
        os._exit(42)


@dataclasses.dataclass
class WorkerState:
    """One worker's train state as the checkpoint sees it: tensors (or
    host arrays) by ``state_dict`` name, optax Adam's count, the StepLR
    clock and the generator seed (uint32[2]), with the conversion layout
    (``weights.state_layout``) and this worker's row of the N workers."""

    params: dict
    buffers: dict
    mu: dict
    nu: dict
    count: int
    lr_epoch: int
    rng: np.ndarray
    layout: dict
    worker: int = 0
    n_workers: int = 1
    residual: Optional[dict] = None     # EF residual, like ``params``
    round_opt: Optional[dict] = None    # {bucket: {"mu", "nu"}}: this row
    # {bucket: row}: this worker's resident shard (``params`` is then {})
    params_resident: Optional[dict] = None
    # {bucket: row}: the hierarchical sync's outer EF residual
    residual_outer: Optional[dict] = None
    # on the rank grid: ``params``/``mu``/``nu``/``residual`` map the JAX
    # ``params`` leaf keys to this rank's shards, and this holds each
    # shard's global ``index``, the leaves' ``full_shapes``, which leaves
    # this rank ``writes`` (their first replica) and whether it is the
    # worker's ``lead`` rank (it writes the replicated rest)
    grid: Optional[dict] = None

    def tensors(self) -> dict:
        return {**{f"params/{k}": v for k, v in self.params.items()},
                **{f"params_resident/{k}": v
                   for k, v in (self.params_resident or {}).items()},
                **{f"buffers/{k}": v for k, v in self.buffers.items()},
                **{f"mu/{k}": v for k, v in self.mu.items()},
                **{f"nu/{k}": v for k, v in self.nu.items()},
                **{f"residual/{k}": v
                   for k, v in (self.residual or {}).items()},
                **{f"round_opt/{b}/{m}": v
                   for b, ms in (self.round_opt or {}).items()
                   for m, v in ms.items()},
                **{f"residual_outer/{k}": v
                   for k, v in (self.residual_outer or {}).items()}}


def snapshot(state: WorkerState) -> WorkerState:
    """Host copies of ``state``'s tensors behind ``torch.cuda.synchronize``
    (the counterpart of ``jax.block_until_ready``): once this returns the
    training may overwrite the live tensors."""
    tensors = state.tensors()
    if any(t.is_cuda for t in tensors.values()):
        torch.cuda.synchronize()
    host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
    part = lambda p: {k[len(p) + 1:]: v for k, v in host.items()
                      if k.startswith(p + "/")}
    round_opt = None
    if state.round_opt is not None:
        round_opt = {}
        for k, v in part("round_opt").items():
            b, m = k.split("/")
            round_opt.setdefault(b, {})[m] = v
    return dataclasses.replace(
        state, params=part("params"), buffers=part("buffers"),
        mu=part("mu"), nu=part("nu"), rng=np.array(state.rng, np.uint32),
        residual=part("residual") if state.residual is not None else None,
        round_opt=round_opt,
        params_resident=(part("params_resident")
                         if state.params_resident is not None else None),
        residual_outer=(part("residual_outer")
                        if state.residual_outer is not None else None))


def _numpy(d: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in d.items()}


def jax_leaves(state: WorkerState) -> dict[str, np.ndarray]:
    """A host ``WorkerState`` -> its row of every JAX TrainState leaf."""
    return weights.state_to_jax_leaves(
        _numpy(state.params), _numpy(state.buffers), _numpy(state.mu),
        _numpy(state.nu), state.count, state.lr_epoch, state.rng,
        state.layout,
        residual=None if state.residual is None else _numpy(state.residual),
        round_opt=None if state.round_opt is None else {
            b: _numpy(ms) for b, ms in state.round_opt.items()},
        params_resident=(None if state.params_resident is None
                         else _numpy(state.params_resident)),
        residual_outer=(None if state.residual_outer is None
                        else _numpy(state.residual_outer)))


def _piece(pieces: dict, meta: dict, key: str, w: int, n: int, index,
           arr: np.ndarray, full_shape, write: bool) -> None:
    """Leaf ``key``'s manifest entry (worker axis first) and, when
    ``write``, worker ``w``'s piece at ``index`` of its row."""
    shape = [n, *[int(d) for d in full_shape]]
    meta[key] = {"shape": shape, "dtype": str(arr.dtype),
                 "bytes": int(np.prod(shape, dtype=np.int64))
                 * arr.dtype.itemsize}
    if write:
        pieces[key] = [[[[w, w + 1]] + [list(map(int, i)) for i in index],
                        arr[None]]]


def row_pieces(host: WorkerState) -> tuple[dict, dict]:
    """The pieces of one worker's whole row (every leaf) and the leaves'
    manifest entries."""
    pieces, meta = {}, {}
    for key, arr in jax_leaves(host).items():
        _piece(pieces, meta, key, host.worker, host.n_workers,
               [[0, int(d)] for d in arr.shape], arr, arr.shape, True)
    return pieces, meta


def grid_pieces(host: WorkerState) -> tuple[dict, dict]:
    """A rank-grid shard's pieces (JAX ``snapshot_addressable``): each
    parameter, moment and residual shard at its global index, written by
    the leaf's first replica only; the BatchNorm statistics and the
    scalars by the worker's lead rank.  The manifest entries cover every
    leaf on every rank."""
    g, n, w = host.grid, host.n_workers, host.worker
    pieces, meta = {}, {}
    for part, prefix in (("params", ".params"), ("mu", ".opt_state.mu"),
                         ("nu", ".opt_state.nu"),
                         ("residual", ".sync_residual")):
        src = getattr(host, part)
        if src is None:
            continue
        for key, t in src.items():
            i = g["keys"].index(key)
            _piece(pieces, meta, prefix + key, w, n, g["index"][i],
                   np.asarray(t.numpy() if isinstance(t, torch.Tensor)
                              else t), g["full_shapes"][i], g["writes"][i])
    rest = {}
    if host.buffers:
        rest.update(weights._keyed(".batch_stats", weights.cnn_torch_to_flax(
            _numpy(host.buffers)).get("batch_stats", {})))
    rest[".opt_state.count"] = np.asarray(host.count, np.int32)
    rest[".lr_epoch"] = np.asarray(host.lr_epoch, np.int32)
    rest[".rng"] = np.asarray(host.rng, np.uint32).reshape(2)
    for key, arr in rest.items():
        _piece(pieces, meta, key, w, n, [[0, int(d)] for d in arr.shape],
               arr, arr.shape, g["lead"])
    return pieces, meta


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------

class CheckpointEngine:
    """Per-run checkpoint engine (JAX ``CheckpointEngine``): sweeps stale
    leftovers on open, then takes off-critical-path saves and prunes to
    the ``keep`` newest committed epochs.  ``async_write=False`` runs the
    same write path inline.  ``timing`` dicts given to ``save`` get
    ``ckpt_snapshot_ms`` at once and ``ckpt_write_ms`` when the write
    lands.  ``group``: the worker group (None: one worker); every rank
    must call ``save``/``wait``/``close`` at the same points."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_write: bool = True, metadata: dict | None = None,
                 group: mesh.Group | None = None):
        self.dir = ckpt_dir
        self.keep = max(1, int(keep))
        self.async_write = bool(async_write)
        self.metadata = dict(metadata) if metadata else {}
        self.group = group
        self.rank = 0 if group is None else group.rank
        self.process_count = 1 if group is None else group.world_size
        os.makedirs(ckpt_dir, exist_ok=True)
        self._sweep_stale()
        self._pool = None         # writer thread, started at the first save
        self._pending = None      # (future, epoch, timing)
        self.stats = {"saves": 0, "payload_bytes_per_save": 0,
                      "snapshot_ms_total": 0.0, "write_ms_total": 0.0}

    def rebind(self, group: mesh.Group | None) -> None:
        """Continue on ``group`` (an elastic boundary's new roster; call
        with nothing in flight: ``wait`` first)."""
        self.group = group
        self.rank = 0 if group is None else group.rank
        self.process_count = 1 if group is None else group.world_size

    def _sweep_stale(self) -> None:
        """Delete what a crash mid-save left: ``*.tmp.*`` files and
        ``ckpt_<E>/`` directories without a manifest.  Nothing is in
        flight when an engine opens."""
        def rm(path):
            # every rank sweeps the same directory: losing the race to a
            # peer is success
            try:
                os.remove(path)
                return True
            except FileNotFoundError:
                return False

        swept = []
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if ".tmp." in name and os.path.isfile(path):
                if rm(path):
                    swept.append(name)
            elif _DIR_RE.match(name) and os.path.isdir(path):
                if not os.path.isfile(os.path.join(path, MANIFEST)):
                    shutil.rmtree(path, ignore_errors=True)
                    swept.append(name + "/")
                    continue
                try:
                    inners = sorted(os.listdir(path))
                except FileNotFoundError:
                    continue       # a peer pruned it while we listed
                for inner in inners:
                    if ".tmp." in inner and rm(os.path.join(path, inner)):
                        swept.append(f"{name}/{inner}")
        if swept:
            log.info("swept %d stale checkpoint leftover(s) in %s: %s",
                     len(swept), self.dir, ", ".join(swept))

    # -- save ----------------------------------------------------------
    def save(self, state: WorkerState, global_epoch: int,
             timing: dict | None = None) -> str:
        """Snapshot ``state`` and commit it as epoch ``global_epoch``.
        The blocking part, all of it ``ckpt_snapshot_ms``: waiting out the
        write in flight (backpressure), then the fence and the host copies.
        Async mode returns there; the layout conversion, serialization,
        checksum, fsync and manifest ride the writer thread."""
        t0 = time.perf_counter()
        self._finalize()
        host = snapshot(state)
        snapshot_ms = round((time.perf_counter() - t0) * 1e3, 3)
        payload = (sum(t.numel() * t.element_size()
                       for t in host.tensors().values())
                   + 4 + 4 + 8)        # count, lr_epoch, rng
        if timing is not None:
            timing["ckpt_snapshot_ms"] = snapshot_ms
        self.stats["saves"] += 1
        self.stats["payload_bytes_per_save"] = payload
        self.stats["snapshot_ms_total"] = round(
            self.stats["snapshot_ms_total"] + snapshot_ms, 3)
        epoch = int(global_epoch)
        job = lambda: self._write_shard(host, epoch, timing)
        if self.async_write:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            self._pending = (self._pool.submit(job), epoch, timing)
        else:
            local, meta = job()
            if self.process_count > 1:
                self._commit(epoch, local, meta, timing)
        return os.path.join(self.dir, f"ckpt_{epoch}")

    def wait(self) -> None:
        """Block until the save in flight is committed (with N workers a
        collective: the deferred commit runs here)."""
        self._finalize()

    def close(self) -> None:
        """``wait()``, then release the writer thread (it restarts at the
        next async save)."""
        self._finalize()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def abort(self) -> None:
        """The unwinding twin of ``close``: join the writer without the
        commit (a collective a failing peer may never enter).  The epoch
        stays unmanifested and is swept at the next open; a writer failure
        is logged so the original exception propagates."""
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending[0].result()
            except Exception:  # noqa: BLE001 — the unwind must go on
                log.exception("checkpoint writer failed during abort")
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _finalize(self) -> None:
        if self._pending is None:
            return
        fut, epoch, timing = self._pending
        self._pending = None
        local, meta = fut.result()   # re-raises a failed background write
        if self.process_count > 1:
            # the commit is collective: here, on the main thread, in the
            # same program order on every rank
            self._commit(epoch, local, meta, timing)

    def _write_shard(self, host: WorkerState, epoch: int, timing
                     ) -> tuple[dict, dict]:
        """Convert, serialize, checksum and fsync this rank's shard file.
        Returns ({"bytes", "crc32", "payload_bytes"}, leaf metadata).  One
        worker commits here; N workers commit on the main thread."""
        t0 = time.perf_counter()
        pieces, meta = (grid_pieces(host) if host.grid is not None
                        else row_pieces(host))
        d = os.path.join(self.dir, f"ckpt_{epoch}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"shard_{self.rank}.msgpack")
        tmp = f"{path}.tmp.{self.rank}"
        with open(tmp, "wb") as f:
            size, crc = serialization.write(
                f, {"format": FORMAT, "process": self.rank,
                    "leaves": pieces})
            _maybe_crash("mid_shard")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        local = {"bytes": size, "crc32": crc,
                 "payload_bytes": sum(int(p[0][1].nbytes)
                                      for p in pieces.values())}
        _maybe_crash("before_manifest")
        if self.process_count == 1:
            self._commit(epoch, local, meta, timing, t_start=t0)
        else:
            write_ms = round((time.perf_counter() - t0) * 1e3, 3)
            self.stats["write_ms_total"] = round(
                self.stats["write_ms_total"] + write_ms, 3)
            if timing is not None:
                timing["ckpt_write_ms"] = write_ms
        return local, meta

    def _commit(self, epoch: int, local: dict, meta: dict, timing,
                t_start: float | None = None) -> None:
        """Publish MANIFEST.json (tmp, fsync, rename: the commit point),
        then prune.  With N workers the gathered (bytes, crc32, payload)
        of every shard doubles as the all-shards-durable barrier, and
        every rank writes the same manifest."""
        t0 = t_start if t_start is not None else time.perf_counter()
        if self.process_count > 1:
            rows = mesh.all_gather(self.group, [
                local["bytes"], local["crc32"], local["payload_bytes"]])
            shards = {f"shard_{q}.msgpack": {
                "bytes": int(r[0]), "crc32": int(r[1]),
                "payload_bytes": int(r[2])} for q, r in enumerate(rows)}
        else:
            shards = {"shard_0.msgpack": local}
        manifest = {"format": FORMAT, "global_epoch": int(epoch),
                    "process_count": self.process_count, "shards": shards,
                    "leaves": meta}
        if self.metadata:
            manifest["metadata"] = self.metadata
        path = os.path.join(self.dir, f"ckpt_{epoch}", MANIFEST)
        tmp = f"{path}.tmp.{self.rank}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)              # <- the commit point
        self._prune()
        write_ms = round((time.perf_counter() - t0) * 1e3, 3)
        self.stats["write_ms_total"] = round(
            self.stats["write_ms_total"] + write_ms, 3)
        if timing is not None:
            # += : with N workers the wall splits between the writer
            # thread (the shard) and this commit
            timing["ckpt_write_ms"] = round(
                timing.get("ckpt_write_ms", 0.0) + write_ms, 3)

    def _prune(self) -> None:
        """Every rank prunes to the ``keep`` newest manifested epochs
        (uncommitted directories belong to the open-time sweep)."""
        committed = sorted(set(_manifested_epochs(self.dir))
                           | set(_legacy_epochs(self.dir)))
        for old in committed[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{old}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"ckpt_{old}.msgpack"))
            except FileNotFoundError:
                pass

    # -- queries -------------------------------------------------------
    def latest_checkpoint(self) -> Optional[str]:
        return latest_checkpoint(self.dir, self.group)

    def summary(self) -> dict:
        """Run-level telemetry for ``results["checkpoint"]`` (the JAX
        engine's keys)."""
        return {"enabled": True, "async": self.async_write,
                "layout": "sharded", "keep": self.keep,
                "saves": self.stats["saves"],
                "bytes_per_host": self.stats["payload_bytes_per_save"],
                "stall_ms_total": self.stats["snapshot_ms_total"],
                "write_ms_total": self.stats["write_ms_total"]}


# ----------------------------------------------------------------------
# Listing / validation
# ----------------------------------------------------------------------

def _legacy_epochs(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _LEGACY_RE.match(name)))


def read_manifest(epoch_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(epoch_dir, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 22):
            crc = zlib.crc32(chunk, crc)
    return crc


def _valid_sharded(epoch_dir: str) -> bool:
    """Restorable iff the manifest parses and every manifested shard is
    present at its manifested size and crc32: a missing, truncated or
    corrupt shard drops the epoch, so ``latest_checkpoint`` falls back."""
    manifest = read_manifest(epoch_dir)
    if not manifest or "shards" not in manifest:
        return False
    for fname, info in manifest["shards"].items():
        path = os.path.join(epoch_dir, fname)
        if (not os.path.isfile(path)
                or os.path.getsize(path) != int(info["bytes"])):
            return False
        try:
            crc = _file_crc(path)
        except OSError:
            return False
        if crc != int(info["crc32"]):
            log.warning("checkpoint shard %s is corrupt (size matches, "
                        "crc32 does not): dropping its epoch", path)
            return False
    return True


def _sharded_epochs(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _DIR_RE.match(name))
                  and _valid_sharded(os.path.join(ckpt_dir, name)))


def _manifested_epochs(ckpt_dir: str) -> list[int]:
    """Epochs whose commit marker exists, restorable or not (the prune
    population)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := _DIR_RE.match(name))
        and os.path.isfile(os.path.join(ckpt_dir, name, MANIFEST)))


def committed_epochs(ckpt_dir: str) -> list[int]:
    """Restorable epochs (intact sharded directories, plus legacy single
    files), ascending."""
    return sorted(set(_sharded_epochs(ckpt_dir))
                  | set(_legacy_epochs(ckpt_dir)))


def manifest_metadata(path: str) -> dict:
    """The ``metadata`` block of a committed ``ckpt_<E>`` directory, or of
    the newest committed one under a checkpoint root; ``{}`` if none."""
    manifest = read_manifest(path)
    if manifest is None:
        epochs = _sharded_epochs(path)
        if not epochs:
            return {}
        manifest = read_manifest(os.path.join(path, f"ckpt_{epochs[-1]}"))
    return dict((manifest or {}).get("metadata", {}))


def latest_checkpoint(ckpt_dir: str, group: mesh.Group | None = None
                      ) -> Optional[str]:
    """Path of the newest committed checkpoint.  With a group every rank
    must call this: rank 0's epoch is taken, and a rank that cannot
    restore it raises instead of resuming elsewhere."""
    epochs = committed_epochs(ckpt_dir)
    local = max(epochs) if epochs else -1
    if group is not None:
        agreed = int(mesh.all_gather(group, local)[0])
        if agreed >= 0 and agreed not in epochs:
            raise FileNotFoundError(
                f"rank {group.rank} is missing checkpoint epoch {agreed} "
                f"present on rank 0 ({ckpt_dir}); cannot resume "
                "consistently")
        local = agreed
    if local < 0:
        return None
    d = os.path.join(ckpt_dir, f"ckpt_{local}")
    if _valid_sharded(d):
        return d
    return os.path.join(ckpt_dir, f"ckpt_{local}.msgpack")


# ----------------------------------------------------------------------
# Restore
# ----------------------------------------------------------------------

def manifest_worker_axis(epoch_dir: str) -> Optional[int]:
    """The leading worker-axis size of a committed epoch's leaves, read
    from the manifest alone; None when unreadable or the leaves disagree."""
    manifest = read_manifest(epoch_dir)
    if not manifest or not manifest.get("leaves"):
        return None
    heads = {tuple(i["shape"])[0] if i["shape"] else None
             for i in manifest["leaves"].values()}
    if len(heads) != 1 or None in heads:
        return None
    return int(heads.pop())


def verified_shards(path: str, manifest: dict):
    """Each present shard file's decoded payload, one file at a time, after
    the manifest's size and crc32 checks (a mismatch raises)."""
    for fname, info in manifest["shards"].items():
        fp = os.path.join(path, fname)
        if not os.path.isfile(fp):
            continue
        raw = bytearray(os.path.getsize(fp))     # writable leaves
        with open(fp, "rb") as f:
            f.readinto(raw)
        if (len(raw) != int(info["bytes"])
                or zlib.crc32(raw) != int(info["crc32"])):
            raise ValueError(f"checkpoint shard {fp} is corrupt (size/crc "
                             "mismatch vs manifest)")
        yield serialization.loads(raw)


def _place(out, index, arr) -> int:
    out[tuple(slice(a, b) for a, b in index)] = arr
    return int(np.prod(np.shape(arr), dtype=np.int64))


def host_tree(path: str, keep=None) -> tuple[dict[str, np.ndarray], int]:
    """Every leaf (or those ``keep(key)`` selects) of a committed sharded
    epoch merged into a full host array (worker axis first), with the
    epoch; crc32 checked per shard."""
    manifest = read_manifest(path)
    if not manifest:
        raise FileNotFoundError(f"no committed manifest under {path}")
    wanted = [k for k in manifest["leaves"] if keep is None or keep(k)]
    out, filled = {}, {}
    for payload in verified_shards(path, manifest):
        for key, plist in payload["leaves"].items():
            if keep is not None and not keep(key):
                continue
            info = manifest["leaves"][key]
            if key not in out:
                out[key] = np.empty(tuple(info["shape"]),
                                    np.dtype(info["dtype"]))
                filled[key] = 0
            for index, arr in plist:
                filled[key] += _place(out[key], index, arr)
    for key in wanted:
        if key not in out or filled[key] != out[key].size:
            raise ValueError(
                f"checkpoint leaf {key} is incomplete under {path} "
                "(missing shard file?)")
    return {k: out[k] for k in wanted}, int(manifest["global_epoch"])


def load_row(path: str, manifest: dict, row: int, keep=None
             ) -> dict[str, np.ndarray]:
    """Worker ``row`` of every leaf (or of the leaves ``keep(key)``
    selects), streamed one shard file at a time: the other workers' rows
    are never assembled.  A leaf the shards do not cover raises."""
    want = {k: i for k, i in manifest["leaves"].items()
            if keep is None or keep(k)}
    out, filled = {}, {}
    for payload in verified_shards(path, manifest):
        for key, plist in payload["leaves"].items():
            if key not in want:
                continue
            for index, arr in plist:
                lo, hi = index[0]
                if not lo <= row < hi:
                    continue
                if key not in out:
                    out[key] = np.empty(tuple(want[key]["shape"][1:]),
                                        np.dtype(want[key]["dtype"]))
                    filled[key] = 0
                filled[key] += _place(out[key], index[1:], arr[row - lo])
    for key in want:
        if key not in out or filled[key] != out[key].size:
            raise ValueError(
                f"checkpoint {path} has no complete row {row} of leaf "
                f"{key} (missing shard file?)")
    return {k: out[k] for k in want}


def saved_slices(path: str, manifest: dict) -> int:
    """The slice count of the run that wrote ``manifest`` (its metadata's
    ``num_slices``, 1 when absent); raises when its worker rows do not
    split evenly into that many slices."""
    slices = int(manifest.get("metadata", {}).get("num_slices", 1) or 1)
    axis = manifest_worker_axis(path)
    if slices < 1 or (axis is not None and axis % slices):
        raise ValueError(
            f"checkpoint {path} records {slices} slice(s) but holds "
            f"{axis} worker row(s): its rows do not split into its "
            "slices (a damaged or hand-edited manifest?)")
    return slices


def legacy_tree(path: str) -> tuple[dict[str, np.ndarray], int]:
    """Every leaf of a legacy single-file (format 1) checkpoint, worker
    axis first, by JAX key path, with its epoch (JAX
    ``restore_checkpoint``'s legacy branch, ``checkpoint.py:736-742``)."""
    with open(path, "rb") as f:
        payload = serialization.loads(bytearray(f.read()))
    if not isinstance(payload, dict) or set(payload) != {"state",
                                                         "global_epoch"}:
        raise ValueError(
            f"{path} is not a legacy single-file checkpoint (a MessagePack "
            "map of 'state' and 'global_epoch')")
    return (weights.leaves_of_state_dict(payload["state"]),
            int(payload["global_epoch"]))


@dataclasses.dataclass(frozen=True)
class _Saved:
    """One restorable epoch, whatever its format: its worker rows
    (``axis``), leaf keys, epoch, slice count and metadata, ``row(worker,
    keep)`` (one worker's row of the leaves ``keep`` selects) and
    ``full(keep)`` (those leaves whole, worker axis first)."""
    path: str
    axis: Optional[int]
    keys: list
    epoch: int
    slices: int
    metadata: dict
    row: Callable
    full: Callable


def _open(path: str) -> _Saved:
    """A committed sharded epoch directory (format 2) or a legacy single
    file (format 1, read whole as JAX reads it)."""
    if os.path.isfile(path):
        tree, epoch = legacy_tree(path)
        heads = {np.shape(v)[0] if np.ndim(v) else None
                 for v in tree.values()}
        return _Saved(
            path, heads.pop() if len(heads) == 1 else None, list(tree),
            epoch, 1, {},
            row=lambda w, keep: {k: v[w] for k, v in tree.items()
                                 if keep(k)},
            full=lambda keep: {k: v for k, v in tree.items() if keep(k)})
    manifest = read_manifest(path) if os.path.isdir(path) else None
    if not manifest:
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return _Saved(
        path, manifest_worker_axis(path), list(manifest["leaves"]),
        int(manifest["global_epoch"]), saved_slices(path, manifest),
        manifest.get("metadata", {}),
        row=lambda w, keep: load_row(path, manifest, w, keep=keep),
        full=lambda keep: host_tree(path, keep=keep)[0])


def restore_checkpoint(path: str, template: WorkerState, *,
                       params_template=None,
                       bucket_bytes: int | None = None,
                       num_slices: int = 1) -> tuple[WorkerState, int]:
    """``(state, global_epoch)`` from a committed epoch: worker
    ``template.worker``'s row of every leaf, converted to the port's
    layout, as host numpy arrays in a ``WorkerState`` shaped like
    ``template`` (its tensors give the names, shapes and dtypes; a
    missing leaf or a shape or dtype mismatch raises).  A resident
    checkpoint restores into a replicated template and the reverse (JAX
    ``_relayout_params_residency``): both hold one consensus vector;
    ``params_template`` (``comms.ParamsTemplate``) addresses its buckets,
    ``bucket_bytes`` sizes them when the manifest records none.

    ``num_slices``: the restoring run's slice count; the manifest records
    the saving run's (JAX ``restore_checkpoint(num_slices=)``).  Each
    slice holds its own consensus: a flat checkpoint restores into any
    S x W layout (every slice adopts the one consensus), a replicated
    template's worker gets its own slice's consensus, and per-slice
    consensuses that differ cannot re-shard to another slice count.  A
    missing (or re-tiled) outer residual restores as zeros.  A legacy
    single file (format 1) restores as a flat replicated epoch."""
    saved = _open(path)
    if saved.axis != template.n_workers:
        raise ValueError(
            f"checkpoint {path} was written with {saved.axis} worker(s) but "
            f"this run has {template.n_workers}: restart fresh or resume "
            f"with --num_workers {saved.axis}")
    if num_slices < 1 or template.n_workers % num_slices:
        raise ValueError(
            f"restore template worker rows ({template.n_workers}) not "
            f"divisible by num_slices ({num_slices})")
    # this worker's row of every leaf but the round optimizer's, in one
    # pass over the shard files (its resident and outer rows with it)
    row = saved.row(template.worker,
                    lambda k: not k.startswith(".round_opt"))
    for key in weights.SCALAR_KEYS:
        if key not in row:
            raise ValueError(f"checkpoint {path} has no leaf {key} required "
                             "by the restore template")
    got = weights.state_from_jax_leaves(row, template.layout)
    params_resident = _relayout_residency(
        saved, template, got, row, params_template, bucket_bytes,
        num_slices)
    for part in ("params", "buffers", "mu", "nu"):
        want, have = getattr(template, part), got[part]
        for name, t in want.items():
            if name not in have:
                raise ValueError(
                    f"checkpoint {path} has no leaf for {part} {name} "
                    "required by the restore template (another model?)")
            a = have[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint {part} {name} shape {tuple(a.shape)} does "
                    f"not match template {tuple(t.shape)}")
            if str(a.dtype) != str(t.dtype).removeprefix("torch."):
                raise ValueError(
                    f"checkpoint {part} {name} dtype {a.dtype} does not "
                    f"match template {t.dtype} (saved with another "
                    "--dtype?)")
        extra = sorted(set(have) - set(want))
        if extra:
            raise ValueError(f"checkpoint {path} has {part} {extra[:3]} the "
                             "restore template lacks (another model?)")
    residual = None
    if template.residual is not None:
        if "sync_residual" not in got:
            raise ValueError(
                f"checkpoint {path} has no .sync_residual leaves, required "
                "by the restore template (--sync_compression ef)")
        residual = _match_template(path, "sync_residual",
                                   got["sync_residual"], template.residual)
    round_opt = (None if template.round_opt is None else
                 _restore_round_opt(saved, template))
    residual_outer = (None if template.residual_outer is None else
                      _restore_outer_residual(path, template, row))
    state = dataclasses.replace(
        template, params=got["params"], buffers=got["buffers"],
        mu=got["mu"], nu=got["nu"], count=got["count"],
        lr_epoch=got["lr_epoch"], rng=got["rng"], residual=residual,
        round_opt=round_opt, params_resident=params_resident,
        residual_outer=residual_outer)
    return state, saved.epoch


def _restore_outer_residual(path: str, template: WorkerState,
                            row: dict) -> dict:
    """This worker's outer EF rows (JAX ``restore_checkpoint``'s outer
    branch) from its ``row`` of the checkpoint: as saved when the shapes
    agree; absent (a flat or older checkpoint) or re-tiled, zeros, since
    the residual is sub-quantum correction mass that resets safely."""
    out = {}
    for b, t in template.residual_outer.items():
        key = f".sync_residual_outer['{b}']"
        val = row.get(key)
        if val is not None and tuple(val.shape) == tuple(t.shape):
            out[b] = np.ascontiguousarray(val)
            continue
        if val is not None:
            log.warning(
                "checkpoint %s outer-residual leaf %s shape %s does not "
                "match template %s (slice/worker re-layout) — restoring "
                "zero rows", path, key, tuple(val.shape), tuple(t.shape))
        out[b] = np.zeros(tuple(t.shape), np.float32)
    return out


def restore_grid(path: str, template: WorkerState
                 ) -> tuple[WorkerState, int]:
    """``(state, global_epoch)`` for a rank of the grid: worker
    ``template.worker``'s row of every leaf merged from the pieces of
    whatever mesh wrote it (a grid's shards or whole rows), the parameter,
    moment and residual leaves kept whole in the JAX layout (the engine
    cuts them for the mesh being restored) and the BatchNorm statistics
    converted to the port's names."""
    saved = _open(path)
    axis = saved.axis
    if axis != template.n_workers:
        raise ValueError(
            f"checkpoint {path} was written with {axis} worker(s) but this "
            f"run has {template.n_workers}: restart fresh or resume with "
            f"--mesh_shape data={axis}")
    if any(k.startswith(".params_resident") for k in saved.keys):
        raise ValueError(
            f"checkpoint {path} holds scatter-resident parameters: restore "
            "it on a data-only mesh (the grid keeps them replicated)")
    row = saved.row(template.worker, lambda k: not k.startswith(
        (".round_opt", ".sync_residual_outer")))
    for key in weights.SCALAR_KEYS:
        if key not in row:
            raise ValueError(f"checkpoint {path} has no leaf {key}")
    part = lambda prefix: {k[len(prefix):]: v for k, v in row.items()
                           if k.startswith(prefix + "[")}
    stats = weights._trees(row).get("batch_stats", {})
    buffers = (weights.cnn_flax_to_torch({"params": {}, "batch_stats": stats})
               if stats else {})
    missing = sorted(set(template.buffers) - set(buffers))
    if missing:
        raise ValueError(f"checkpoint {path} has no statistics for "
                         f"{missing[:3]} (another model?)")
    residual = part(".sync_residual") or None
    state = dataclasses.replace(
        template, params=part(".params"), mu=part(".opt_state.mu"),
        nu=part(".opt_state.nu"), residual=residual, buffers=buffers,
        count=int(row[".opt_state.count"]),
        lr_epoch=int(row[".lr_epoch"]),
        rng=np.asarray(row[".rng"], np.uint32).reshape(2))
    return state, saved.epoch


def _relayout_residency(ckpt: _Saved, template: WorkerState, got: dict,
                        row: dict, params_template, bucket_bytes,
                        num_slices: int = 1) -> Optional[dict]:
    """The template's parameters from the checkpoint, whatever layout
    wrote them (JAX ``_relayout_params_residency``): ``got["params"]``
    (port names) is filled in place for a replicated template; the
    resident template's rows are returned (from ``row``, this worker's
    row of the leaves, when the layout is the saved one).  ``ckpt.slices``
    and ``num_slices`` are the writing and the restoring run's slice
    counts: each slice's rows hold its own consensus (JAX
    ``checkpoint.py:745-1000``)."""
    from . import comms
    path, saved = ckpt.path, ckpt.slices
    keys = [k for k in ckpt.keys if k.startswith(".params_resident")]
    meta_mb = ckpt.metadata.get("sync_bucket_mb")
    if template.params_resident is None and not keys:
        return None
    if params_template is None:
        raise ValueError(
            f"restoring {path} into a {'resident' if keys else 'replicated'}"
            " parameter layout from the other one needs params_template "
            "(the engine's comms.ParamsTemplate)")
    n = template.n_workers
    w_s, w_t = n // saved, n // num_slices
    if template.params_resident is not None and keys:
        if saved == num_slices:
            out = {}
            for b, t in template.params_resident.items():
                key = f".params_resident['{b}']"
                if (key not in row
                        or tuple(row[key].shape) != tuple(t.shape)):
                    raise ValueError(
                        f"checkpoint {path} resident bucket {key} "
                        f"{None if key not in row else row[key].shape} "
                        f"does not match the template's {tuple(t.shape)} "
                        "(saved with another --sync_bucket_mb or worker "
                        "count?)")
                out[b] = row[key]
            return out
        bb = (int(float(meta_mb) * (1 << 20)) if meta_mb
              else bucket_bytes or comms.DEFAULT_BUCKET_BYTES)
        return _relayout_resident_slices(ckpt, keys, template,
                                         params_template, bb, num_slices)
    if keys:
        # resident on disk -> replicated template: the gather, on host,
        # of this worker's slice's rows
        bb = (int(float(meta_mb) * (1 << 20)) if meta_mb
              else bucket_bytes or comms.DEFAULT_BUCKET_BYTES)
        full = ckpt.full(lambda k: k in keys)
        s = template.worker // w_s
        resident = {k[len(".params_resident['"):-2]:
                    v[s * w_s:(s + 1) * w_s] for k, v in full.items()}
        got["params"] = dict(zip(params_template.names,
                                 comms.resident_to_tree(
                                     resident, template=params_template,
                                     bucket_bytes=bb)))
        return None
    # replicated on disk -> resident template: only a consensus per slice
    full = ckpt.full(lambda k: k.startswith(".params["))
    s = template.worker // w_t
    for key, arr in full.items():
        for g in range(num_slices):
            rows = arr[g * w_t:(g + 1) * w_t]
            if not np.array_equal(rows, np.broadcast_to(rows[:1],
                                                        rows.shape)):
                raise ValueError(
                    f"checkpoint leaf {key} rows differ"
                    + (f" within slice {g}" if num_slices > 1 else "")
                    + ": only a consensus state (weights x equal "
                    "aggregation) can restore into the scatter-resident "
                    "layout")
    params = weights.params_from_jax_leaves(
        {k: v[s * w_t] for k, v in full.items()}, template.layout)
    bb = bucket_bytes or (int(float(meta_mb) * (1 << 20)) if meta_mb
                          else comms.DEFAULT_BUCKET_BYTES)
    rows = comms.resident_from_tree(
        [params[name] for name in params_template.names],
        w_t, template=params_template, bucket_bytes=bb)
    got["params"] = {}
    return {b: np.ascontiguousarray(v[template.worker % w_t])
            for b, v in rows.items()}


def _slice_consensus_vectors(rows: np.ndarray, filled: int,
                             saved: int) -> list[np.ndarray]:
    """One saved resident bucket's ``[S*W, row]`` rows as the S per-slice
    FILLED consensus vectors, pad trimmed (JAX
    ``_slice_consensus_vectors``): what each slice's entry gather would
    rebuild."""
    per = int(rows.shape[0]) // saved
    return [rows[g * per:(g + 1) * per].reshape(-1)[:filled]
            for g in range(saved)]


def _relayout_resident_slices(ckpt: _Saved, keys: list,
                              template: WorkerState, params_template,
                              bucket_bytes: int, num_slices: int) -> dict:
    """This worker's resident rows when the slice layout changed (JAX
    ``_relayout_resident_slices``): each bucket's per-slice consensus
    vectors under the saved tiling, re-tiled under the template's.  A flat
    checkpoint (or slices that agree bit for bit) gives every slice the
    one consensus; distinct per-slice consensuses are refused."""
    from . import comms
    path, saved = ckpt.path, ckpt.slices
    n = template.n_workers
    w_s, w_t = n // saved, n // num_slices
    leaves = list(params_template.leaves)
    plan_s = comms.bucket_plan(leaves, w_s, bucket_bytes)
    plan_t = comms.bucket_plan(leaves, w_t, bucket_bytes)
    if len(plan_s) != len(plan_t):
        raise ValueError(
            f"checkpoint {path} resident bucket count ({len(plan_s)}) "
            f"differs from the template's ({len(plan_t)}) — different "
            "sync_bucket_mb?")
    full = ckpt.full(lambda k: k in keys)
    s, i = template.worker // w_t, template.worker % w_t
    out = {}
    for b, (bs, bt) in enumerate(zip(plan_s, plan_t)):
        name = comms.bucket_name(b)
        key = f".params_resident['{name}']"
        if key not in full:
            raise ValueError(
                f"checkpoint {path} resident layout has no bucket leaf "
                f"{key}")
        arr = np.asarray(full[key])
        if arr.shape != (n, bs.padded // w_s):
            raise ValueError(
                f"checkpoint resident bucket {key} has shape "
                f"{arr.shape}, expected {(n, bs.padded // w_s)} "
                "(different sync_bucket_mb or worker count?)")
        filled = comms._filled(bs)
        vecs = _slice_consensus_vectors(arr, filled, saved)
        if saved != num_slices:
            if not all(np.array_equal(vecs[0], v) for v in vecs[1:]):
                raise ValueError(
                    f"checkpoint {path} was saved with {saved} slice(s) "
                    "whose consensuses DIFFER; it cannot re-shard to "
                    f"{num_slices} slice(s) — a per-slice consensus has "
                    "no defined assignment to a different slice count "
                    "(restore into the saved topology, or into a "
                    "replicated layout)")
            vecs = [vecs[0]] * num_slices
        vec = np.zeros(bt.padded, np.float32)
        vec[:filled] = vecs[s]
        row = bt.padded // w_t
        out[name] = np.ascontiguousarray(vec[i * row:(i + 1) * row])
    return out


def _match_template(path: str, part: str, have: dict, want: dict) -> dict:
    for name, t in want.items():
        if name not in have:
            raise ValueError(
                f"checkpoint {path} has no leaf for {part} {name} required "
                "by the restore template (another model?)")
        if tuple(have[name].shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint {part} {name} shape {tuple(have[name].shape)} "
                f"does not match template {tuple(t.shape)}")
    return {name: have[name] for name in want}


def _restore_round_opt(ckpt: _Saved, template: WorkerState) -> dict:
    """This worker's round-optimizer rows (JAX ``restore_checkpoint``'s
    round-opt branch): the saved layout as it is, or converted between
    the sharded ([N, P/N] rows of one vector) and replicated ([N, P]
    equal rows) layouts, which both hold the same vector; a checkpoint
    without them restores zero moments, as JAX does."""
    path = ckpt.path
    keys = {k for k in ckpt.keys if k.startswith(".round_opt")}
    if not keys:
        log.warning("checkpoint %s has no round-optimizer leaves — "
                    "restoring zero moments", path)
        return {b: {m: np.zeros(tuple(v.shape), np.float32)
                    for m, v in ms.items()}
                for b, ms in template.round_opt.items()}
    full = ckpt.full(lambda k: k in keys)
    n, w = template.n_workers, template.worker
    out = {}
    for b, ms in template.round_opt.items():
        out[b] = {}
        for m, t in ms.items():
            key = f".round_opt['{b}']['{m}']"
            if key not in full:
                raise ValueError(
                    f"checkpoint {path} has no round-optimizer leaf {key} "
                    "(different --sync_bucket_mb?)")
            val, row = full[key], int(t.shape[0])
            if val.shape[0] != n or val.ndim != 2:
                raise ValueError(
                    f"checkpoint round-optimizer leaf {key} shape "
                    f"{tuple(val.shape)} does not fit {n} worker(s)")
            p = int(val.shape[1])
            if p == row:                 # the same layout
                out[b][m] = np.ascontiguousarray(val[w])
            elif row == n * p:           # sharded on disk -> replicated
                out[b][m] = np.ascontiguousarray(val.reshape(-1))
            elif p == n * row:           # replicated on disk -> sharded
                out[b][m] = np.ascontiguousarray(
                    val[0][w * row:(w + 1) * row])
            else:
                raise ValueError(
                    f"checkpoint round-optimizer leaf {key} shape "
                    f"{tuple(val.shape)} matches neither the sharded nor "
                    f"the replicated layout of a {row}-element row "
                    "(different --sync_bucket_mb or worker count?)")
    return out
