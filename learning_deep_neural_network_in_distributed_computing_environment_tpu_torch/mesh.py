"""The worker group: one process per local-SGD worker, joined in a
``torch.distributed`` gloo group (counterpart of the JAX package's
``mesh.py``: ``initialize_distributed`` :44, ``resolve_axes`` :64; ROADMAP
queue A.5, the N-worker sync slice).

The JAX package runs N workers as one SPMD program on an N-device mesh.
The port runs them as N processes, as the reference does.  On a host with
one card all N processes share it: NCCL refuses two ranks on one device,
so the group is gloo, whose collectives run on CPU tensors; ``comms``
stages the once-per-round sync through pinned host memory.  Every
``--backend`` (jax, gloo, nccl, mpi) is this gloo group, as every value is
XLA in the JAX package; device collectives with one rank per card are a
speed item for a host with several cards.

The rendezvous is a ``FileStore`` in a fresh temporary directory (a TCP
port could collide between concurrent runs on one host), every collective
waits at most ``GROUP_TIMEOUT_S``, and the group is destroyed when the
rank's work ends, also when it raises.  Children are started with the
``spawn`` method (CUDA cannot fork) and import nothing but the port.

With ``--mesh_shape data=D,fsdp=F,seq=S,pipe=P,model=T`` the world of
D x F x S x P x T ranks is a rank grid (``Grid``, ``make_grid``; JAX
``mesh.build_mesh``): one gloo group per line of each axis, each worker
the block of ranks with one data coordinate (with a group of its own for
the verdicts a worker takes together).  ``--num_slices S`` makes the
world S x W workers on the grid ``{"slice": S, "data": W}``: each worker's
data line is its slice (the inner level of the hierarchical sync), its
slice line the workers of the same data coordinate in every slice (the
outer level).

The launched mode (JAX ``mesh.initialize_distributed``, :44-61): with
``JAX_COORDINATOR_ADDRESS=host:port``, ``JAX_NUM_PROCESSES=P`` and
``JAX_PROCESS_ID=p`` set, P independently started processes (one a host)
make one world of R ranks (``Launch``).  Process p holds the global ranks
p*L .. p*L+L-1 (L = R/P, process-major, as JAX ``build_mesh`` lays its
mesh out), so the leading axis (slice, then data) spans processes and
every worker block lies within one; each rank's device and threads follow
its local rank.  The ranks meet at a ``TCPStore`` on the coordinator's
host:port, hosted by process 0's first rank (global rank 0), which stays
until every other rank has left its group.  Without the variables the
single-launch path and its FileStore run unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import shutil
import tempfile
import time
from typing import Callable, Iterator, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# seconds any collective (and the rendezvous) may wait for a peer: longer
# than the widest gap between two ranks reaching the same sync point
# (a full-data round of the reference's run), short enough that a dead
# peer ends the run instead of hanging it
GROUP_TIMEOUT_S = 300.0

# the launch's variables, under JAX's names and with JAX's meaning
COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
PROCESS_ID_ENV = "JAX_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class Launch:
    """One independently started process of a launched world: the
    coordinator's ``host:port``, the process count and this process's id;
    ``world_size`` is the world's rank count once the run's mesh is known
    (``with_world``).  Picklable: spawned ranks get it in place of a
    FileStore path."""

    address: str
    num_processes: int
    process_id: int
    world_size: int = 0

    @property
    def host(self) -> str:
        return self.address.rsplit(":", 1)[0].strip("[]")

    @property
    def port(self) -> int:
        return int(self.address.rsplit(":", 1)[1])

    @property
    def ranks_per_process(self) -> int:
        return self.world_size // self.num_processes

    @property
    def ranks(self) -> range:
        """This process's global ranks."""
        per = self.ranks_per_process
        return range(self.process_id * per, (self.process_id + 1) * per)

    def process_of(self, rank: int) -> int:
        return rank // self.ranks_per_process

    def with_world(self, world_size: int) -> Launch:
        return dataclasses.replace(self, world_size=int(world_size))


def launch_from_env(environ=None) -> Launch | None:
    """The launch the environment describes (JAX's three variables), or
    None when ``JAX_COORDINATOR_ADDRESS`` is unset: a single launch."""
    env = os.environ if environ is None else environ
    address = env.get(COORDINATOR_ENV, "")
    if not address:
        return None
    try:
        int(address.rsplit(":", 1)[1])        # host:port
        launch = Launch(address, int(env[NUM_PROCESSES_ENV]),
                        int(env[PROCESS_ID_ENV]))
    except (KeyError, ValueError, IndexError):
        raise ValueError(
            f"{COORDINATOR_ENV}={address!r} launches one process of a "
            f"multi-process world: set {NUM_PROCESSES_ENV} (the process "
            f"count) and {PROCESS_ID_ENV} (0 .. count-1) too, and give the "
            "coordinator as host:port") from None
    if not 0 <= launch.process_id < launch.num_processes:
        raise ValueError(
            f"{PROCESS_ID_ENV}={launch.process_id} is not a process id of "
            f"{NUM_PROCESSES_ENV}={launch.num_processes}")
    return launch


@dataclasses.dataclass
class Group:
    """One rank's view of the worker group, and the pinned host buffers
    its syncs stage through (kept across rounds: pinning is slow).

    ``pg`` is the ``torch.distributed`` process group its collectives run
    on (None: the default group); ``split`` gives a second view over the
    same ranks with a process group and buffers of its own, so a sync on
    a host thread never interleaves its collectives with the main
    thread's.  ``wire`` counts the bytes this rank handed to gloo for
    other ranks, by kind (``payload``, ``scale``), for the fast engines'
    accounting (``comms.sync_wire_bytes``)."""

    rank: int
    world_size: int
    device: torch.device
    pg: object = None
    # the global ranks of this group's members, in group-rank order (None:
    # the group spans the world and group rank is global rank)
    ranks: tuple | None = None
    # the launched processes the world spans (1: a single launch)
    processes: int = 1
    _host: dict = dataclasses.field(default_factory=dict, repr=False)
    wire: dict = dataclasses.field(default_factory=dict, repr=False)

    def host_buffer(self, slot: str, numel: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A reusable host buffer of ``numel`` elements of ``dtype``,
        pinned when the group's device is a card."""
        buf = self._host.get(slot)
        if buf is None or buf.numel() != numel or buf.dtype != dtype:
            buf = torch.empty(numel, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._host[slot] = buf
        return buf

    def count_wire(self, kind: str, nbytes: int) -> None:
        self.wire[kind] = self.wire.get(kind, 0) + int(nbytes)

    def all_gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def peer(self, rank: int) -> int:
        """The global rank of group rank ``rank`` (point-to-point ops name
        their peer by global rank)."""
        return rank if self.ranks is None else self.ranks[rank]

    def split(self, timeout_s: float = GROUP_TIMEOUT_S) -> "Group":
        """A new view of the same ranks on a process group of its own (a
        collective: every rank calls it at the same point).  Only a group
        that spans the world splits alone: every process enters each
        ``new_group``, so the lines of a grid axis are made together
        (``Grid``)."""
        if self.ranks is not None:
            raise RuntimeError(
                "a grid line's group cannot split alone: every process "
                "must create every group, in the same order")
        pg = dist.new_group(list(range(self.world_size)), backend="gloo",
                            timeout=datetime.timedelta(seconds=timeout_s))
        return Group(self.rank, self.world_size, self.device, pg)


@dataclasses.dataclass
class Grid:
    """One rank's place in the rank grid of ``--mesh_shape`` (JAX
    ``mesh.build_mesh``: the devices reshaped row-major into the axes'
    order): ``axes`` maps each axis to its size in the order the flag gives
    them, ``data`` first unless named later; world rank r has the
    row-major coordinates ``coords_of(r)``.  ``groups[axis]`` is this
    rank's line along ``axis`` (the ranks that differ from it in that
    coordinate only, in coordinate order, so group rank = coordinate);
    ``world`` spans every rank.  Each worker of the local-SGD run is the
    block of ranks with one data coordinate: its fsdp x model ranks shard
    the worker's parameters, its seq ranks each hold one chunk of every
    sequence under --sequence_parallel (else the whole batch) and whole
    copies of the parameters, its pipe ranks are the stages of its layer
    stack, its expert ranks each hold E/ep of the experts of every MoE
    layer, and the data line of each (fsdp, seq, pipe, expert, model)
    coordinate syncs that coordinate's shards once per round."""

    axes: dict
    world: Group
    groups: dict
    coords: dict
    # the worker's block: the ranks of this rank's data coordinate (None
    # without inner axes), on a group of its own (``make_grid``)
    block: Group | None = None
    # the second groups of ``split_lines``
    _extra: list = dataclasses.field(default_factory=list, repr=False)

    def size(self, axis: str) -> int:
        return int(self.axes.get(axis, 1))

    def index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def coords_of(self, rank: int) -> dict:
        return coords_of(self.axes, rank)

    def rank_of(self, **coords) -> int:
        """The world rank at ``coords`` (axes left out: coordinate 0)."""
        return rank_of(self.axes, coords)

    def block_leads(self) -> list[int]:
        """Each worker's first rank (its fsdp, seq, pipe and model
        coordinates 0: under a pipe axis its first stage), in data order:
        the rank whose values stand for the worker."""
        return [self.rank_of(data=d) for d in range(self.size("data"))]

    def split_lines(self, axis: str,
                    timeout_s: float = GROUP_TIMEOUT_S) -> Group:
        """A second group of this rank's ``axis`` line, on a process group
        of its own (a collective of every process: each creates every
        line's group, in ``make_grid``'s order), so a sync on a host
        thread never interleaves its collectives with the main thread's
        on the line.  Closed with the grid."""
        line = _lines(self.axes, self.world, axis, timeout_s, self.coords)
        self._extra.append(line)
        return line

    def close(self) -> None:
        """Destroy the axis groups, the blocks' and the split lines' (the
        world group is the caller's)."""
        for g in (*self.groups.values(), *self._extra,
                  *([self.block] if self.block is not None else [])):
            dist.destroy_process_group(g.pg)
        self.groups, self._extra, self.block = {}, [], None


# the axes of a rank grid whose coordinates make up a worker's block
INNER = ("fsdp", "seq", "pipe", "expert", "model")


def coords_of(axes: dict, rank: int) -> dict:
    """World rank ``rank``'s row-major coordinates on the grid ``axes``."""
    out = {}
    for axis in reversed(list(axes)):
        rank, out[axis] = divmod(rank, int(axes[axis]))
    return {a: out[a] for a in axes}


def rank_of(axes: dict, coords: dict) -> int:
    """The world rank at ``coords`` on the grid ``axes`` (axes left out:
    coordinate 0)."""
    rank = 0
    for axis, size in axes.items():
        rank = rank * int(size) + int(coords.get(axis, 0))
    return rank


def inner_size(axes: dict) -> int:
    """The ranks of one worker's block: the product of the inner axes."""
    return world_size_of({a: s for a, s in axes.items() if a in INNER})


def inner_index(axes: dict, rank: int) -> int:
    """World rank ``rank``'s place in its worker's block: its inner
    coordinates row-major in the axes' order (the key of its rows at a
    membership boundary; the same for every worker)."""
    c = coords_of(axes, rank)
    return rank_of({a: s for a, s in axes.items() if a in INNER}, c)


def _lines(axes: dict, world: Group, axis: str | None, timeout_s: float,
           mine: dict) -> Group:
    """A gloo group for every line of ``axis`` (the ranks that differ only
    in that coordinate; ``axis`` None: the blocks, the ranks that share
    the data coordinate), created in the order of their first ranks (a
    collective of every process); returns this rank's ``Group`` (group
    rank = its place on the line)."""
    def line_of(c: dict) -> tuple:
        return (tuple(v for a, v in c.items() if a != axis) if axis
                else (c.get("slice", 0), c.get("data", 0)))
    lines: dict[tuple, list] = {}
    for r in range(world.world_size):
        lines.setdefault(line_of(coords_of(axes, r)), []).append(r)
    own = None
    for key, ranks in sorted(lines.items(), key=lambda kv: kv[1][0]):
        pg = dist.new_group(ranks, backend="gloo",
                            timeout=datetime.timedelta(seconds=timeout_s))
        if key == line_of(mine):
            own = Group(ranks.index(world.rank), len(ranks), world.device,
                        pg, ranks=tuple(ranks))
    return own


def make_grid(world: Group, axes: dict,
              timeout_s: float = GROUP_TIMEOUT_S) -> Grid:
    """The rank grid of ``axes`` over ``world`` (a collective: every rank
    creates every line's gloo group of every axis, in the same order: the
    axes in ``axes``' order, each line in the order of its first rank; a
    line of one rank too, so no collective falls back to the world)."""
    axes = {a: int(s) for a, s in axes.items()}
    size = 1
    for s in axes.values():
        size *= s
    if size != world.world_size:
        raise ValueError(
            f"mesh {axes} has {size} ranks but the group has "
            f"{world.world_size}")
    grid = Grid(axes, world, {}, {})
    grid.coords = grid.coords_of(world.rank)
    for axis in axes:
        grid.groups[axis] = _lines(axes, world, axis, timeout_s,
                                   grid.coords)
    if inner_size(axes) > 1:
        # the blocks last: a worker's verdicts (the chaos screen's) are
        # the AND over its ranks, which no one line holds under two inner
        # axes
        grid.block = _lines(axes, world, None, timeout_s, grid.coords)
    return grid


def grid_axes(cfg, processes: int = 1) -> dict:
    """``cfg``'s mesh axes with the data size resolved (data=-1: the
    ``--num_workers`` count, ``resolve_num_workers``; its 0, one worker
    per device, counts the devices of all ``processes`` of a launch).
    Under ``--num_slices S`` the ``slice`` axis leads: S x W worker
    processes, slice-major (JAX ``P((SLICE_AXIS, DATA_AXIS))``), W = the
    workers of one slice."""
    axes = dict(cfg.mesh_axes())
    if axes["data"] < 1:
        axes["data"] = resolve_num_workers(cfg.num_workers, cfg.device) * (
            processes if cfg.num_workers == 0 else 1)
    return {a: s for a, s in axes.items()
            if a in ("slice", "data", "fsdp", "seq", "pipe", "expert",
                     "model")}


def world_size_of(axes: dict) -> int:
    out = 1
    for s in axes.values():
        out *= int(s)
    return out


def all_gather(group: Group | None, obj) -> list:
    """``group.all_gather(obj)``, or ``[obj]`` without a group (one worker)."""
    return [obj] if group is None else group.all_gather(obj)


def resolve_num_workers(num_workers: int, device: str | None) -> int:
    """``--num_workers``: 0 means one worker per visible CUDA device (the
    JAX package's one per device), and one under ``--device cpu``."""
    if num_workers > 0:
        return num_workers
    if device == "cpu":
        return 1
    return max(torch.cuda.device_count(), 1)


def local_rank(store: str | Launch, rank: int) -> int:
    """Rank ``rank``'s place among its own process's ranks (its device
    and threads follow it): the rank itself in a single launch."""
    return (rank % store.ranks_per_process if isinstance(store, Launch)
            else rank)


def worker_device(rank: int, device: str | None) -> torch.device:
    """Local rank ``rank``'s device: ``cuda:{rank % device_count}`` (every
    rank on ``cuda:0`` on a one-card host), or the CPU when asked for;
    raises without a card unless the CPU was asked for."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port runs on the GPU unless "
            "the CPU is asked for (--device cpu / device='cpu')")
    return torch.device("cuda", rank % torch.cuda.device_count())


def join_store(store: str | Launch, rank: int, world_size: int,
               timeout_s: float = GROUP_TIMEOUT_S):
    """The ``torch.distributed`` store rank ``rank`` of a ``world_size``
    world meets at: the FileStore at ``store`` (a path), or under a
    launch the ``TCPStore`` on the coordinator's host:port (hosted by
    rank 0), returned once every rank of the world has arrived.  Raises
    after ``timeout_s``, naming the processes that did not arrive (or, off
    the coordinator, that it could not be reached): never hangs."""
    if not isinstance(store, Launch):
        return dist.FileStore(store, world_size)
    where = f"rendezvous at {store.address}"
    try:
        tcp = dist.TCPStore(store.host, store.port, world_size, rank == 0,
                            datetime.timedelta(seconds=timeout_s),
                            wait_for_workers=False)
    except RuntimeError as err:
        raise RuntimeError(
            f"{where}: rank {rank} (process {store.process_of(rank)}) could "
            f"not {'host' if rank == 0 else 'reach'} the coordinator's "
            f"store within {timeout_s:g} s: {err}") from None
    tcp.set(f"arrived/{rank}", "1")
    deadline = time.monotonic() + timeout_s
    missing = list(range(world_size))
    while True:
        missing = [r for r in missing if not tcp.check([f"arrived/{r}"])]
        if not missing:
            return tcp
        if time.monotonic() > deadline:
            procs = sorted({store.process_of(r) for r in missing})
            raise RuntimeError(
                f"{where}: process(es) {procs} of {store.num_processes} "
                f"(rank(s) {missing}) did not arrive within {timeout_s:g} s "
                f"(rank {rank} waited; {NUM_PROCESSES_ENV} is "
                f"{store.num_processes})")
        time.sleep(0.05)


def leave_store(store: str | Launch, tcp, rank: int, world_size: int,
                timeout_s: float = GROUP_TIMEOUT_S, ok: bool = True) -> None:
    """After rank ``rank`` destroyed its groups, under a launch: it says so
    on the coordinator's store, and rank 0, the store's host, first waits
    for every other rank's word (``timeout_s``; a few seconds when
    unwinding, ``ok`` False), so that no rank is still inside a collective
    or its group's teardown when the store goes.  A no-op in a single
    launch."""
    if not isinstance(store, Launch) or tcp is None:
        return
    if rank:
        try:
            tcp.set(f"left/{rank}", "1")
        except RuntimeError:
            pass             # the coordinator is gone: no one to tell
        return
    keys = [f"left/{r}" for r in range(1, world_size)]
    try:
        tcp.wait(keys, datetime.timedelta(seconds=timeout_s if ok else 5.0))
    except RuntimeError:
        gone = [k for k in keys if not tcp.check([k])]
        log.warning("rendezvous at %s: %s had not left their groups when "
                    "the coordinator's store closed", store.address, gone)


@contextlib.contextmanager
def init_group(rank: int, world_size: int, device: torch.device,
               store_path: str | Launch,
               timeout_s: float = GROUP_TIMEOUT_S) -> Iterator[Group]:
    """Join the gloo group through the store of ``store_path`` (a
    FileStore path, or a ``Launch``: ``join_store``); the group is
    destroyed on exit, also when the body raises."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = join_store(store_path, rank, world_size, timeout_s)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    ok = False
    try:
        yield Group(rank, world_size, device,
                    processes=_processes(store_path))
        ok = True
    finally:
        dist.destroy_process_group()
        leave_store(store_path, store, rank, world_size, timeout_s, ok)


def _processes(store: str | Launch) -> int:
    return store.num_processes if isinstance(store, Launch) else 1


class Membership:
    """One rank's view of an elastic worker group: the gloo group of the
    current roster, re-formed at each membership boundary.  Ranks are
    positions: after a boundary, position p of the new roster runs on rank
    p of a new group, met at a FileStore of its own (generation g of the
    base path), so the main process stays rank 0.  Under a launch the
    store is the coordinator's (``Launch``; generation 0: a launched world
    does not regroup).  On a rank grid the
    roster is of worker blocks: a process keeps its inner coordinates and
    its data coordinate is its position, so its world rank is where those
    coordinates sit on the grid of the new worker count.  ``spawn`` (rank
    0's) starts joiner processes: ``spawn(ranks, world_size, generation,
    snapshot_dir)``."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 store_path: str | Launch,
                 timeout_s: float = GROUP_TIMEOUT_S,
                 spawn: Callable | None = None, generation: int = 0):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.base = store_path
        self.timeout_s = timeout_s
        self.spawn = spawn
        self.generation = generation
        self.group: Group | None = None
        self._store = None

    def store(self, generation: int) -> str | Launch:
        if isinstance(self.base, Launch):
            if generation:
                raise RuntimeError(
                    "a launched world does not regroup (elastic runs are "
                    "refused under a launch)")
            return self.base
        return (self.base if generation == 0
                else f"{self.base}.g{generation}")

    def boundary_dir(self) -> str:
        """A directory shared by every rank for the current boundary's
        rows and snapshot (beside the FileStore)."""
        d = os.path.join(os.path.dirname(self.base),
                         f"boundary-{self.generation}")
        os.makedirs(d, exist_ok=True)
        return d

    def join(self) -> Group:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._store = join_store(self.store(self.generation), self.rank,
                                 self.world_size, self.timeout_s)
        dist.init_process_group(
            "gloo", store=self._store, rank=self.rank,
            world_size=self.world_size,
            timeout=datetime.timedelta(seconds=self.timeout_s))
        self.group = Group(self.rank, self.world_size, self.device,
                           processes=_processes(self.base))
        return self.group

    def leave(self, ok: bool = True) -> None:
        """Destroy the group (``ok`` False: while unwinding an error)."""
        if self.group is not None:
            self.group = None
            dist.destroy_process_group()
            leave_store(self.base, self._store, self.rank, self.world_size,
                        self.timeout_s, ok)
            self._store = None

    def regroup(self, n_workers: int, snapshot_dir: str,
                axes: dict | None = None) -> Group | None:
        """Leave the current group and join the next roster's, of
        ``n_workers`` workers (every rank calls it at the same boundary).
        ``axes``: the rank grid of the current roster (data first unless
        named later; None: one rank a worker).  Rank 0 spawns the ranks
        of the positions past the old roster (each a whole block); a rank
        whose position is past the new roster retires (None)."""
        old = dict(axes or {"data": self.world_size})
        new = {**old, "data": int(n_workers)}
        mine = coords_of(old, self.rank)
        self.leave()
        self.generation += 1
        self.world_size = world_size_of(new)
        if self.rank == 0 and n_workers > old["data"]:
            if self.spawn is None:
                raise RuntimeError(
                    "a join needs rank 0's spawner (driver.run_group)")
            self.spawn([r for r in range(self.world_size)
                        if coords_of(new, r)["data"] >= old["data"]],
                       self.world_size, self.generation, snapshot_dir)
        if mine["data"] >= n_workers:
            return None
        self.rank = rank_of(new, mine)
        return self.join()


def new_store_path() -> str:
    """A FileStore path in a fresh temporary directory; the caller removes
    the directory (``remove_store``) when every rank is done."""
    return os.path.join(tempfile.mkdtemp(prefix="torch-group-"), "store")


def remove_store(store_path: str) -> None:
    shutil.rmtree(os.path.dirname(store_path), ignore_errors=True)


def rank_threads(world_size: int) -> int:
    """Intra-op threads of one rank: an equal share of the caller's
    (``torch.get_num_threads()``, one per core unless the caller set
    fewer), so N CPU ranks do not oversubscribe the host (under a launch
    N is the ranks of one process, its host's)."""
    return max(1, torch.get_num_threads() // world_size)


def _bootstrap(target: Callable, rank: int, world_size: int, threads: int,
               args: tuple) -> None:
    """A spawned rank: its share of the threads, then ``target``."""
    torch.set_num_threads(threads)
    target(rank, world_size, *args)


def spawn_workers(target: Callable, world_size: int, args: tuple = (),
                  ranks: Sequence[int] | None = None,
                  threads: int | None = None) -> list:
    """Start ``target(rank, world_size, *args)`` in a fresh ``spawn``
    process for each of ``ranks`` (default 1..world_size-1: rank 0 runs in
    the caller), each with ``threads`` intra-op threads (default
    ``rank_threads(world_size)``).  ``target`` must be a module-level
    function of the port."""
    ctx = torch.multiprocessing.get_context("spawn")
    threads = rank_threads(world_size) if threads is None else threads
    procs = []
    for rank in (range(1, world_size) if ranks is None else ranks):
        p = ctx.Process(target=_bootstrap,
                        args=(target, rank, world_size, threads, args),
                        name=f"worker-{rank}")
        p.start()
        procs.append(p)
    return procs


def join_workers(procs: list, timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Wait for every child; raise if one exited with a code other than 0
    or was still running after ``timeout_s`` (it is then terminated)."""
    failed = stop_workers(procs, wait_s=timeout_s)
    hung = [p.name for p in procs if p.name not in failed and p.exitcode]
    if failed or hung:
        raise RuntimeError(
            f"worker process(es) failed: exit codes {failed}"
            + (f"; terminated after {timeout_s} s: {hung}" if hung else ""))


def stop_workers(procs: list, wait_s: float = 0.0) -> dict[str, int]:
    """Give each child ``wait_s`` to exit, then terminate any still
    running (its group is lost).  Returns the exit codes of the children
    that exited on their own with a code other than 0."""
    for p in procs:
        p.join(wait_s)
    failed = {p.name: p.exitcode for p in procs
              if p.exitcode is not None and p.exitcode != 0}
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)
    return failed
