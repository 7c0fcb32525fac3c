"""The port's launched mode on the CPU (JAX ``mesh.initialize_distributed``
and tests/test_multihost.py): independently started OS processes, each
told the coordinator, the process count and its id by JAX's three
variables, join one gloo world at a ``TCPStore`` and run the driver
(tests/_torch_multihost_worker.py; one intra-op thread a rank).

(a) JAX's worker config (mlp on mnist, 2 rounds) at data=4 over 2
    processes x 2 ranks, one checkpoint directory shared, a save a round:
    both processes see the same metrics bitwise; the run is bitwise its
    single-launch twin (``driver.run_group``); the step caps and shard
    sizes are the JAX driver's on 4 virtual devices and the losses agree
    within rtol 2e-4 from JAX's init; the manifest's 4 shards restore
    bitwise to every rank's final row.
(b) gpt_tiny at data=2,model=2 over 2 processes x 2 ranks (a worker block
    a process), a checkpoint directory a process: bitwise its twin; each
    directory holds its own ranks' shards and a manifest of all four.
(c) The refusals (--sim_workers, a worker count the processes do not
    divide, --chaos), with JAX's messages, before any rendezvous.
(d) A process 0 whose peer never starts raises within seconds, naming
    the rendezvous and the missing process.

Also: JAX's variables read as JAX reads them; ``main.run`` evaluating and
plotting on process 0 only.

And the commit window: with 2 ranks and --checkpoint_every 2, a save is
manifested, and ``latest_checkpoint`` finds it, before the next save.
"""

import functools
import json
import operator
import os
import pickle
import socket
import subprocess
import sys
import time

import _torch_multihost_worker as mh
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.driver import (
    train_global as j_train_global,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.train import (
    LocalSGDEngine as JEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as C,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    main as t_main,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_multihost_worker.py")
RTOL = 2e-4
BITWISE = ("global_train_losses", "global_val_losses", "all_workers_losses",
           "step_caps", "shard_sizes", "param_checksums")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(case: str, tmp, ckpt_dirs: list, out: str = "",
            init: str = "") -> list:
    """Start the two processes of ``case`` (process p saving into
    ``ckpt_dirs[p]``, its output into files under ``tmp``); the three
    variables are set in their environments only, never in this process
    (whose JAX must not see them)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(2):
        logs = (tmp / f"process{pid}.out", tmp / f"process{pid}.err")
        with open(logs[0], "w") as stdout, open(logs[1], "w") as stderr:
            procs.append((subprocess.Popen(
                [sys.executable, WORKER], env=dict(
                    env, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                    MH_CASE=case, MH_CKPT_DIR=str(ckpt_dirs[pid]),
                    MH_OUT=out, MH_INIT=init),
                stdout=stdout, stderr=stderr, start_new_session=True),
                logs))
    return procs


def _results(procs: list) -> dict:
    """Each process's MHRESULT line, by process id (both must exit 0; a
    process still running after 240 s is killed with the ranks it
    spawned)."""
    deadline = time.monotonic() + 240
    try:
        for p, _logs in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail("a launched process timed out")
    finally:
        for p, _logs in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    out = {}
    for p, (stdout, stderr) in procs:
        assert p.returncode == 0, \
            f"launched process failed:\n{stderr.read_text()[-3000:]}"
        line = [ln for ln in stdout.read_text().splitlines()
                if ln.startswith("MHRESULT ")]
        assert line, stdout.read_text()[-2000:]
        r = json.loads(line[-1][len("MHRESULT "):])
        out[r["process"]] = r
    assert sorted(out) == [0, 1]
    return out


def _jax_init(cfg: JConfig) -> dict:
    """JAX's seeded init of the mlp (row 0 of its engine's tiled state) in
    the port's layout, as host arrays."""
    eng = JEngine(j_get_model("mlp", num_classes=10),
                  build_mesh({"data": 1}, jax.devices()[:1]), cfg)
    state = eng.init_state(jax.random.key(cfg.seed),
                           np.zeros((cfg.batch_size, 28, 28, 1), np.float32))
    params = jax.tree.map(lambda a: np.asarray(a)[0], state.params)
    return {k: np.asarray(v) for k, v in
            weights.cnn_flax_to_torch({"params": params}).items()}


@pytest.fixture(scope="module")
def flat(tmp_path_factory, devices):
    """(a): the launched run (two processes), its single-launch twin and
    the JAX driver's run, all from JAX's init with the probe and the
    walls pinned."""
    tmp = tmp_path_factory.mktemp("flat")
    jcfg = JConfig(**mh.FLAT, time_limit=mh.TIME_LIMIT["flat"])
    init = _jax_init(jcfg)
    init_path = tmp / "init.pkl"
    init_path.write_bytes(pickle.dumps(init))
    (tmp / "rows").mkdir()
    ckpt = tmp / "ckpt"
    procs = _launch("flat", tmp, [ckpt, ckpt], str(tmp / "rows"),
                    str(init_path))
    twin = t_driver.run_group(mh.config("flat"), 4,
                              train_kwargs=mh.train_kwargs("flat", init))
    jax_res = j_train_global(
        jcfg, mesh=build_mesh({"data": 4}, devices[:4]),
        simulated_durations=mh.PROBE["flat"],
        simulated_round_durations=functools.partial(operator.getitem,
                                                    mh.WALLS["flat"]),
        progress=False)
    return dict(runs=_results(procs), twin=twin, jax=jax_res, dir=tmp)


def test_flat_processes_see_the_same_metrics(flat):
    """Both processes' first ranks return the same global metric lists,
    bit for bit, over a world of 4 ranks laid out process-major, in the
    serial round flow; the measured walls are per rank, gathered."""
    a, b = flat["runs"][0], flat["runs"][1]
    for key in BITWISE + ("workers_wall_s",):
        assert a[key] == b[key], key
    assert a["launch"]["ranks"] == [0, 1] and b["launch"]["ranks"] == [2, 3]
    assert a["launch"]["world_size"] == 4
    assert a["round_flow"] == b["round_flow"] == "serial"
    walls = np.asarray(a["workers_wall_s"])
    assert walls.shape == (2, 4) and (walls > 0).all()
    losses = a["global_train_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_flat_launch_is_bitwise_its_single_launch_twin(flat):
    """The launched world computes what the same 4 ranks started by one
    process compute: losses, validation losses, per-worker losses, step
    caps, shard sizes and every rank's parameter checksum, bit for bit."""
    run, twin = flat["runs"][0], flat["twin"]
    for key in BITWISE:
        assert run[key] == json.loads(json.dumps(twin[key])), key
    assert twin["round_flow"] == "overlapped"


def test_flat_launch_matches_the_jax_driver(flat):
    """The JAX driver's step caps and shard sizes on 4 virtual devices,
    and its losses within rtol 2e-4 from the same initial parameters."""
    run, jres = flat["runs"][0], flat["jax"]
    assert run["step_caps"] == jres["step_caps"]
    assert run["shard_sizes"] == jres["shard_sizes"]
    caps, sizes = np.asarray(run["step_caps"]), np.asarray(run["shard_sizes"])
    assert (caps < np.ceil(sizes / mh.FLAT["batch_size"])).any(), \
        "the caps never bound"
    for key in ("global_train_losses", "global_val_losses"):
        np.testing.assert_allclose(run[key], jres[key], rtol=RTOL,
                                   err_msg=key)


def test_flat_checkpoint_restores_every_rank_bitwise(flat):
    """The shared directory's last manifest lists the 4 shards the 4 ranks
    of both processes wrote, and they merge into every rank's final row,
    bit for bit; ``latest_checkpoint`` finds that epoch."""
    d = str(flat["dir"] / "ckpt")
    latest = C.latest_checkpoint(d)
    assert latest == os.path.join(d, "ckpt_2")
    manifest = C.read_manifest(latest)
    assert manifest["process_count"] == 4
    assert sorted(manifest["shards"]) == [f"shard_{r}.msgpack"
                                          for r in range(4)]
    tree, epoch = C.host_tree(latest)
    assert epoch == 2
    for rank in range(4):
        with open(flat["dir"] / "rows" / f"rank{rank}.pkl", "rb") as f:
            row = pickle.load(f)
        assert sorted(row) == sorted(tree), rank
        for key, want in row.items():
            np.testing.assert_array_equal(tree[key][rank], want,
                                          err_msg=f"rank {rank}: {key}")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(b): the grid launched over 2 processes, a checkpoint directory
    each, and its single-launch twin."""
    tmp = tmp_path_factory.mktemp("grid")
    dirs = [tmp / "ckpt0", tmp / "ckpt1"]
    procs = _launch("grid", tmp, dirs)
    twin = t_driver.run_group(mh.config("grid"), 4,
                              train_kwargs=mh.train_kwargs("grid"))
    return dict(runs=_results(procs), twin=twin, dirs=dirs)


def test_grid_launch_is_bitwise_its_twin(grid):
    """Each process holds one whole worker block (data coordinate p, both
    model ranks); the run is the twin's bit for bit on both processes."""
    for pid, run in grid["runs"].items():
        assert run["grid"]["axes"] == {"data": 2, "model": 2}
        assert run["grid"]["coords"] == {"data": pid, "model": 0}
        assert run["launch"]["ranks"] == [2 * pid, 2 * pid + 1]
        for key in BITWISE:
            assert run[key] == json.loads(json.dumps(grid["twin"][key])), \
                (pid, key)


def test_grid_per_host_directories(grid):
    """A directory a process (as on hosts without a shared filesystem):
    each holds its own ranks' shards of every epoch and a manifest that
    lists all four, as JAX's test asserts of its per-process
    directories."""
    for pid, d in enumerate(grid["dirs"]):
        epochs = sorted(os.listdir(d))
        assert epochs == ["ckpt_1", "ckpt_2"], epochs
        for e in epochs:
            files = sorted(os.listdir(d / e))
            assert files == ["MANIFEST.json", f"shard_{2 * pid}.msgpack",
                             f"shard_{2 * pid + 1}.msgpack"], files
            manifest = C.read_manifest(str(d / e))
            assert sorted(manifest["shards"]) == [f"shard_{r}.msgpack"
                                                  for r in range(4)]


REFUSALS = {
    "sim_workers": (["--sim_workers", "4"], NotImplementedError,
                    "--sim_workers is single-process by construction"),
    "indivisible": (["--num_workers", "3"], ValueError,
                    r"worker axis \(3\) must be divisible by the process "
                    r"count \(2\)"),
    "chaos": (["--num_workers", "4", "--chaos", "kill@1:w1"],
              NotImplementedError, "elastic membership / --chaos"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_before_any_rendezvous(tmp_path, monkeypatch, case):
    """Each refusal raises with JAX's message before any rank is spawned
    or any store is joined."""
    extra, exc, msg = REFUSALS[case]
    monkeypatch.setenv(mesh.COORDINATOR_ENV, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(mesh.NUM_PROCESSES_ENV, "2")
    monkeypatch.setenv(mesh.PROCESS_ID_ENV, "0")

    def reached(*a, **k):
        raise AssertionError("the refusal came after a rendezvous")

    monkeypatch.setattr(mesh, "join_store", reached)
    monkeypatch.setattr(mesh, "spawn_workers", reached)
    with pytest.raises(exc, match=msg):
        t_main.run(["--device", "cpu", "--model", "mlp", "--dataset",
                    "mnist", "--out_dir", str(tmp_path), *extra])
    assert not dist.is_initialized()


@pytest.mark.parametrize("pid", [0, 1])
def test_only_process_0_evaluates_and_plots(monkeypatch, pid):
    """``main.run`` under a launch runs ``driver.run_launched`` and, on
    process 0 only, the test evaluation and the six plots (JAX
    main.py:46); every process returns the run's results."""
    monkeypatch.setenv(mesh.COORDINATOR_ENV, "127.0.0.1:1234")
    monkeypatch.setenv(mesh.NUM_PROCESSES_ENV, "2")
    monkeypatch.setenv(mesh.PROCESS_ID_ENV, str(pid))
    calls = []
    monkeypatch.setattr(t_driver, "run_launched",
                        lambda cfg, **kw: calls.append(("run", kw["launch"]))
                        or {"global_train_losses": [1.0]})
    monkeypatch.setattr(t_main, "_finish", lambda cfg, res: calls.append(
        ("finish",)) or dict(res, test_eval={}))
    res = t_main.run(["--device", "cpu", "--model", "mlp", "--dataset",
                      "mnist", "--num_workers", "2"])
    assert calls[0] == ("run", mesh.Launch("127.0.0.1:1234", 2, pid))
    assert (("finish",) in calls) == (pid == 0)
    assert res["global_train_losses"] == [1.0]
    assert ("test_eval" in res) == (pid == 0)


def test_launch_variables_are_read_as_jax_reads_them():
    """Unset: no launch (the single-launch path); set: JAX's meaning; a
    coordinator without the count or the id is refused."""
    assert mesh.launch_from_env({}) is None
    launch = mesh.launch_from_env({mesh.COORDINATOR_ENV: "10.0.0.1:1234",
                                   mesh.NUM_PROCESSES_ENV: "4",
                                   mesh.PROCESS_ID_ENV: "3"})
    launch = launch.with_world(8)
    assert (launch.host, launch.port, launch.process_id) == ("10.0.0.1",
                                                             1234, 3)
    assert list(launch.ranks) == [6, 7] and launch.process_of(5) == 2
    assert mesh.local_rank(launch, 7) == 1 and mesh.local_rank("p", 7) == 7
    with pytest.raises(ValueError, match=mesh.PROCESS_ID_ENV):
        mesh.launch_from_env({mesh.COORDINATOR_ENV: "10.0.0.1:1234",
                              mesh.NUM_PROCESSES_ENV: "2"})
    # --num_workers 0 (one worker a device) counts every process's
    # devices, as JAX's data axis spans every host's; an inner axis
    # multiplies the ranks
    two = mesh.Launch("10.0.0.1:1234", 2, 0)
    assert t_driver.check_launch(Config(device="cpu"), two) == 2
    assert t_driver.check_launch(
        Config(device="cpu", model="gpt_tiny", mesh_shape="data=2,model=2"),
        two) == 4


def test_missing_peer_raises_naming_the_rendezvous():
    """A lone process 0 of 2: its rank hosts the store, waits out the
    timeout and raises, naming the coordinator and process 1; no group is
    left behind."""
    address = f"127.0.0.1:{_free_port()}"
    cfg = Config(device="cpu", model="mlp", dataset="mnist", num_workers=2,
                 limit_train_samples=64, limit_eval_samples=16)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=(
            rf"rendezvous at {address}: process\(es\) \[1\] of 2")):
        t_driver.run_launched(cfg, launch=mesh.Launch(address, 2, 0),
                              timeout_s=3.0)
    assert time.perf_counter() - t0 < 30.0
    assert not dist.is_initialized()


def test_a_save_is_manifested_before_the_next(tmp_path, monkeypatch):
    """Two ranks, a save every 2 rounds: by the time rank 0 saves epoch 4,
    the epoch-2 save is committed (its manifest published within one
    round, JAX driver.py:1764-1776), so ``latest_checkpoint`` finds it; a
    commit deferred to the next save would leave it unrestorable for 2
    rounds."""
    d = str(tmp_path / "ckpt")
    seen = []
    real_save = C.CheckpointEngine.save

    def spy(self, state, global_epoch, timing=None):
        seen.append((int(global_epoch), C.committed_epochs(d),
                     C.latest_checkpoint(d)))
        return real_save(self, state, global_epoch, timing)

    monkeypatch.setattr(C.CheckpointEngine, "save", spy)
    cfg = Config(device="cpu", model="mlp", dataset="mnist", num_workers=2,
                 epochs_global=4, epochs_local=1, batch_size=16,
                 limit_train_samples=128, limit_eval_samples=16,
                 compute_dtype="float32", aggregation_by="weights",
                 checkpoint_dir=d, checkpoint_every=2, log_level="WARNING")
    res = t_driver.run_group(cfg, 2, train_kwargs=dict(
        simulated_durations=[1.0, 1.0], progress=False))
    assert [s[0] for s in seen] == [2, 4]
    assert seen[1][1] == [2]
    assert seen[1][2] == os.path.join(d, "ckpt_2")
    assert C.committed_epochs(d) == [2, 4]
    assert res["checkpoint"]["saves"] == 2
