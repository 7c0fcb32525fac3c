"""The port's N-worker driver on the CPU: the paper's 2x3 matrix
(balanced | disbalanced x allreduce | ring | double_ring) through
``main.run --num_workers 2`` (two gloo processes), the straggler feedback
held against the JAX driver on 2 workers, the progress bars, and the
failure paths (a failing child, no group at one worker), and
``--backend nccl`` as the no-op JAX takes it."""

import functools
import json
import math
import operator
import sys

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
    eval as t_eval,
    main as t_main,
    mesh,
    viz as t_viz,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config as TConfig,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

PLOTS = ("training_metrics", "training_metrics_0",
         "loss_distribution_by_worker", "loss_distribution_per_epoch",
         "loss_distribution_per_epoch_global",
         "accuracy_distribution_per_epoch_global")


def _argv(out_dir, *extra):
    return ["--device", "cpu", "--num_workers", "2", "--model", "mlp",
            "--dataset", "mnist", "--epochs_global", "2", "--epochs_local",
            "1", "--batch_size", "16", "--limit_train_samples", "200",
            "--limit_eval_samples", "32", "--probe_batches", "1",
            "--compute_dtype", "float32", "--aggregation_by", "weights",
            "--log_level", "warning", "--out_dir", str(out_dir), *extra]


@pytest.mark.parametrize("topology", ["allreduce", "ring", "double_ring"])
@pytest.mark.parametrize("data_mode", ["balanced", "disbalanced"])
def test_paper_matrix_on_two_workers(tmp_path, monkeypatch, data_mode,
                                     topology):
    """Two rounds on two worker processes: a loss list per worker, the
    balanced round-0 shards disjoint, one partition and one init on both
    ranks (the driver's checksums), a finite test evaluation and the six
    plots; after an equal all-reduce both ranks hold the same bits."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    how = "equal" if data_mode == "balanced" else "weighted"
    results = t_main.run(_argv(tmp_path, "--data_mode", data_mode,
                               "--topology", topology,
                               "--aggregation_type", how,
                               "--local_weight", "0.7"))
    assert len(results["all_workers_losses"]) == 2
    assert all(len(w) > 0 and all(math.isfinite(x) for x in w)
               for w in results["all_workers_losses"])
    assert len(results["global_train_losses"]) == 2
    shards = results["initial_train_shards"]
    assert len(shards) == 2 and all(len(s) for s in shards)
    if data_mode == "balanced":
        assert not np.intersect1d(*shards).size
    assert [len(s) for s in results["shard_sizes"]] == [2, 2]
    sums = results["param_checksums"]
    assert len(sums) == 2
    if how == "equal" and topology == "allreduce":
        assert sums[0] == sums[1]
    if how == "weighted":       # each worker keeps 0.7 of its own value
        assert sums[0] != sums[1]
    rt = results["round_timings"][-1]
    assert len(rt["workers_train_steps"]) == 2 and rt["sync_bytes"] > 0
    ev = results["test_eval"]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 100.0
    for name in PLOTS:
        assert json.loads((tmp_path / f"{name}.json").read_text())


def _ema_cfg(**over):
    return dict(model="mlp", dataset="mnist", epochs_global=3,
                epochs_local=2, batch_size=8, limit_train_samples=400,
                limit_eval_samples=16, lr=1e-3, compute_dtype="float32",
                aggregation_by="weights", time_limit=1.2, **over)


@pytest.mark.parametrize("data_mode", ["balanced", "disbalanced"])
def test_straggler_feedback_matches_jax_driver(devices, tmp_path, data_mode):
    """Pinned probe durations and walls on 2 workers, with a time_limit
    that caps the steps: the port's driver picks the same step caps and
    shard sizes as the JAX driver in all 3 rounds."""
    sims = [2.0, 0.5]                 # probe: 0.2 and 0.05 s/batch
    walls = [[0.8, 0.4], [2.4, 0.2], [0.6, 0.6]]
    walls_fn = functools.partial(operator.getitem, walls)
    j_res = j_train_global(
        JConfig(**_ema_cfg(data_mode=data_mode)),
        mesh=build_mesh({"data": 2}, devices[:2]), simulated_durations=sims,
        simulated_round_durations=walls_fn, progress=False)
    cfg = TConfig(device="cpu", **_ema_cfg(data_mode=data_mode))
    kw = dict(simulated_durations=sims, simulated_round_durations=walls_fn,
              progress=False)
    store = mesh.new_store_path()
    procs = mesh.spawn_workers(t_driver.train_rank, 2,
                               (store, 60.0, cfg, kw))
    try:     # rank 0 here; the driver checks that both ranks agree
        res = t_driver.train_rank(0, 2, store, 60.0, cfg, kw)
        mesh.join_workers(procs, timeout_s=60.0)
    finally:
        mesh.stop_workers(procs)
        mesh.remove_store(store)
    assert res["step_caps"] == j_res["step_caps"]
    assert res["shard_sizes"] == j_res["shard_sizes"]
    caps = np.asarray(res["step_caps"])
    sizes = np.asarray(res["shard_sizes"])
    assert (caps < np.ceil(sizes / 8)).any(), "the caps never bound"


def test_measured_walls_are_divided_by_epochs_local(monkeypatch):
    """A round of E local epochs feeds wall / E per pass into the
    sec/batch EMA (JAX driver.py:1240-1241).  Probe: 0.1 s/batch, a time
    limit of 0.8 s caps the 16-batch shard at 8; every round reports a
    1.6 s wall over 2 local epochs of 8 steps, i.e. 0.1 s/batch again, so
    the cap stays 8 (an undivided wall would make it 5 from round 2)."""
    assert list(t_driver.measured_worker_walls([2.0, 4.0], 4)) == [0.5, 1.0]
    # the driver reads a round's walls from its metrics (finish_metrics)
    real_finish = t_driver.LocalSGDEngine.finish_metrics

    def pinned_finish(self, handle):
        mx = real_finish(self, handle)
        mx["workers_wall_s"] = [1.6]
        return mx

    monkeypatch.setattr(t_driver.LocalSGDEngine, "finish_metrics",
                        pinned_finish)
    cfg = TConfig(device="cpu", **{**_ema_cfg(), "limit_train_samples": 160,
                                   "time_limit": 0.8})
    res = t_driver.train_global(cfg, simulated_durations=[1.0],
                                progress=False)
    assert res["shard_sizes"] == [[128]] * 3
    assert res["step_caps"] == [[8]] * 3


def _one_worker_cfg():
    return TConfig(device="cpu", **{**_ema_cfg(), "epochs_global": 1,
                                    "epochs_local": 1, "time_limit": 60.0})


def test_progress_bars_with_tqdm(capsys):
    """Rank 0 draws the "Global Epochs" bar (stderr) with the report lines
    written through it (stdout), and evaluate the "Testing" bar."""
    res = t_driver.train_global(_one_worker_cfg(), simulated_durations=[1.0])
    test = res["test"]
    t_eval.evaluate(res["model"], res["variables"], test.images,
                    test.labels, 8)
    out, err = capsys.readouterr()
    assert "Global Epochs" in err and "Testing" in err
    assert "loss=" in err and "wall=" in err            # the postfix
    assert "Rank 0, Global Epoch 1, Local Epoch 1, Loss:" in out
    assert "Worker 0, Global Epoch 1, Validation Loss:" in out
    assert "Global Epoch 1/1:" not in out
    assert "Worker 0, Test Loss:" in out


def test_progress_lines_without_tqdm(capsys, monkeypatch):
    """Without tqdm the fallback lines stay as they were."""
    monkeypatch.setitem(sys.modules, "tqdm", None)
    res = t_driver.train_global(_one_worker_cfg(), simulated_durations=[1.0])
    test = res["test"]
    t_eval.evaluate(res["model"], res["variables"], test.images,
                    test.labels, 8)
    out, err = capsys.readouterr()
    assert "Global Epochs" not in err and "Testing" not in err
    assert "Rank 0, Global Epoch 1, Local Epoch 1, Loss:" in out
    assert "Global Epoch 1/1: loss=" in out
    assert "Worker 0, Test Loss:" in out


def test_a_failing_child_makes_main_run_raise(tmp_path, monkeypatch):
    """The children cannot load their data (an unknown dataset; rank 0
    here loads mnist in its place): rank 0's collective fails, the run
    raises naming the child's exit code, and no child is left running."""
    real_load = t_driver.load_dataset
    monkeypatch.setattr(t_driver, "load_dataset",
                        lambda name, *a, **k: real_load("mnist", *a, **k))
    monkeypatch.setattr(mesh, "GROUP_TIMEOUT_S", 20.0)
    argv = _argv(tmp_path)
    argv[argv.index("mnist")] = "no_such_dataset"
    with pytest.raises(RuntimeError, match="exit codes"):
        t_main.run(argv)
    assert not dist.is_initialized()
    assert not any(tmp_path.iterdir())


def test_one_worker_creates_no_group(tmp_path, monkeypatch):
    monkeypatch.setattr(t_viz, "_plt", lambda: None)

    def refuse(*a, **k):
        raise AssertionError("a one-worker run must not create a group")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    argv = _argv(tmp_path)
    argv[argv.index("--num_workers") + 1] = "0"    # one per device: 1 here
    results = t_main.run(argv)
    assert len(results["all_workers_losses"]) == 1
    assert "param_checksums" not in results


def test_backend_nccl_raises_and_compat_backends_run(tmp_path, monkeypatch):
    """Every --backend is a no-op, as in JAX (config.py:1243-1245): nccl
    runs the two workers as the same gloo group, with gloo's results to
    the bit (uniform shares: the measured probe sizes no shard)."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    runs = {b: t_main.run(_argv(tmp_path / b, "--backend", b,
                                "--proportionality", "uniform"))
            for b in ("gloo", "nccl")}
    for key in ("param_checksums", "global_train_losses",
                "global_val_losses", "all_workers_losses", "shard_sizes"):
        assert runs["nccl"][key] == runs["gloo"][key], key
    for backend in ("jax", "gloo", "nccl", "mpi"):
        assert TConfig(backend=backend, num_workers=2).backend == backend


def test_train_global_without_a_group_refuses_several_workers():
    with pytest.raises(ValueError, match="train_global runs one rank"):
        t_driver.train_global(TConfig(device="cpu", num_workers=2,
                                      **_ema_cfg()))
