"""The hierarchical sync through the port's driver (``--num_slices 2
--num_workers 2``: 4 gloo processes on the CPU), and the shared start that
runs several launch lines from one start of their ranks
(``main.run_shared``, ``driver.SharedStart``).

The runs (JAX ``tests/test_hier_sync.py::TestHierDriverMatrix``): equal and
weighted over the ring and the double ring, the int8 outer wire with error
feedback, a checkpoint a round and its resume, and a streamed twin of a
packed run, each with the probe and the walls pinned so that twins train
the same shards.  Checked: the engine and its per-level bytes
(``hier_wire_bytes``), the workers of each slice bitwise equal after every
round, the checkpoint restored bitwise into rank 0's template and merged by
JAX's ``host_tree``, the resume training only the remaining round, the
streamed run bitwise the packed one."""

import functools
import json
import operator
import os

import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    checkpoint as j_ckpt,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as t_ckpt,
    comms,
    driver as t_driver,
    main as t_main,
    sync_harness,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

N, SLICES = 4, 2
WALLS = [[1.0 + 0.1 * w for w in range(N)] for _ in range(3)]
BASE = ["--device", "cpu", "--model", "mlp", "--dataset", "mnist",
        "--num_slices", str(SLICES), "--num_workers", str(N // SLICES),
        "--aggregation_by", "weights", "--epochs_local", "1",
        "--batch_size", "16", "--limit_train_samples", "320",
        "--limit_eval_samples", "64", "--compute_dtype", "float32",
        "--sync_bucket_mb", "0.05", "--log_level", "warning"]
KW = dict(simulated_durations=[1.0] * N, progress=False,
          simulated_round_durations=functools.partial(operator.getitem,
                                                      WALLS),
          round_checksums=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> rank 0's results of each run, all from ONE start of the 4
    ranks (the gloo probe's job among them)."""
    d = tmp_path_factory.mktemp("hier_driver")
    ck = str(d / "ck")
    lines = {
        "ef": [*BASE, "--topology", "ring", "--epochs_global", "2",
               "--sync_dtype_outer", "int8", "--sync_compression", "ef",
               "--checkpoint_dir", ck, "--checkpoint_every", "1"],
        "resume": [*BASE, "--topology", "ring", "--epochs_global", "3",
                   "--sync_dtype_outer", "int8", "--sync_compression", "ef",
                   "--checkpoint_dir", ck, "--checkpoint_every", "1",
                   "--resume"],
        "weighted": [*BASE, "--topology", "double_ring", "--epochs_global",
                     "2", "--aggregation_type", "weighted",
                     "--local_weight", "0.4"],
        "packed": [*BASE, "--topology", "ring", "--epochs_global", "2"],
        "streamed": [*BASE, "--topology", "ring", "--epochs_global", "2",
                     "--stream_chunk_steps", "2"],
    }
    jobs = [(sync_harness.gloo_probe_worker, (str(d), 60.0))]
    jobs += [([*argv, "--out_dir", str(d / name)], KW)
             for name, argv in lines.items()]
    out = {}
    with t_main.run_shared(jobs) as run:
        assert run() is None                  # the probe's job
        for name in lines:
            out[name] = run()
    out["probe"] = [json.load(open(d / f"gloo{r}.json")) for r in range(N)]
    out["ckpt_dir"] = ck
    return out


def test_engine_and_bytes_per_level(runs):
    """mode ``hier`` over 2 slices, the sharded engine inside each and the
    gossip across; every round's ICI/DCN bytes ``hier_wire_bytes`` (the
    int8 outer wire a quarter of fp32's DCN, ICI as it was), and its sync
    wall attributed to the levels in proportion to them."""
    for name, outer in (("ef", torch.int8), ("packed", None),
                        ("weighted", None)):
        res = runs[name]
        eng = res["sync_engine"]
        assert (eng["mode"], eng["num_slices"]) == ("hier", SLICES)
        assert eng["levels"] == {"inner": "sharded", "outer": "gossip"}
        leaves, _p = weights.wire_layout(res["model"])
        topology = "double_ring" if name == "weighted" else "ring"
        want = comms.hier_wire_bytes(
            leaves, N // SLICES, topology=topology, outer_wire_dtype=outer,
            bucket_bytes=int(0.05 * 2 ** 20))
        assert (eng["sync_bytes_ici"], eng["sync_bytes_dcn"]) == (
            want["ici"], want["dcn"])
        for r in res["round_timings"]:
            assert (r["sync_bytes_ici"], r["sync_bytes_dcn"]) == (
                want["ici"], want["dcn"])
            assert r["sync_ms_ici"] + r["sync_ms_dcn"] == pytest.approx(
                r["sync_ms"], abs=2e-3)
        # W = 2 fp32 ring: ICI is exactly twice the DCN (JAX's invariant)
        if name == "packed":
            assert eng["sync_bytes_ici"] == 2 * eng["sync_bytes_dcn"]
        if name == "ef":
            assert eng["sync_bytes_ici"] == 8 * eng["sync_bytes_dcn"]
    assert runs["ef"]["sync_engine"]["param_residency"] == "resident"
    assert runs["weighted"]["sync_engine"]["param_residency"] == "replicated"
    state = runs["ef"]["sync_engine"]["per_worker_state_bytes"]
    assert state["params"] * 2 == state["params_gathered_peak"]
    assert state["ef_residual_outer"] == state["params"] > 0


@pytest.mark.parametrize("name", ["ef", "weighted", "packed"])
def test_slices_workers_bitwise_equal_after_every_round(runs, name):
    """The equal blend leaves one consensus per slice: the workers of a
    slice hold the same bits after every round (the weighted blend keeps
    every worker's own term, so its workers differ); every value finite
    and the loss falls."""
    res = runs[name]
    sums = res["round_checksums"]
    assert len(sums) == len(res["round_timings"])
    w = N // SLICES
    for row in sums:
        for g in range(SLICES):
            if name != "weighted":
                assert len(set(row[g * w:(g + 1) * w])) == 1, row
    assert np.isfinite(res["global_train_losses"]).all()
    assert np.isfinite(res["global_val_losses"]).all()
    assert res["global_train_losses"][-1] < res["global_train_losses"][0]
    assert res["test_eval"]["accuracy"] >= 0


def test_checkpoint_roundtrip_and_jax_merge(runs):
    """The 2 x 2 run's last checkpoint (4 shards, one manifest recording
    the slices) restores into rank 0's template bit for bit: the resident
    rows and the outer residual; JAX's ``host_tree`` merges the same leaves
    as the port's, outer residual rows included."""
    res = runs["ef"]
    path = os.path.join(runs["ckpt_dir"], "ckpt_2")
    assert t_ckpt.manifest_metadata(path)["num_slices"] == SLICES
    mine, epoch = t_ckpt.host_tree(path)
    theirs, _ = j_ckpt.host_tree(path)
    assert epoch == 2 and set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert any(k.startswith(".sync_residual_outer") for k in mine)
    model, st = res["model"], res["state"]
    named = list(model.named_parameters())
    names = [k for k, _p in named]
    template = t_ckpt.WorkerState(
        params={}, buffers=dict(model.named_buffers()),
        mu=dict(zip(names, st.opt.mu)), nu=dict(zip(names, st.opt.nu)),
        count=st.opt.count, lr_epoch=st.lr_epoch, rng=st.rng,
        layout=weights.state_layout(model), worker=0, n_workers=N,
        params_resident=st.params_resident,
        residual_outer=st.sync_residual_outer)
    leaves, pieces = weights.wire_layout(model)
    restored, _ = t_ckpt.restore_checkpoint(
        path, template, params_template=comms.ParamsTemplate.of(
            names, [p for _k, p in named], comms.WireLayout(leaves, pieces)),
        num_slices=SLICES)
    live, back = template.tensors(), restored.tensors()
    assert set(live) == set(back)
    for k in live:
        np.testing.assert_array_equal(live[k].numpy(), back[k], err_msg=k)
    assert restored.residual_outer and restored.params_resident


def test_resume_trains_only_the_remaining_round(runs):
    rounds = [r["epoch"] for r in runs["resume"]["round_timings"]]
    assert rounds == [2]
    assert t_ckpt.committed_epochs(runs["ckpt_dir"])[-1] == 3


def test_streamed_run_is_bitwise_the_packed_run(runs):
    """The streamed round takes the same hierarchical sync: its losses and
    every rank's parameters equal the packed run's bit for bit."""
    a, b = runs["packed"], runs["streamed"]
    assert b["sync_engine"]["mode"] == "hier"
    for key in ("global_train_losses", "all_workers_losses",
                "global_val_losses"):
        assert a[key] == b[key], key
    assert a["param_checksums"] == b["param_checksums"]
    assert a["round_checksums"] == b["round_checksums"]


def test_shared_start_ran_a_spawn_target_job(runs):
    """The gloo probe's job ran on every rank of the shared start (rank 0
    in the caller)."""
    for row in runs["probe"]:
        assert row["all_gather/views"].startswith("ok")


def test_shared_start_refuses_what_regroups(tmp_path):
    """A shared start takes a chaos run (its rank 0 spawns a join's ranks,
    its retired ranks go on to the next job) and refuses what does not
    run on its processes: --sim_workers, and runs of mixed process
    counts."""
    cfg = Config(device="cpu", num_workers=2, chaos="kill@1:w1",
                 aggregation_by="weights", sync_mode="sharded")
    start = t_driver.SharedStart(2, [cfg])
    assert [(job[0].chaos, job[2]) for job in start.jobs] == [("kill@1:w1", 2)]
    with pytest.raises(ValueError, match="--sim_workers runs in one"):
        t_driver.SharedStart(2, [Config(device="cpu", sim_workers=2)])
    with pytest.raises(ValueError, match="one process count"):
        with t_main.run_shared([["--device", "cpu", "--num_workers", "2"],
                                ["--device", "cpu", "--num_workers", "3"]]):
            pass
