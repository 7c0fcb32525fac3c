"""Elastic membership and chaos over the port's worker processes (CPU,
gloo, one intra-op thread per rank, fp32, augmentation off), with the
walls pinned (``simulated_round_durations``, indexed by logical id):

- one run of 3 mlp workers on the sharded engine (scatter-resident
  parameters, buddy hop) under ``kill@1:w2,join@2,crash@3:w0,nan@4:w1``:
  the roster goes 3 -> 2 -> 3 -> 2 (the kill takes the max id, the join
  gets a fresh one), the crashed round is voided and re-run on the
  survivors from the buddy rows, one quarantine strike is recorded; and
  a fresh run from each of its membership snapshots is bitwise its tail;
- 4 workers against the JAX driver under nan strikes that escalate to a
  departure and a quorum floor that rejects a kill: the same events,
  rejections, rosters, shard sizes and step caps every round, the losses
  within rtol 2e-4 (the same initial parameters);
- a resume across an earlier membership event is refused;
- a crash inside a membership transition (the ``PORT_ELASTIC_TEST_CRASH``
  hook, after the rows are resharded, before the new group exists)
  resumes from the last committed checkpoint and replays ``--chaos``
  from that epoch, flat and on a data=3,model=2 grid, against the JAX
  driver's resume of the same crash (JAX
  ``test_crash_during_reshard_resumes_and_replays``)."""

import concurrent.futures
import functools
import multiprocessing
import operator
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    driver as t_driver,
    main as t_main,
    viz as t_viz,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RUN = dict(model="mlp", dataset="mnist", epochs_global=6, epochs_local=1,
           batch_size=16, limit_train_samples=300, limit_eval_samples=32,
           probe_batches=1, compute_dtype="float32", augment=False,
           aggregation_by="weights", sync_mode="sharded", time_limit=0.5,
           seed=1, log_level="warning")
# seconds per logical worker id (up to 6) and round: worker w is slower
# by 30 % per id, every round a little slower than the last
WALLS = [[0.02 * (1 + 0.3 * w + 0.1 * e) for w in range(6)]
         for e in range(8)]
TAIL = ("global_train_losses", "global_val_losses",
        "global_train_accuracies", "global_val_accuracies", "step_caps",
        "shard_sizes")


def _kw(**over):
    return dict(simulated_durations=over.pop("probe", None),
                simulated_round_durations=functools.partial(
                    operator.getitem, WALLS), progress=False, **over)


@pytest.fixture(scope="module")
def chaos_run():
    cfg = Config(device="cpu", num_workers=3,
                 chaos="kill@1:w2,join@2,crash@3:w0,nan@4:w1", **RUN)
    res = t_driver.run_group(cfg, 3, train_kwargs=_kw(probe=[0.2, 0.3, 0.25]))
    return cfg, res


def test_chaos_run_rosters_recovery_and_quarantine(chaos_run):
    _cfg, res = chaos_run
    el = res["elastic"]
    assert el["rosters"] == [[0, 1, 2], [0, 1], [0, 1, 3], [1, 3], [1, 3],
                             [1, 3]]
    assert [(e["round"], e["kind"], e["worker"]) for e in el["events"]] == [
        (1, "kill", 2), (2, "join", 3), (3, "crash", 0)]
    assert (el["crashes"], el["recoveries"]) == (1, 1)
    assert el["recovery_source"] == ["buddy"]
    assert el["quarantined_rounds"] == 1 and el["rejected"] == []
    assert el["final_worker_ids"] == [1, 3]
    assert [s.epoch for s in el["snapshots"]] == [1, 2, 3]
    assert len(res["global_train_losses"]) == 6      # the void round re-ran
    assert all(np.isfinite(res["global_train_losses"]))
    assert len(set(res["param_checksums"])) == 1     # equal all-reduce
    eng = res["sync_engine"]
    assert (eng["mode"], eng["param_residency"]) == ("sharded", "resident")
    b = eng["per_worker_state_bytes"]
    assert b["params"] * 2 == b["params_gathered_peak"]
    assert b["buddy"] == b["params"]
    # the logical ids' loss lists: worker 2 stopped at round 1, worker 0
    # at round 3 (its voided attempt never recorded), joiner 3 from round 2
    lens = [len(x) for x in res["all_workers_losses"]]
    assert lens[2] < lens[0] < lens[1] and lens[3] > 0


@pytest.mark.parametrize("which", [0, 1, 2], ids=["kill", "join", "crash"])
def test_fresh_twin_from_snapshot_is_bitwise(chaos_run, which):
    """A fresh run from each membership snapshot (its own processes, the
    install path every position of the continued run took) reproduces
    the continued run's tail bit for bit, final parameters included."""
    cfg, res = chaos_run
    snap = res["elastic"]["snapshots"][which]
    twin = t_driver.run_group(cfg, snap.n_workers, train_kwargs=_kw(),
                              elastic_snapshot=snap)
    e = snap.epoch
    for k in TAIL:
        assert twin[k] == res[k][e:], k
    for wid in snap.worker_ids:
        got = twin["all_workers_losses"][wid]
        assert got == res["all_workers_losses"][wid][-len(got):], wid
    assert twin["param_checksums"] == res["param_checksums"]
    assert twin["elastic"]["final_worker_ids"] == [1, 3]


def _jax_init_state_dict(cfg: JConfig) -> dict:
    """JAX's seeded init of the mlp (row 0 of its engine's tiled state) in
    the port's layout."""
    eng = JEngine(j_get_model("mlp", num_classes=10),
                  build_mesh({"data": 1}, jax.devices()[:1]), cfg)
    state = eng.init_state(jax.random.key(cfg.seed),
                           np.zeros((cfg.batch_size, 28, 28, 1), np.float32))
    params = jax.tree.map(lambda a: np.asarray(a)[0], state.params)
    return weights.cnn_flax_to_torch({"params": params})


def test_decisions_match_the_jax_driver(devices):
    """Four workers with nan strikes on worker 1 (escalating to its
    departure at the round-3 boundary), and a quorum floor of 2 that
    rejects the second of two kills there: the JAX driver's events,
    rejections, rosters, shard sizes and caps, every round; losses within
    fp32 tolerance from the same initial parameters."""
    kw = dict(RUN, num_workers=4, elastic_min_workers=2, chaos_retries=1,
              chaos="nan@1:w1,nan@2:w1,kill@3:w0,kill@3:w2")
    probe = [0.2, 0.3, 0.25, 0.35]
    j_res = j_train_global(
        JConfig(**kw), mesh=build_mesh({"data": 4}, devices[:4]),
        simulated_durations=probe,
        simulated_round_durations=functools.partial(operator.getitem,
                                                    WALLS), progress=False)
    init = _jax_init_state_dict(JConfig(**kw))
    res = t_driver.run_group(Config(device="cpu", **kw), 4, train_kwargs=_kw(
        probe=probe, initial_state_dict=init))
    el, jel = res["elastic"], j_res["elastic"]
    for key in ("events", "rejected", "quarantined_rounds",
                "final_worker_ids", "rounds_degraded", "sync_retries"):
        assert el[key] == jel[key], key
    assert [s.worker_ids for s in el["snapshots"]] == [
        s.worker_ids for s in jel["snapshots"]]
    assert el["rosters"][-1] == [2, 3]
    assert [(e["kind"], e["worker"]) for e in el["events"]] == [
        ("depart", 1), ("kill", 0)]
    assert [r["reason"] for r in el["rejected"]] == ["quorum floor 2"]
    assert res["shard_sizes"] == j_res["shard_sizes"]
    assert res["step_caps"] == j_res["step_caps"]
    # two frameworks' fp32 reductions, 6 rounds of Adam apart: 2.3e-5
    # (train) and 6.3e-5 (val) on the CPU host the test was written on;
    # JAX's CPU results also move in the last bit between hosts
    np.testing.assert_allclose(res["global_train_losses"],
                               j_res["global_train_losses"], rtol=2e-4)
    np.testing.assert_allclose(res["global_val_losses"],
                               j_res["global_val_losses"], rtol=2e-4)


def test_resume_across_an_earlier_membership_event_refused(tmp_path,
                                                          monkeypatch):
    """Resume replays --chaos from the resume epoch, so a kill before it
    is refused with the reason (JAX driver.py:810-850)."""
    argv = ["--device", "cpu", "--model", "mlp", "--dataset", "mnist",
            "--epochs_global", "2", "--epochs_local", "1", "--batch_size",
            "16", "--limit_train_samples", "96", "--limit_eval_samples", "16",
            "--probe_batches", "1", "--compute_dtype", "float32",
            "--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every",
            "1", "--out_dir", str(tmp_path / "out"), "--log_level",
            "warning"]
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    t_main.run(argv)
    argv[argv.index("--epochs_global") + 1] = "4"
    with pytest.raises(ValueError, match="across earlier membership events"):
        t_main.run([*argv, "--resume", "--chaos", "kill@1:w0,join@3"])


def test_crash_without_buddy_rows_falls_back_to_the_checkpoint(tmp_path):
    """``--shard_redundancy off``: the crashed worker's resident span
    exists nowhere in memory, so the recovery restores the newest
    committed checkpoint's rows (JAX's ladder), and the run from that
    recovery's snapshot is still bitwise a fresh twin's."""
    cfg = Config(device="cpu", num_workers=3, chaos="crash@2:w1",
                 shard_redundancy="off", checkpoint_dir=str(tmp_path),
                 checkpoint_every=1, **RUN)
    res = t_driver.run_group(cfg, 3, train_kwargs=_kw(probe=[0.2, 0.3,
                                                             0.25]))
    el = res["elastic"]
    assert el["recovery_source"] == ["checkpoint"]
    assert el["rosters"][2:] == [[0, 2]] * 4
    snap = el["snapshots"][0]
    twin = t_driver.run_group(
        Config(device="cpu", num_workers=3, chaos="crash@2:w1",
               shard_redundancy="off", **RUN), snap.n_workers,
        train_kwargs=_kw(), elastic_snapshot=snap)
    for k in TAIL:
        assert twin[k] == res[k][snap.epoch:], k
    assert twin["param_checksums"] == res["param_checksums"]


def test_unrecoverable_crash_raises():
    """No buddy rows and no checkpoint: the crash cannot be recovered, and
    the run says so instead of continuing on a hole."""
    cfg = Config(device="cpu", num_workers=2, chaos="crash@1:w1",
                 shard_redundancy="off", **{**RUN, "epochs_global": 2})
    with pytest.raises(RuntimeError) as err:
        t_driver.run_group(cfg, 2, train_kwargs=_kw(probe=[0.2, 0.3]))
    chain = f"{err.value} {err.value.__cause__}"
    assert "unrecoverable" in chain and "no --checkpoint_dir" in chain


# the crash-during-reshard runs: a flat mlp group and a gpt_tiny grid,
# each as (config, mesh axes, pinned probe)
RESHARD = {
    "flat": (dict(RUN, num_workers=3, epochs_global=3), {"data": 3},
             [0.2, 0.3, 0.25]),
    "grid": (dict(RUN, model="gpt_tiny", dataset="synthetic_lm",
                  mesh_shape="data=3,model=2", epochs_global=3,
                  limit_train_samples=96, sync_mode="auto",
                  proportionality="uniform"), {"data": 3, "model": 2},
             [0.2, 0.3, 0.25]),
}
RESHARD_CHAOS = "kill@2:w1"


def _jax_gpt_init() -> dict:
    """The JAX driver's seeded init of the dense gpt_tiny (stacked layers,
    fp32), in the port's layout."""
    kw = RESHARD["grid"][0]
    ds = load_dataset(kw["dataset"], limit_train=8, limit_test=8)[0]
    model = j_get_model(kw["model"], num_classes=ds.num_classes,
                        dtype=jnp.float32, scan_layers=True)
    params = model.init(jax.random.key(kw["seed"]),
                        jnp.zeros((kw["batch_size"], ds.images.shape[1]),
                                  jnp.int32), train=False)["params"]
    return weights.flax_to_torch(params)


def _jax_crash_resume(layout: str, ckpt_dir: str) -> dict:
    """JAX ``test_crash_during_reshard_resumes_and_replays``'s recovery on
    the virtual CPU devices (a process of its own: the hook is read from
    the environment): the run ended by the hook inside the round-2
    transition, then its resume from the committed checkpoint; the
    resume's losses and elastic record."""
    import os
    jax.config.update("jax_platforms", "cpu")
    kw, axes, probe = RESHARD[layout]
    n = int(np.prod(list(axes.values())))

    def run(**over):
        return j_train_global(
            JConfig(chaos=RESHARD_CHAOS, checkpoint_dir=ckpt_dir,
                    checkpoint_every=1, **kw, **over),
            mesh=build_mesh(axes, jax.devices()[:n]),
            simulated_durations=probe,
            simulated_round_durations=functools.partial(operator.getitem,
                                                        WALLS),
            progress=False)
    os.environ["JAX_GRAFT_ELASTIC_TEST_CRASH"] = "mid_reshard"
    try:
        run()
    except RuntimeError as err:
        assert "elastic test crash hook" in str(err), err
    else:
        raise AssertionError("the JAX crash hook did not fire")
    del os.environ["JAX_GRAFT_ELASTIC_TEST_CRASH"]
    res = run(resume=True)
    el = res["elastic"]
    return {"global_train_losses": list(res["global_train_losses"]),
            "global_val_losses": list(res["global_val_losses"]),
            "events": el["events"], "final": el["final_worker_ids"],
            "step_caps": res["step_caps"]}


@pytest.mark.parametrize("layout", sorted(RESHARD))
def test_crash_during_reshard_resumes_and_replays(tmp_path, monkeypatch,
                                                  layout):
    """A crash INSIDE the round-2 membership transition (after the old
    roster's rows are resharded, before the new group exists) ends the
    run on every rank; a resume from the last committed checkpoint
    (epoch 2) replays the schedule: the kill re-applies at the same
    boundary and exactly the post-crash round runs.  The resume is held
    against the JAX driver's resume of the same crash (its hook, the same
    initial parameters, probe and walls): the events, the final roster,
    the step caps and the losses within rtol 2e-4; and a second resume
    from the same files is bitwise the first."""
    kw, axes, probe = RESHARD[layout]
    n = int(np.prod(list(axes.values())))
    cfg = lambda d, **o: Config(device="cpu", chaos=RESHARD_CHAOS,
                                checkpoint_dir=str(d), checkpoint_every=1,
                                **kw, **o)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_run = pool.submit(_jax_crash_resume, layout,
                              str(tmp_path / "jax"))
        init = (_jax_gpt_init() if layout == "grid"
                else _jax_init_state_dict(JConfig(**kw)))
        train_kw = _kw(probe=probe, initial_state_dict=init)
        monkeypatch.setenv("PORT_ELASTIC_TEST_CRASH", "mid_reshard")
        with pytest.raises(RuntimeError) as err:
            t_driver.run_group(cfg(tmp_path / "ck"), n, train_kwargs=train_kw)
        assert "elastic test crash hook" in \
            f"{err.value} {err.value.__cause__}"
        monkeypatch.delenv("PORT_ELASTIC_TEST_CRASH")
        # the recovery runs twice from the same files (the first resume
        # writes its own epoch-3 checkpoint)
        shutil.copytree(tmp_path / "ck", tmp_path / "twin")
        jobs = [(cfg(tmp_path / d, resume=True), train_kw)
                for d in ("ck", "twin")]
        with t_driver.SharedStart(n, jobs) as start:
            resumed, again = start.run(), start.run()
        theirs = jax_run.result(timeout=600)
    el = resumed["elastic"]
    assert el["events"] == [{"round": 2, "kind": "kill", "worker": 1}]
    assert el["events"] == theirs["events"]
    assert el["final_worker_ids"] == theirs["final"] == [0, 2]
    assert len(resumed["global_train_losses"]) == 1
    assert len(el["reshard_ms"]) == 1
    assert resumed["step_caps"] == theirs["step_caps"]
    for key in ("global_train_losses", "global_val_losses"):
        np.testing.assert_allclose(resumed[key], theirs[key], rtol=2e-4,
                                   err_msg=key)
    assert again["global_train_losses"] == resumed["global_train_losses"]
    assert again["param_checksums"] == resumed["param_checksums"]
    assert again["elastic"]["final_worker_ids"] == [0, 2]
