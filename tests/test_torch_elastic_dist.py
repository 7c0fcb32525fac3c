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
- a resume across an earlier membership event is refused."""

import functools
import operator

import jax
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    """One intra-op thread here and in every rank spawned (joiners
    included): the CPU's reduction order depends on the thread count, so
    a continued run and its fresh twin run on the same one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
