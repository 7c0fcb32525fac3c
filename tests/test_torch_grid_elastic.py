"""Elastic membership and chaos on the rank grid (CPU, gloo, fp32, one
intra-op thread per rank, the walls pinned by logical id, gpt_tiny on
synthetic_lm from JAX's seeded init, uniform shares):

- kill, join and crash at data=3,model=2 in one run (``kill@1:w2,join@2,
  crash@3:w0``: the roster of worker blocks goes 3 -> 2 -> 3 -> 2, the
  inner axis never changes, the crashed round re-runs from the boundary
  snapshot), a kill on the ring topology under model=2 and a kill under
  seq=2 (ring attention): each against the JAX driver's run of the same
  config on the virtual devices (losses at rtol 2e-4; events, rosters and
  recovery sources equal), and a fresh run from each of its membership
  snapshots bitwise its tail (the other inner axes:
  tests/test_torch_grid_chaos_axes.py);
- ``--mesh_shape model=2,data=3`` (each worker's ranks interleaved with
  the others') bitwise ``data=3,model=2``;
- ``nan@2:w1`` under model=2, which the JAX driver cannot run (its
  shard_map refuses the screen's out_specs): against the port's flat
  data=3 run of the same schedule, with the same quarantine verdict on
  every rank of a block.

The port's runs share one start of their ranks (``driver.SharedStart``);
the JAX runs go to a pool of two processes beside them."""

import concurrent.futures
import functools
import multiprocessing
import operator

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
    elastic,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)

KW = dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=3,
          epochs_local=1, batch_size=8, limit_train_samples=96,
          limit_eval_samples=32, compute_dtype="float32", augment=False,
          aggregation_by="weights", seed=1, probe_batches=1,
          proportionality="uniform")
# seconds per logical worker id (up to 8) and round: no straggler
WALLS = [[0.02] * 8 for _ in range(8)]
CHAOS_TP = "kill@1:w2,join@2,crash@3:w0"
# run name -> (mesh axes, extra flags); each a 6-rank run
RUNS = {
    "tp": ({"data": 3, "model": 2},
           dict(chaos=CHAOS_TP, epochs_global=4)),
    "ring": ({"data": 3, "model": 2},
             dict(chaos="kill@1:w1", topology="ring")),
    "seq": ({"data": 3, "seq": 2},
            dict(chaos="kill@1:w1", sequence_parallel="ring")),
}
# runs of the port only: the blocks interleaved, the screen on the grid
PORT_ONLY = {
    "tp_interleaved": ({"model": 2, "data": 3},
                       dict(chaos=CHAOS_TP, epochs_global=4)),
    "nan": ({"data": 3, "model": 2}, dict(chaos="nan@2:w1",
                                          epochs_global=4)),
}
LOSSES = ("global_train_losses", "global_val_losses")
TAIL = (*LOSSES, "global_train_accuracies", "global_val_accuracies",
        "step_caps", "shard_sizes")
RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(axes, extra):
    return dict(KW, mesh_shape=",".join(f"{a}={n}" for a, n in axes.items()),
                **extra)


def _cfg(axes, extra):
    return Config(device="cpu", log_level="WARNING", **_kw(axes, extra))


def _walls():
    return functools.partial(operator.getitem, WALLS)


def _jax_init():
    """The JAX driver's seeded init of the dense gpt_tiny (stacked
    layers, fp32), in the port's layout."""
    ds = load_dataset(KW["dataset"], limit_train=8, limit_test=8)[0]
    model = j_get_model(KW["model"], num_classes=ds.num_classes,
                        dtype=jnp.float32, scan_layers=True)
    params = model.init(jax.random.key(KW["seed"]),
                        jnp.zeros((KW["batch_size"], ds.images.shape[1]),
                                  jnp.int32), train=False)["params"]
    return weights.flax_to_torch(params)


def _jax_run(name: str) -> dict:
    """The JAX driver's run ``RUNS[name]`` on the virtual CPU devices, from
    its seeded init: its losses and its elastic record."""
    jax.config.update("jax_platforms", "cpu")
    axes, extra = RUNS[name]
    n = int(np.prod(list(axes.values())))
    res = j_train_global(JConfig(**_kw(axes, extra)),
                         mesh=build_mesh(axes, jax.devices()[:n]),
                         simulated_round_durations=_walls(), progress=False)
    el = res["elastic"]
    return {**{k: list(res[k]) for k in LOSSES},
            "events": el["events"], "final": el["final_worker_ids"],
            "recovery_source": el["recovery_source"],
            "snapshots": [(s.epoch, list(s.worker_ids))
                          for s in el["snapshots"]]}


# each fresh twin's snapshot -> the ranks of its roster's blocks
TWIN_RANKS = {("tp", 0): 4, ("tp", 1): 6, ("tp", 2): 4, ("ring", 0): 4,
              ("seq", 0): 4}
TWINS = list(TWIN_RANKS)


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """Every run of RUNS and PORT_ONLY, the flat nan run and the fresh
    twins of the snapshots of RUNS from one start of 6 ranks (a twin's
    snapshot written before its job runs; a 4-rank job leaves the last 2
    ranks idle), and the JAX driver's runs of RUNS in two processes beside
    them."""
    init = _jax_init()
    kw = dict(progress=False, simulated_round_durations=_walls(),
              initial_state_dict=init)
    named = {**RUNS, **PORT_ONLY}
    root = tmp_path_factory.mktemp("snapshots")
    dirs = {key: str(root / f"{key[0]}-{key[1]}") for key in TWINS}
    jobs = [(_cfg(axes, extra), kw) for axes, extra in named.values()]
    jobs.append((_cfg({"data": 3}, PORT_ONLY["nan"][1]), kw, 3))
    jobs += [(_cfg(*named[key[0]]), dict(kw, elastic_snapshot=dirs[key]),
              TWIN_RANKS[key]) for key in TWINS]
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_runs = {name: pool.submit(_jax_run, name) for name in RUNS}
        with t_driver.SharedStart(6, jobs) as start:
            out = {name: start.run() for name in named}
            out["nan_flat"] = start.run()
            for name, i in TWINS:
                elastic.save_snapshot(out[name]["elastic"]["snapshots"][i],
                                      dirs[(name, i)])
                out[(name, i)] = start.run()
        out.update({f"jax_{name}": run.result(timeout=600)
                    for name, run in jax_runs.items()})
    return out


def _same_losses(a, b, what):
    for key in LOSSES:
        np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                   err_msg=f"{what}: {key}")


def test_tp_run_changes_the_roster_of_blocks(runs):
    """kill, join and crash at data=3,model=2: the roster of worker blocks
    3 -> 2 -> 3 -> 2 (the kill takes worker 2, the join a fresh id 3, the
    crash worker 0), the crashed round voided and re-run from the
    boundary snapshot (no buddy rows: the grid keeps its parameters
    replicated), every boundary timed, the model axis unchanged."""
    res = runs["tp"]
    el = res["elastic"]
    assert el["rosters"] == [[0, 1, 2], [0, 1], [0, 1, 3], [1, 3]]
    assert [(e["round"], e["kind"], e["worker"]) for e in el["events"]] == [
        (1, "kill", 2), (2, "join", 3), (3, "crash", 0)]
    assert (el["crashes"], el["recoveries"]) == (1, 1)
    assert el["recovery_source"] == ["snapshot"]
    assert len(el["boundary_ms"]) == 3 and min(el["boundary_ms"]) > 0
    assert [s.blocks for s in el["snapshots"]] == [2, 2, 2]
    assert res["grid"]["axes"] == {"data": 2, "model": 2}
    assert len(res["global_train_losses"]) == 4
    assert all(np.isfinite(res["global_train_losses"]))
    assert len(set(res["param_checksums"])) == 1


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_the_jax_driver(runs, name):
    """The JAX driver's run of the same config and schedule from the same
    initial parameters: the global train and val losses every round
    within rtol 2e-4 (two frameworks' fp32 rounding, as in
    tests/test_torch_elastic_dist.py)."""
    _same_losses(runs[name], runs[f"jax_{name}"], f"{name} vs JAX")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rosters_and_recovery_match_the_jax_driver(runs, name):
    """The same events, snapshots (boundary round and roster), final
    roster and crash recovery sources as the JAX driver's run."""
    el, jel = runs[name]["elastic"], runs[f"jax_{name}"]
    assert el["events"] == jel["events"]
    assert [(s.epoch, list(s.worker_ids))
            for s in el["snapshots"]] == jel["snapshots"]
    assert el["final_worker_ids"] == jel["final"]
    assert el["recovery_source"] == jel["recovery_source"]


@pytest.mark.parametrize("name,i", TWINS, ids=[f"{n}-{i}" for n, i in TWINS])
def test_fresh_twin_from_snapshot_is_bitwise(runs, name, i):
    """A fresh run from membership snapshot ``i`` (its own ranks, every
    one installing its (position, coordinate) row through the install
    path the continued run's ranks took) reproduces the continued run's
    tail bit for bit, final parameters included."""
    res, twin = runs[name], runs[(name, i)]
    snap = res["elastic"]["snapshots"][i]
    assert snap.n_workers * snap.blocks == TWIN_RANKS[(name, i)]
    for k in TAIL:
        assert twin[k] == res[k][snap.epoch:], k
    for wid in snap.worker_ids:
        got = twin["all_workers_losses"][wid]
        assert got == res["all_workers_losses"][wid][-len(got):], wid
    assert twin["param_checksums"] == res["param_checksums"]
    assert twin["elastic"]["final_worker_ids"] == \
        res["elastic"]["final_worker_ids"]


def test_interleaved_blocks_are_bitwise_the_data_first_grid(runs):
    """``model=2,data=3``: each worker's ranks are interleaved with the
    others' (world rank = model x 3 + data), so the blocks a boundary
    retires and spawns are not contiguous; the run is bitwise the
    data-first one, the rosters and every metric list included."""
    a, b = runs["tp_interleaved"], runs["tp"]
    assert a["grid"]["axes"] == {"model": 2, "data": 2}
    for k in (*TAIL, "all_workers_losses", "param_checksums"):
        assert a[k] == b[k], k
    assert a["elastic"]["rosters"] == b["elastic"]["rosters"]
    assert a["elastic"]["recovery_source"] == ["snapshot"]


def test_nan_quarantine_is_block_wide(runs):
    """``nan@2:w1`` under model=2 poisons one shard of worker 1's round-2
    contribution (its first rank's): the screen's verdict is the AND over
    the block, so every coordinate's data line quarantines worker 1 and
    the consensus shards agree; the run equals the flat data=3 run of the
    same schedule (rtol 2e-4: the model axis only reorders sums)."""
    res, flat = runs["nan"], runs["nan_flat"]
    assert res["elastic"]["quarantined_rounds"] == 1
    assert flat["elastic"]["quarantined_rounds"] == 1
    coords = res["grid"]["coords_of"]
    for row in res["round_timings"]:
        by_worker = {}
        for c, ok in zip(coords, row["ranks_sync_ok"]):
            by_worker.setdefault(c["data"], set()).add(ok)
        want = {0: {1.0}, 1: {0.0 if row["epoch"] == 2 else 1.0},
                2: {1.0}}
        assert by_worker == want, (row["epoch"], by_worker)
        assert row["sync_ok"] == [1.0, 0.0 if row["epoch"] == 2 else 1.0,
                                  1.0]
    _same_losses(res, flat, "nan under model=2 vs flat")
    assert len(set(res["param_checksums"])) == 1
