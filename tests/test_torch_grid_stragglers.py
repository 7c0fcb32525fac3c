"""The wall-perturbing chaos kinds on the rank grid (CPU, gloo, fp32, one
intra-op thread per rank, gpt_tiny on synthetic_lm from JAX's seeded
init, uniform shares, data=3,model=2), each against the JAX driver's run
of the same config on the virtual devices (events, rosters, straggler
retries, step caps; losses at rtol 2e-4):

- ``stall@1:w2+70,slow@1:w1x4000`` with the walls pinned by logical id:
  both overrun round 1's deadline (a retry each), worker 1 overruns its
  extended deadline in round 2 and departs at the round-3 boundary;
- ``--chaos random`` (seed 2: a stall, a kill by fraction, a slow) with
  the targets pinned against the grid's round-0 roster of blocks;
- measured walls, with one rank of worker 1's block (world rank 3, not
  the block's lead) reporting 100 s more in rounds 1 and 2
  (tests/_torch_slow_rank.py) and a stall on worker 2: the straggler
  policy reads each block's slowest rank, so every rank takes worker 1's
  departure at the round-3 boundary (a rank that read another vector
  would leave the others waiting in a collective), as the JAX run whose
  walls say worker 1 took 100 s does.

The port's runs share one start of their ranks; the JAX runs go to a
pool of two processes beside them."""

import concurrent.futures
import functools
import multiprocessing
import operator

import _torch_slow_rank
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
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

KW = dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=4,
          epochs_local=1, batch_size=8, limit_train_samples=96,
          limit_eval_samples=32, compute_dtype="float32", augment=False,
          aggregation_by="weights", seed=1, probe_batches=1,
          proportionality="uniform", mesh_shape="data=3,model=2")
AXES = {"data": 3, "model": 2}
PROBE = [0.02] * 3
# seconds per logical worker id (up to 8) and round
WALLS = [[0.02] * 8 for _ in range(8)]
# the measured run's walls as the JAX run is told them: worker 1 took
# SLOW_S more in SLOW_ROUNDS
SLOW_WALLS = [[0.02 + (_torch_slow_rank.SLOW_S if w == 1 and e in
                       _torch_slow_rank.SLOW_ROUNDS else 0.0)
               for w in range(8)] for e in range(8)]
# run name -> (extra flags, the walls the JAX run reads; the port's are
# pinned to WALLS, or measured for "measured")
RUNS = {
    "slow_stall": (dict(chaos="stall@1:w2+70,slow@1:w1x4000"), WALLS),
    "random": (dict(chaos="random", chaos_events=3, chaos_seed=2), WALLS),
    "measured": (dict(chaos="stall@1:w2+70"), SLOW_WALLS),
}
LOSSES = ("global_train_losses", "global_val_losses")
RTOL = 2e-4


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


def _record(res: dict) -> dict:
    el = res["elastic"]
    return {**{k: list(res[k]) for k in LOSSES},
            "step_caps": [list(c) for c in res["step_caps"]],
            "events": el["events"], "final": el["final_worker_ids"],
            "snapshots": [(s.epoch, list(s.worker_ids))
                          for s in el["snapshots"]],
            "retries": [{k: r[k] for k in ("worker", "attempt",
                                           "deadline_s", "next_deadline_s")}
                        for r in el["sync_retries"]],
            "retry_walls": [r["wall_s"] for r in el["sync_retries"]]}


def _jax_run(name: str) -> dict:
    """The JAX driver's run ``RUNS[name]`` on the virtual CPU devices, from
    its seeded init, with the probe and the walls it is told."""
    jax.config.update("jax_platforms", "cpu")
    extra, walls = RUNS[name]
    res = j_train_global(
        JConfig(**KW, **extra), mesh=build_mesh(AXES, jax.devices()[:6]),
        simulated_durations=PROBE,
        simulated_round_durations=functools.partial(operator.getitem, walls),
        progress=False)
    return _record(res)


@pytest.fixture(scope="module")
def runs(devices):
    """The port's runs of RUNS from one start of 6 ranks (its spawned
    ranks pin rank 3's wall in the measured run) and the JAX driver's
    runs in two processes beside them."""
    kw = dict(progress=False, simulated_durations=PROBE,
              initial_state_dict=_jax_init())
    pinned = functools.partial(operator.getitem, WALLS)
    jobs = [(Config(device="cpu", log_level="WARNING", **KW, **extra),
             kw if name == "measured"
             else dict(kw, simulated_round_durations=pinned))
            for name, (extra, _walls) in RUNS.items()]
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_runs = {name: pool.submit(_jax_run, name) for name in RUNS}
        with t_driver.SharedStart(
                6, jobs, target=_torch_slow_rank.slow_rank_entry) as start:
            out = {name: start.run() for name in RUNS}
        out.update({f"jax_{name}": run.result(timeout=600)
                    for name, run in jax_runs.items()})
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_decisions_match_the_jax_driver(runs, name):
    """The same events, snapshots (boundary round and roster of blocks),
    final roster, straggler retries (worker, attempt and deadlines) and
    step caps as the JAX driver's run, every round."""
    mine, theirs = _record(runs[name]), runs[f"jax_{name}"]
    for key in ("events", "snapshots", "final", "retries", "step_caps"):
        assert mine[key] == theirs[key], key
    if name != "measured":
        assert mine["retry_walls"] == theirs["retry_walls"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_the_jax_driver(runs, name):
    """The global train and val losses every round within rtol 2e-4 of the
    JAX driver's from the same initial parameters."""
    for key in LOSSES:
        np.testing.assert_allclose(runs[name][key], runs[f"jax_{name}"][key],
                                   rtol=RTOL, err_msg=f"{name}: {key}")


def test_slow_worker_departs(runs):
    """``stall@1:w2+70,slow@1:w1x4000``: round 1 logs a retry for workers
    1 and 2 (the deadline 65 s, then 67.5 s), worker 1's 80 s round 2
    overruns the extended deadline, it departs at the round-3 boundary and
    the grid shrinks to data=2; worker 2, back under its deadline, stays."""
    res = runs["slow_stall"]
    el = res["elastic"]
    assert [(r["worker"], r["attempt"], r["deadline_s"])
            for r in el["sync_retries"]] == [(1, 1, 65.0), (2, 1, 65.0)]
    assert el["events"] == [{"round": 3, "kind": "depart", "worker": 1}]
    assert el["rosters"] == [[0, 1, 2]] * 3 + [[0, 2]]
    assert res["grid"]["axes"] == {"data": 2, "model": 2}
    assert all(np.isfinite(res["global_train_losses"]))


def test_one_slow_rank_is_its_blocks_wall(runs):
    """Measured walls: world rank 3 (worker 1's second rank, not its
    block's lead) reports 100 s more in rounds 1 and 2.  Each worker's
    wall is its block's slowest rank's, gathered over the world, so every
    rank reads the same vector: worker 1 overruns twice and departs at the
    round-3 boundary on every rank (the run completes and regroups to
    data=2), as in the JAX run told that worker 1 took 100 s."""
    res = runs["measured"]
    el = res["elastic"]
    walls = {r["worker"]: r["wall_s"] for r in el["sync_retries"]}
    assert sorted(walls) == [1, 2]
    assert walls[1] >= _torch_slow_rank.SLOW_S
    assert el["events"] == [{"round": 3, "kind": "depart", "worker": 1}]
    assert el["rosters"] == [[0, 1, 2]] * 3 + [[0, 2]]
    assert res["grid"]["axes"] == {"data": 2, "model": 2}
    rt = res["round_timings"]
    assert rt[1]["workers_wall_s"][1] >= _torch_slow_rank.SLOW_S
    assert max(rt[1]["workers_wall_s"][i] for i in (0, 2)) < 65.0
