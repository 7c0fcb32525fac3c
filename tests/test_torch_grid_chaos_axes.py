"""A membership change under each inner axis but model (CPU, gloo, fp32,
one intra-op thread per rank, the walls pinned by logical id, gpt_tiny on
synthetic_lm from JAX's seeded init, uniform shares): ``kill@1:w1`` at
data=3 under expert=2 (4 experts), pipe=2 (GPipe and 1F1B) and fsdp=2,
each against the JAX driver's run of the same config on the virtual
devices (losses at rtol 2e-4; events, rosters and recovery sources
equal), and a fresh run from its membership snapshot bitwise its tail.
The port's runs share one start of their ranks (``driver.SharedStart``);
the JAX runs go to a pool of two processes beside them (the model and
seq axes, the interleaved blocks and the screen:
tests/test_torch_grid_elastic.py)."""

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
          proportionality="uniform", chaos="kill@1:w1")
# seconds per logical worker id (up to 8) and round: no straggler
WALLS = [[0.02] * 8 for _ in range(8)]
# run name -> (mesh axes, extra flags); each a 6-rank run
RUNS = {
    "expert": ({"data": 3, "expert": 2}, dict(num_experts=4)),
    "pipe": ({"data": 3, "pipe": 2}, {}),
    "pipe_1f1b": ({"data": 3, "pipe": 2}, dict(pp_schedule="1f1b")),
    "fsdp": ({"data": 3, "fsdp": 2}, {}),
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


def _jax_init(experts: int) -> dict:
    """The JAX driver's seeded init of the dense gpt_tiny (stacked
    layers, fp32, ``experts`` experts), in the port's layout."""
    ds = load_dataset(KW["dataset"], limit_train=8, limit_test=8)[0]
    model = j_get_model(KW["model"], num_classes=ds.num_classes,
                        dtype=jnp.float32, scan_layers=True,
                        num_experts=experts)
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


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """Every run of RUNS and the fresh twin of its snapshot (on 4 of the
    ranks, the snapshot written before the twin's job runs) from one
    start of 6 ranks, and the JAX driver's runs in two processes beside
    them."""
    init = {e: _jax_init(e) for e in (0, 4)}

    def kwargs(extra):
        return dict(progress=False, simulated_round_durations=_walls(),
                    initial_state_dict=init[extra.get("num_experts", 0)])
    root = tmp_path_factory.mktemp("snapshots")
    jobs = [(_cfg(axes, extra), kwargs(extra))
            for axes, extra in RUNS.values()]
    jobs += [(_cfg(axes, extra),
              dict(kwargs(extra), elastic_snapshot=str(root / name)), 4)
             for name, (axes, extra) in RUNS.items()]
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_runs = {name: pool.submit(_jax_run, name) for name in RUNS}
        with t_driver.SharedStart(6, jobs) as start:
            out = {name: start.run() for name in RUNS}
            for name in RUNS:
                elastic.save_snapshot(out[name]["elastic"]["snapshots"][0],
                                      str(root / name))
                out[f"twin_{name}"] = start.run()
        out.update({f"jax_{name}": run.result(timeout=600)
                    for name, run in jax_runs.items()})
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_kill_drops_a_block(runs, name):
    """The kill at the round-1 boundary drops worker 1's block of 2 ranks:
    the roster 3 -> 2 workers, the grid 3 x 2 -> 2 x 2 ranks."""
    res = runs[name]
    el = res["elastic"]
    assert el["rosters"] == [[0, 1, 2], [0, 2], [0, 2]]
    assert [s.blocks for s in el["snapshots"]] == [2]
    axes = dict(RUNS[name][0], data=2)
    assert res["grid"]["axes"] == axes
    assert all(np.isfinite(res["global_train_losses"]))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_losses_match_the_jax_driver(runs, name):
    """The JAX driver's run of the same config and schedule from the same
    initial parameters: the global train and val losses every round
    within rtol 2e-4 (two frameworks' fp32 rounding, as in
    tests/test_torch_elastic_dist.py)."""
    for key in LOSSES:
        np.testing.assert_allclose(runs[name][key], runs[f"jax_{name}"][key],
                                   rtol=RTOL, err_msg=f"{name}: {key}")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rosters_and_recovery_match_the_jax_driver(runs, name):
    """The same events, snapshots (boundary round and roster) and final
    roster as the JAX driver's run."""
    el, jel = runs[name]["elastic"], runs[f"jax_{name}"]
    assert el["events"] == jel["events"]
    assert [(s.epoch, list(s.worker_ids))
            for s in el["snapshots"]] == jel["snapshots"]
    assert el["final_worker_ids"] == jel["final"]
    assert el["recovery_source"] == jel["recovery_source"]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fresh_twin_from_snapshot_is_bitwise(runs, name):
    """A fresh run from the kill's snapshot (each rank installs its
    (position, coordinate) row through the continued run's install path)
    reproduces the continued run's tail bit for bit, final parameters
    included."""
    res, twin = runs[name], runs[f"twin_{name}"]
    snap = res["elastic"]["snapshots"][0]
    for k in TAIL:
        assert twin[k] == res[k][snap.epoch:], k
    for wid in snap.worker_ids:
        got = twin["all_workers_losses"][wid]
        assert got == res["all_workers_losses"][wid][-len(got):], wid
    assert twin["param_checksums"] == res["param_checksums"]
