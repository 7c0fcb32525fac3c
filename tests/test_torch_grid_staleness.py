"""``--sync_staleness K`` on the rank grid (CPU, gloo, fp32, one intra-op
thread per rank, gpt_tiny on synthetic_lm from JAX's seeded init, uniform
shares, 3 rounds, weights mode): each coordinate's data line runs its
stale sync on a second group of the line (``mesh.Grid.split_lines``), at
K = 1 and 2 under model=2, expert=2 (4 experts), pipe=2 and fsdp=2 with
data=2:

- the losses against the JAX driver's run of the same config on the
  virtual devices (rtol 2e-4), with JAX's ``async_rounds`` keys and the
  same count of delivered deltas (one a round: the loop's and the
  drain's);
- the serial twin (``PORT_STALENESS_SERIAL``: each stale sync run to its
  end at dispatch) bitwise the overlapped run, final parameters
  included.

The overlapped runs share one start of their ranks, the serial twins
another (the variable is read when a rank's engine is built); the JAX
runs go to a pool of two processes beside them."""

import concurrent.futures
import multiprocessing
import os

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
    STALENESS_SERIAL_ENV,
)

KW = dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=3,
          epochs_local=1, batch_size=8, limit_train_samples=96,
          limit_eval_samples=32, compute_dtype="float32", augment=False,
          aggregation_by="weights", seed=1, probe_batches=1,
          proportionality="uniform")
# inner axis -> (mesh axes, extra flags); each a 4-rank grid
AXES = {
    "model": ({"data": 2, "model": 2}, {}),
    "expert": ({"data": 2, "expert": 2}, dict(num_experts=4)),
    "pipe": ({"data": 2, "pipe": 2}, {}),
    "fsdp": ({"data": 2, "fsdp": 2}, {}),
}
RUNS = [(axis, k) for axis in AXES for k in (1, 2)]
IDS = [f"{axis}-K{k}" for axis, k in RUNS]
LOSSES = ("global_train_losses", "global_val_losses")
RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(axis, k):
    axes, extra = AXES[axis]
    return dict(KW, mesh_shape=",".join(f"{a}={n}" for a, n in axes.items()),
                sync_staleness=k, **extra)


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


def _jax_runs(axis: str) -> dict:
    """The JAX driver's runs at K = 1 and 2 under ``axis`` on the virtual
    CPU devices (one process: the second reuses the first's compiles),
    from its seeded init: their losses and ``async_rounds``."""
    jax.config.update("jax_platforms", "cpu")
    axes = AXES[axis][0]
    n = int(np.prod(list(axes.values())))
    out = {}
    for k in (1, 2):
        res = j_train_global(JConfig(**_kw(axis, k)),
                             mesh=build_mesh(axes, jax.devices()[:n]),
                             progress=False)
        out[k] = {**{key: list(res[key]) for key in LOSSES},
                  "async_rounds": res["async_rounds"]}
    return out


def _start(jobs):
    with t_driver.SharedStart(4, jobs) as start:
        return [start.run() for _ in jobs]


@pytest.fixture(scope="module")
def runs(devices):
    """Every run of RUNS from one start of 4 ranks, their serial twins
    from another, and the JAX driver's runs in two processes beside
    them."""
    init = {e: _jax_init(e) for e in (0, 4)}
    jobs = [(Config(device="cpu", log_level="WARNING", **_kw(axis, k)),
             dict(progress=False,
                  initial_state_dict=init[AXES[axis][1].get("num_experts",
                                                            0)]))
            for axis, k in RUNS]
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jax_runs = {axis: pool.submit(_jax_runs, axis) for axis in AXES}
        out = {"overlap": dict(zip(RUNS, _start(jobs)))}
        os.environ[STALENESS_SERIAL_ENV] = "1"
        try:
            out["serial"] = dict(zip(RUNS, _start(jobs)))
        finally:
            del os.environ[STALENESS_SERIAL_ENV]
        out["jax"] = {}
        for axis, run in jax_runs.items():
            for k, res in run.result(timeout=600).items():
                out["jax"][(axis, k)] = res
    return out


@pytest.mark.parametrize("axis,k", RUNS, ids=IDS)
def test_losses_match_the_jax_driver(runs, axis, k):
    """The JAX driver's stale run of the same config from the same
    initial parameters: the global train and val losses every round
    within rtol 2e-4 (two frameworks' fp32 rounding)."""
    res, jres = runs["overlap"][(axis, k)], runs["jax"][(axis, k)]
    for key in LOSSES:
        np.testing.assert_allclose(res[key], jres[key], rtol=RTOL,
                                   err_msg=f"{axis} K={k}: {key}")


@pytest.mark.parametrize("axis,k", RUNS, ids=IDS)
def test_async_rounds_keep_jax_keys_and_deliver_every_round(runs, axis, k):
    """``results["async_rounds"]`` has JAX's keys, the staleness, and as
    many delivered deltas as JAX's run (one a round: the rounds' and the
    end-of-run drain's); the grid is the flag's."""
    res, jres = runs["overlap"][(axis, k)], runs["jax"][(axis, k)]
    ar, jar = res["async_rounds"], jres["async_rounds"]
    assert set(ar) == set(jar)
    assert (ar["enabled"], ar["staleness"]) == (True, k)
    assert ar["delivered"] == jar["delivered"] == KW["epochs_global"]
    assert 0.0 <= ar["hidden_fraction"] <= 1.0
    assert res["grid"]["axes"] == AXES[axis][0]
    assert all(np.isfinite(res["global_train_losses"]))


@pytest.mark.parametrize("axis,k", RUNS, ids=IDS)
def test_serial_twin_is_bitwise(runs, axis, k):
    """Each stale sync run to its end at dispatch gives the same bits as
    the sync overlapped with the next rounds: the delta folds in at the
    same round entry either way."""
    a, b = runs["overlap"][(axis, k)], runs["serial"][(axis, k)]
    for key in (*LOSSES, "global_train_accuracies", "global_val_accuracies",
                "all_workers_losses", "param_checksums"):
        assert a[key] == b[key], key
    assert b["async_rounds"]["hidden_fraction"] == 0.0
