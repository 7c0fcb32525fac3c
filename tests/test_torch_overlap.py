"""The port's overlapped round loop (the driver's default) against its
serial twin (``--no_overlap_rounds``) and against the JAX driver, on the
CPU (fp32, augmentation off, one intra-op thread per rank).

The overlap only moves work onto threads (the next round's prep beside
the running round, the metric fetch and assembly after it); the data flow
is the serial one, with the walls entering the EMA one round late in
both, so the two flows must give bit-identical results.  The probe and
the per-round walls are pinned and the time limit caps the steps, so the
partitions move from round to round (the counterparts of JAX
``tests/test_overlap.py:51-93``)."""

import functools
import hashlib
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
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RUN = dict(model="mlp", dataset="mnist", epochs_global=3, epochs_local=2,
           batch_size=16, limit_train_samples=400, limit_eval_samples=64,
           probe_batches=1, compute_dtype="float32", augment=False,
           aggregation_by="weights", time_limit=1.2, seed=1,
           log_level="warning")
# seconds per worker (up to 4) and round: the workers differ, every round
# differs, so the EMA re-partitions and the caps bind
PROBE = [0.1, 0.16, 0.08, 0.13]
WALLS = [[(1.0 + 0.4 * w) * (1.0 + 0.5 * e * (-1) ** w) for w in range(4)]
         for e in range(3)]
METRICS = ("all_workers_losses", "all_epochs_losses", "global_epoch_losses",
           "global_epoch_accuracies", "global_train_losses",
           "global_train_accuracies", "global_val_losses",
           "global_val_accuracies", "worker_specific_train_losses",
           "worker_specific_train_accuracies", "worker_specific_val_losses",
           "worker_specific_val_accuracies", "step_caps", "shard_sizes")
# the keys the port's rows carry besides JAX's: its per-round counts, the
# resident gather, the wire of the dense sync and the buddy hop, and the
# per-worker rows gathered over the processes
PORT_ROW_KEYS = {"epoch", "train_ms", "train_steps", "val_steps",
                 "gather_ms", "sync_wire_bytes", "sync_buddy_bytes",
                 "workers_wall_s", "workers_train_ms", "workers_train_steps",
                 "workers_sync_ms", "workers_max_memory_allocated",
                 "workers_memory_allocated"}


def _kw(n: int) -> dict:
    return dict(simulated_durations=PROBE[:n],
                simulated_round_durations=functools.partial(
                    operator.getitem, [w[:n] for w in WALLS]),
                progress=False)


def _run(case: str, overlap: bool, partitions: list) -> dict:
    """One run of ``case`` in the given flow; ``partitions`` records a
    digest of every shard set the run packs (the spy sees the prep
    thread's calls too)."""
    extra = {"one_worker": {}, "sim4": {"sim_workers": 4},
             "streamed": {"stream_chunk_steps": 2, "stream_prefetch": 2},
             "gloo2": {"num_workers": 2}}[case]
    cfg = Config(device="cpu", overlap_rounds=overlap, **RUN, **extra)
    n = cfg.sim_workers or max(cfg.num_workers, 1)
    real = t_driver._capped

    def spy(parts, batch, caps=None):
        h = hashlib.sha256()
        for p in parts:
            h.update(np.asarray(p, np.int64).tobytes())
        partitions.append(h.hexdigest())
        return real(parts, batch, caps)

    t_driver._capped = spy
    try:
        if case == "gloo2":
            return t_driver.run_group(cfg, 2, train_kwargs=_kw(2))
        return t_driver.train_global(cfg, **_kw(n))
    finally:
        t_driver._capped = real


@pytest.mark.parametrize("case", ["one_worker", "sim4", "streamed",
                                  "gloo2"])
def test_overlapped_run_is_bitwise_the_serial_run(case):
    parts = {True: [], False: []}
    serial = _run(case, False, parts[False])
    over = _run(case, True, parts[True])
    for k in METRICS:
        assert over[k] == serial[k], k
    assert parts[True] == parts[False]
    # the shards are drawn anew every round, and the caps or sizes move
    assert len(set(parts[False])) > 2, "the partitions never moved"
    assert (len(set(map(tuple, serial["step_caps"]))) > 1
            or len(set(map(tuple, serial["shard_sizes"]))) > 1)
    assert over["variables"].keys() == serial["variables"].keys()
    for name, t in serial["variables"].items():
        assert torch.equal(over["variables"][name], t), name
    if case == "gloo2":
        assert over["param_checksums"] == serial["param_checksums"]
    # the same rows in both flows; the gap and the next round's prep on
    # every round but the last
    for rows in (serial["round_timings"], over["round_timings"]):
        keys = [set(r) for r in rows]
        assert all(k == keys[0] for k in keys[:-1])
        assert {"gap_ms", "prep_ms"} <= keys[0]
        assert keys[-1] == keys[0] - {"gap_ms", "prep_ms"}
        assert all(r["fetch_ms"] >= 0 and r["assemble_ms"] >= 0
                   and r["stage_ms"] >= 0 for r in rows)
    assert [set(r) for r in over["round_timings"]] == [
        set(r) for r in serial["round_timings"]]


def _jax_init_state_dict(cfg: JConfig) -> dict:
    """JAX's seeded init of the mlp (row 0 of its engine's state) in the
    port's layout."""
    eng = JEngine(j_get_model("mlp", num_classes=10),
                  build_mesh({"data": 1}, jax.devices()[:1]), cfg)
    state = eng.init_state(jax.random.key(cfg.seed),
                           np.zeros((cfg.batch_size, 28, 28, 1), np.float32))
    params = jax.tree.map(lambda a: np.asarray(a)[0], state.params)
    return weights.cnn_flax_to_torch({"params": params})


@pytest.fixture(scope="module")
def against_jax(devices):
    """The JAX driver (its overlapped loop) and the port's overlapped
    loop on one worker, from the same initial parameters."""
    j_res = j_train_global(JConfig(**RUN),
                           mesh=build_mesh({"data": 1}, devices[:1]),
                           **_kw(1))
    res = t_driver.train_global(
        Config(device="cpu", **RUN), **_kw(1),
        initial_state_dict=_jax_init_state_dict(JConfig(**RUN)))
    return res, j_res


def test_overlapped_run_matches_the_jax_driver(against_jax):
    """The same caps and shards every round; the losses within the rtol
    of the driver parity tests (2e-4, ``test_torch_elastic_dist.py``:
    two frameworks' fp32 reductions, several Adam steps apart)."""
    res, j_res = against_jax
    assert res["step_caps"] == j_res["step_caps"]
    assert res["shard_sizes"] == j_res["shard_sizes"]
    for k in ("global_train_losses", "global_val_losses",
              "worker_specific_train_losses"):
        np.testing.assert_allclose(res[k], j_res[k], rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(res["global_val_accuracies"],
                               j_res["global_val_accuracies"], atol=1e-3)


def test_round_timings_carry_jax_keys(against_jax):
    """Every row has the JAX run's keys (``stage_ms``, ``compute_ms``,
    ``fetch_ms``, ``assemble_ms``, ``prep_ms``, ``gap_ms``, the sync's)
    plus the port's own, and the last row has no ``gap_ms`` (JAX
    ``tests/test_overlap.py:83``)."""
    res, j_res = against_jax
    rows, j_rows = res["round_timings"], j_res["round_timings"]
    assert len(rows) == len(j_rows) == RUN["epochs_global"]
    for row, j_row in zip(rows, j_rows):
        assert set(row) == set(j_row) | PORT_ROW_KEYS
    assert "gap_ms" not in rows[-1] and "gap_ms" not in j_rows[-1]
    assert all(r["gap_ms"] >= 0 for r in rows[:-1])
