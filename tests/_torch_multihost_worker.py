"""A launched process of the port for tests/test_torch_multihost.py — NOT a
pytest module (the counterpart of tests/_multihost_worker.py).

Reads its launch from JAX's three variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) and its run from ``MH_CASE``
(a key of ``CASES``), ``MH_CKPT_DIR`` (its ``--checkpoint_dir``),
``MH_INIT`` (a pickled ``state_dict`` to start from, optional) and
``MH_OUT`` (a directory: each rank of a flat run writes its final
checkpoint row there, ``rank<r>.pkl``).  Runs ``driver.run_launched`` on
the CPU with one intra-op thread per rank and the probe and the walls
pinned, and prints ``MHRESULT <json>``: its view of the run's metrics.
"""

import functools
import json
import operator
import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (  # noqa: E402
    checkpoint,
    driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (  # noqa: E402
    Config,
)

# JAX tests/_multihost_worker.py's run, on 4 workers
FLAT = dict(model="mlp", dataset="mnist", epochs_global=2, epochs_local=1,
            batch_size=8, limit_train_samples=320, limit_eval_samples=64,
            compute_dtype="float32", augment=False, aggregation_by="weights",
            seed=0, num_workers=4)
# a tiny transformer's grid: 2 worker blocks of 2 tensor-parallel ranks
GRID = dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=2,
            epochs_local=1, batch_size=8, limit_train_samples=96,
            limit_eval_samples=32, compute_dtype="float32", augment=False,
            aggregation_by="weights", seed=1, probe_batches=1,
            mesh_shape="data=2,model=2")
CASES = {"flat": FLAT, "grid": GRID}
PROBE = {"flat": [0.2, 0.3, 0.25, 0.35], "grid": [0.02, 0.03]}
# seconds per worker and round; the flat run's time limit of 0.2 s caps
# every worker's steps below its shard's from the probe on
WALLS = {"flat": [[0.4, 0.9, 0.5, 0.7], [0.6, 0.5, 0.8, 0.4]],
         "grid": [[0.02, 0.03], [0.03, 0.02]]}
TIME_LIMIT = {"flat": 0.2, "grid": 60.0}


def config(case: str, ckpt_dir: str = "") -> Config:
    """The run of ``case`` on the CPU, saving every round into
    ``ckpt_dir`` when given."""
    return Config(device="cpu", log_level="WARNING",
                  time_limit=TIME_LIMIT[case], checkpoint_dir=ckpt_dir,
                  checkpoint_every=1 if ckpt_dir else 0, **CASES[case])


def train_kwargs(case: str, init=None) -> dict:
    """The driver's arguments: the probe and the walls pinned, and the
    starting parameters when given."""
    kw = dict(simulated_durations=PROBE[case], progress=False,
              simulated_round_durations=functools.partial(
                  operator.getitem, WALLS[case]))
    if init is not None:
        kw["initial_state_dict"] = init
    return kw


def final_row(results: dict) -> dict:
    """A flat run's final checkpoint row of this rank, by JAX key path."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
        LocalSGDEngine,
    )
    engine = LocalSGDEngine(results["model"], Config(device="cpu"),
                            torch.device("cpu"))
    return checkpoint.jax_leaves(checkpoint.snapshot(
        engine.checkpoint_state(results["state"])))


def _save_row(rank: int, results: dict) -> None:
    out = os.environ.get("MH_OUT", "")
    if out and os.environ.get("MH_CASE") == "flat":
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(final_row(results), f)


def row_rank_entry(rank: int, world_size: int, cfg, store, timeout_s: float,
                   train_kwargs, generation: int, snapshot_dir) -> None:
    """``driver.rank_entry`` that keeps the rank's final row."""
    res = driver.train_rank(rank, world_size, store, timeout_s, cfg,
                            train_kwargs, generation=generation,
                            snapshot_dir=snapshot_dir)
    _save_row(rank, res)


def main() -> None:
    torch.set_num_threads(1)        # one intra-op thread per rank
    case = os.environ["MH_CASE"]
    init = None
    if os.environ.get("MH_INIT"):
        with open(os.environ["MH_INIT"], "rb") as f:
            init = pickle.load(f)
    import _torch_multihost_worker as me     # a target spawn can import
    res = driver.run_launched(config(case, os.environ.get("MH_CKPT_DIR", "")),
                              train_kwargs=train_kwargs(case, init),
                              target=me.row_rank_entry)
    _save_row(res["launch"]["ranks"][0], res)
    print("MHRESULT " + json.dumps({
        "process": res["launch"]["process_id"], "launch": res["launch"],
        "round_flow": res["round_flow"],
        **{k: res[k] for k in ("global_train_losses", "global_val_losses",
                               "all_workers_losses", "step_caps",
                               "shard_sizes", "param_checksums")},
        "workers_wall_s": [r["workers_wall_s"]
                           for r in res["round_timings"]],
        "grid": ({"axes": res["grid"]["axes"],
                  "coords": res["grid"]["coords"]}
                 if "grid" in res else None),
    }), flush=True)


if __name__ == "__main__":
    main()
