"""A spawned rank of the port with one rank's measured round walls pinned
(tests/test_torch_grid_stragglers.py): on world rank ``SLOW_RANK``, in a
run whose walls are measured (no ``simulated_round_durations``), rounds
``SLOW_ROUNDS`` report ``SLOW_S`` seconds more than they took.  The
round itself is not slowed: the rank's clock starts earlier."""

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver,
    train,
)

SLOW_RANK = 3              # data=3,model=2: worker 1's second rank
SLOW_ROUNDS = (1, 2)
SLOW_S = 100.0


def slow_rank_entry(rank: int, world_size: int, cfg, store_path: str,
                    timeout_s: float, train_kwargs, generation: int,
                    snapshot_dir) -> None:
    """``driver.rank_entry`` with the wall of ``SLOW_RANK`` pinned."""
    measured = not (train_kwargs or {}).get("simulated_round_durations")
    if rank == SLOW_RANK and measured:
        run_round = train.LocalSGDEngine._run_round

        def pinned(self, state, t_round, *args):
            if state.lr_epoch in SLOW_ROUNDS:
                t_round -= SLOW_S
            return run_round(self, state, t_round, *args)
        train.LocalSGDEngine._run_round = pinned
    driver.rank_entry(rank, world_size, cfg, store_path, timeout_s,
                      train_kwargs, generation, snapshot_dir)
