"""CLI entry point of the PyTorch port (JAX package: ``main.py:21-55``).

Run flow: config -> ``train_global`` (probe, partition, local-SGD rounds;
checkpoints with ``--checkpoint_dir``, ``--resume``) -> rank-0 test
evaluation with P/R/F1 -> the six plots.  ``main serve --checkpoint_dir
D`` instead serves requests off a checkpoint (``serve/api.py``), with a
draft checkpoint for speculative decoding under ``--serve_draft_ckpt``;
``--stream_chunk_steps C`` streams each round in windows of C steps.
Runs on CUDA unless ``--device cpu`` is given.

With ``--sim_workers N`` the N workers run in this one process as the
scenario lab (``sim.py``: stacked state, one vmapped step for all).

With ``--num_workers N`` (N > 1) the run is N processes, one local-SGD
worker each, in a gloo group (``mesh.py``): ranks 1..N-1 are spawned, rank
0 runs in the calling process and returns the results, evaluates and
plots.  With ``--mesh_shape data=D,fsdp=F,model=T`` each worker is F x T
processes (ZeRO-3 over fsdp, tensor parallelism over model): D x F x T
ranks in all, on the rank grid of ``mesh.make_grid``.  With ``--num_slices
S`` the run is S x ``--num_workers`` processes and the round's sync is the
hierarchical one (``comms.hierarchical_sync``).  A child that fails
makes the run raise (a dead peer ends the
others' collectives at the group timeout, never in a hang).  Under
``--chaos`` the group is elastic: each membership boundary re-forms it on
the new roster (``elastic.py``), spawning joiners and retiring surplus
ranks; the calling process stays rank 0.

Across hosts (JAX ``mesh.initialize_distributed``): start the same
command on every host with ``JAX_COORDINATOR_ADDRESS=host:port`` (process
0's host), ``JAX_NUM_PROCESSES=P`` and ``JAX_PROCESS_ID=p`` set.  The P
processes meet there (``mesh.Launch``, a ``TCPStore``) and make one world
of the mesh's ranks, process-major: each process runs its first rank and
spawns its others (``driver.run_launched``); the round flow is serial.
Every process returns the run's results; only process 0 evaluates on the
test set and writes the plots.  ``--sim_workers``, ``--chaos`` and a
worker count the process count does not divide are refused.  ``--resume``
needs a ``--checkpoint_dir`` every host shares (each rank writes its own
shard there, and every rank the manifest).

Examples::

    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --model gpt2_small --dataset synthetic_lm --attention_impl flash
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --num_workers 4 --aggregation_by weights --topology double_ring
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --sim_workers 8 --aggregation_by weights --topology double_ring
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --model gpt2_small --dataset synthetic_lm --attention_impl flash \
        --mesh_shape data=2,model=2
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --mesh_shape data=2,fsdp=2
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --num_slices 2 --num_workers 2 --topology ring --aggregation_by \
        weights --sync_dtype_outer int8 --sync_compression ef
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --model gpt2_small --dataset synthetic_lm --attention_impl flash \
        --checkpoint_dir ckpt --checkpoint_every 1
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        serve --checkpoint_dir ckpt --serve_max_batch 8
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        serve --checkpoint_dir ckpt --serve_draft_ckpt draft --serve_spec_tokens 4
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --model vit_s16 --dataset imagenet --stream_chunk_steps 2
    # on host A (10.0.0.1) and on host B, 2 processes x 2 workers:
    JAX_COORDINATOR_ADDRESS=10.0.0.1:1234 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=0 python -m \
        learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --num_workers 4 --aggregation_by weights --checkpoint_dir /shared/ck
    JAX_COORDINATOR_ADDRESS=10.0.0.1:1234 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=1 python -m \
        learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --num_workers 4 --aggregation_by weights --checkpoint_dir /shared/ck
"""

from __future__ import annotations

import contextlib
import logging
import sys


def _config(argv):
    from .config import config_from_args
    cfg = config_from_args(argv)
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    return cfg


def _ranks(cfg) -> int:
    """The run's processes: one under --sim_workers, else one per rank of
    the grid (slice x data x fsdp x seq x model)."""
    from . import mesh
    return 1 if cfg.sim_workers else mesh.world_size_of(mesh.grid_axes(cfg))


def run(argv=None, elastic_snapshot=None) -> dict:
    """Train, evaluate and plot; returns the driver's results with the test
    evaluation under ``results["test_eval"]``.  ``serve ...`` serves off a
    checkpoint instead and returns ``serve.api.run_serve``'s result.
    ``elastic_snapshot``: a ``MembershipSnapshot`` of an earlier run (its
    ``results["elastic"]["snapshots"]``) to continue from, on its roster:
    the fresh twin of that run's boundary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from .serve.api import serve_main
        return serve_main(argv[1:])
    cfg = _config(argv)
    from . import mesh
    from .driver import check_launch, run_group, run_launched, train_global

    launch = mesh.launch_from_env()
    if launch is not None:
        # one process of a launched world; only process 0 evaluates and
        # plots (JAX main.py:46)
        check_launch(cfg, launch, elastic_snapshot)
        results = run_launched(cfg, launch=launch, target=_worker)
        return _finish(cfg, results) if launch.process_id == 0 else results
    n = _ranks(cfg)
    if elastic_snapshot is not None or (cfg.chaos and not cfg.sim_workers):
        # elastic membership regroups processes: always a group
        results = run_group(cfg, n, elastic_snapshot=elastic_snapshot,
                            target=_worker)
    elif n == 1:
        results = train_global(cfg)
    else:
        results = run_group(cfg, n, target=_worker)
    return _finish(cfg, results)


@contextlib.contextmanager
def run_shared(jobs: list):
    """``run`` of several launch lines of one process count from ONE start
    of their ranks (``driver.SharedStart``): yields a function that runs
    the next job and returns what ``run`` returns (rank 0 here, then its
    evaluation and plots).  A job is a launch line (a list of flags, or
    ``(flags, train_kwargs)`` with ``train_global``'s keyword arguments)
    or a spawn target of the port with its arguments after the store path,
    ``(fn, args)``, which every rank calls in turn (the function then
    returns None).  Each launch line keeps its own gloo group, results and
    checks; only the processes are shared."""
    from .config import Config
    from .driver import SharedStart
    parsed = []
    for job in jobs:
        if isinstance(job, list):
            job = (job, None)
        parsed.append((_config(list(job[0])), job[1])
                      if isinstance(job[0], list) else job)
    cfgs = [j[0] for j in parsed if isinstance(j[0], Config)]
    counts = {_ranks(c) for c in cfgs}
    if len(counts) != 1 or counts == {1}:
        raise ValueError(
            f"a shared start runs launch lines of one process count > 1; "
            f"got {sorted(_ranks(c) for c in cfgs)}")
    with SharedStart(counts.pop(), parsed, target=_worker) as group:
        job_iter = iter(parsed)

        def next_job():
            first, _rest = next(job_iter)
            results = group.run()
            return (_finish(first, results) if isinstance(first, Config)
                    else None)
        yield next_job


def _finish(cfg, results: dict) -> dict:
    """Rank 0's test evaluation and the six plots of a run."""
    from . import viz
    from .eval import evaluate
    test = results["test"]
    loss, acc, _preds, _labels, metrics = evaluate(
        results["model"], results["variables"], test.images, test.labels,
        cfg.batch_size, rank=0)
    results["test_eval"] = dict(loss=loss, accuracy=acc, **metrics)
    viz.write_all(results, len(results["global_train_losses"]),
                  cfg.epochs_local, cfg.out_dir)
    return results


def _worker(rank: int, world_size: int, cfg, store_path: str,
            timeout_s: float, train_kwargs, generation: int,
            snapshot_dir) -> None:
    """A spawned rank of ``main.run``: the same config, its own worker
    (``driver.rank_entry`` with the rank in its log lines)."""
    from .driver import rank_entry
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format=f"%(asctime)s rank {rank} %(name)s %(levelname)s: "
               "%(message)s")
    rank_entry(rank, world_size, cfg, store_path, timeout_s, train_kwargs,
               generation, snapshot_dir)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
