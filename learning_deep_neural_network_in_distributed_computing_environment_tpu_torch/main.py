"""CLI entry point of the PyTorch port (JAX package: ``main.py:21-55``).

Run flow: config -> ``train_global`` (probe, partition, local-SGD rounds)
-> rank-0 test evaluation with P/R/F1 -> the six plots.  Runs on CUDA
unless ``--device cpu`` is given.

Example::

    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.main \
        --model gpt2_small --dataset synthetic_lm --attention_impl flash
"""

from __future__ import annotations

import logging
import sys


def run(argv=None) -> dict:
    """Train, evaluate and plot; returns the driver's results with the test
    evaluation under ``results["test_eval"]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        raise NotImplementedError(
            "`main serve` is not ported to the PyTorch package yet; serving "
            "arrives with ROADMAP queue A.10")
    from .config import config_from_args
    cfg = config_from_args(argv)
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from . import viz
    from .driver import train_global
    from .eval import evaluate

    results = train_global(cfg)
    test = results["test"]
    loss, acc, _preds, _labels, metrics = evaluate(
        results["model"], results["variables"], test.images, test.labels,
        cfg.batch_size, rank=0)
    results["test_eval"] = dict(loss=loss, accuracy=acc, **metrics)
    viz.write_all(results, len(results["global_train_losses"]),
                  cfg.epochs_local, cfg.out_dir)
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
