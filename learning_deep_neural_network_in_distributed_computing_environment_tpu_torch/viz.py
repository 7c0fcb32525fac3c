"""Visualization: the reference's six plots, same filenames, same content
(``Balanced All-Reduce/vizualizator.py:9-133``).  A copy of the JAX
package's ``viz.py``; the port imports nothing from that package.

Output files in ``out_dir`` (default ``Graphs/``, ref default):
``loss_distribution_by_worker.png``, ``loss_distribution_per_epoch.png``,
``loss_distribution_per_epoch_global.png``,
``accuracy_distribution_per_epoch_global.png``, ``training_metrics.png``,
``training_metrics_{rank}.png``.

matplotlib is imported lazily with the Agg backend; if unavailable the data
is dumped to JSON next to where the PNG would go (headless parity).
"""

from __future__ import annotations

import json
from pathlib import Path


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:  # pragma: no cover - matplotlib is present in CI
        return None


def _fallback_json(path: Path, payload) -> None:
    with open(path.with_suffix(".json"), "w") as f:
        json.dump(payload, f, default=float)


def _ensure(out_dir: str) -> Path:
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    return p


def _boxplot(data, labels, title, xlabel, ylabel, path: Path):
    plt = _plt()
    if plt is None:
        _fallback_json(path, {"data": [list(map(float, d)) for d in data],
                              "labels": labels})
        return
    fig = plt.figure()
    fig.set_size_inches(16, 10)
    # empty groups crash matplotlib's boxplot; keep placeholders
    safe = [d if len(d) else [0.0] for d in data]
    plt.boxplot(safe, tick_labels=labels)
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.xticks(rotation=45)
    plt.grid(True)
    plt.savefig(path)
    plt.close(fig)


def plot_loss_distribution_by_worker(loss_data, output_folder="Graphs"):
    """Box plot of all per-batch losses per worker (ref vizualizator.py:9-24)."""
    out = _ensure(output_folder)
    _boxplot(loss_data, [f"Worker {i}" for i in range(len(loss_data))],
             "Loss Distribution per Worker", "Worker", "Loss",
             out / "loss_distribution_by_worker.png")


def plot_loss_distribution_per_epoch(loss_data, output_folder="Graphs"):
    """Box plot per (local) epoch across all workers (ref :27-41)."""
    out = _ensure(output_folder)
    _boxplot(loss_data, [f"Epoch {i + 1}" for i in range(len(loss_data))],
             "Loss Distribution Across All Workers Per Epoch", "Epoch",
             "Loss", out / "loss_distribution_per_epoch.png")


def plot_loss_distribution_per_epoch_global(loss_data, output_folder="Graphs"):
    """Box plot per global epoch (ref :43-57)."""
    out = _ensure(output_folder)
    _boxplot(loss_data, [f"Epoch {i + 1}" for i in range(len(loss_data))],
             "Loss Distribution Across All Workers Per Epoch", "Epoch",
             "Loss", out / "loss_distribution_per_epoch_global.png")


def plot_accuracy_distribution_per_epoch_global(acc_data,
                                                output_folder="Graphs"):
    """Box plot of per-local-epoch mean accuracies per global epoch
    (ref :59-73)."""
    out = _ensure(output_folder)
    _boxplot(acc_data, [f"Epoch {i + 1}" for i in range(len(acc_data))],
             "Accuracy Distribution Across All Workers Per Epoch", "Epoch",
             "Accuracy", out / "accuracy_distribution_per_epoch_global.png")


def _curves(epochs, series, path: Path, rank=None):
    plt = _plt()
    if plt is None:
        _fallback_json(path, {k: list(map(float, v)) for k, v in series.items()})
        return
    xs = list(range(1, epochs + 1))
    fig = plt.figure()
    fig.set_size_inches(16, 10)
    tag = "" if rank is None else f"Worker {rank} "
    fig.add_subplot(2, 1, 1)
    plt.plot(xs, series["train_loss"], "o-", label=f"{tag}Train Loss")
    plt.plot(xs, series["val_loss"], "o-", label=f"{tag}Validation Loss")
    plt.title("Individual Loss")
    plt.xlabel("Epochs")
    plt.ylabel("Loss")
    plt.legend()
    fig.add_subplot(2, 1, 2)
    plt.plot(xs, series["train_acc"], "o-", label=f"{tag}Train Accuracy")
    plt.plot(xs, series["val_acc"], "o-", label=f"{tag}Val Accuracy")
    plt.title("Individual Accuracy")
    plt.xlabel("Epochs")
    plt.ylabel("Accuracy")
    plt.legend()
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def plot_metrics_global(epochs, train_loss, train_accuracy, val_loss,
                        val_accuracy, output_folder="Graphs"):
    """Global train/val loss+accuracy curves (ref :75-103)."""
    out = _ensure(output_folder)
    _curves(epochs, dict(train_loss=train_loss, train_acc=train_accuracy,
                         val_loss=val_loss, val_acc=val_accuracy),
            out / "training_metrics.png")


def plot_metrics_total(epochs, train_loss, train_accuracy, val_loss,
                       val_accuracy, rank, output_folder="Graphs"):
    """Rank-tagged per-worker curves (ref :105-133)."""
    out = _ensure(output_folder)
    _curves(epochs, dict(train_loss=train_loss, train_acc=train_accuracy,
                         val_loss=val_loss, val_acc=val_accuracy),
            out / f"training_metrics_{rank}.png", rank=rank)


def write_all(results: dict, epochs_global: int, epochs_local: int,
              output_folder="Graphs") -> None:
    """Emit all six reference plots from a train_global results dict
    (ref main.py:65-77, rank-0 only)."""
    plot_metrics_global(len(results["global_train_losses"]),
                        results["global_train_losses"],
                        results["global_train_accuracies"],
                        results["global_val_losses"],
                        results["global_val_accuracies"], output_folder)
    plot_metrics_total(len(results["worker_specific_train_losses"]),
                       results["worker_specific_train_losses"],
                       results["worker_specific_train_accuracies"],
                       results["worker_specific_val_losses"],
                       results["worker_specific_val_accuracies"], 0,
                       output_folder)
    plot_loss_distribution_by_worker(results["all_workers_losses"],
                                     output_folder)
    plot_loss_distribution_per_epoch(results["all_epochs_losses"],
                                     output_folder)
    plot_loss_distribution_per_epoch_global(results["global_epoch_losses"],
                                            output_folder)
    plot_accuracy_distribution_per_epoch_global(
        results["global_epoch_accuracies"], output_folder)
