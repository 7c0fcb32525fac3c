"""Data subsystem: sources (real-or-synthetic datasets) and the
heterogeneity-adaptive partitioner with non-IID injection."""

from .sources import Dataset, load_dataset, train_val_split  # noqa: F401
from .partition import (  # noqa: F401
    adaptive_partition,
    budget_from_time_limit,
    efficiency_ratios,
    fixed_classes_for_rank,
    pack_window,
    repartition,
    skew_repartition,
    step_budget,
    window_feed,
)
