"""Heterogeneity-aware adaptive data partitioning + non-IID injection.

A copy of the JAX package's ``data/partition.py:1-268`` (numpy only), kept
here so the port imports nothing from the JAX package.

Pure host-side numpy with explicit seeded RNGs (the reference uses global
``np.random`` state — ``Balanced All-Reduce/dataloader.py:93,99``; seeding
here is what makes the semantics testable).

Capabilities reproduced:

- **Proportional contiguous partition**: worker ``i`` receives a contiguous
  slice of size ``total * ratio_i`` (``Balanced All-Reduce/dataloader.py:
  53-75``).  The reference's ratios are ``duration_i / sum(durations)`` —
  i.e. SLOWER workers get MORE data (defect, SURVEY.md 2.5.1).  The
  proportionality function is pluggable here: ``inverse`` (sensible default,
  faster workers get more), ``direct`` (reference-compatible), ``uniform``.
- **Per-global-epoch re-partition**: a worker's next shard mixes
  ``prev_fraction`` of its own previous indices with ``next_fraction`` drawn
  from the remaining global pool (``dataloader.py:77-104``).  As in the
  reference, cross-worker overlap is possible after the first re-partition
  (each worker only excludes its own picks — SURVEY.md 2.5.5); this is
  deliberate behavioral parity.
- **Non-IID fixed-class injection**: worker ``rank`` is pinned to classes
  ``[(2*rank) % C, (2*rank + 1) % C]`` and ``fixed_ratio`` of its shard is
  forced to those classes, with replacement top-up from the whole dataset,
  both at the initial partition and at every re-partition
  (``Disbalanced All-Reduce/dataloader.py:56-155``).
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# Proportionality: probe durations -> per-worker share
# --------------------------------------------------------------------------

def efficiency_ratios(durations: np.ndarray, mode: str = "inverse") -> np.ndarray:
    """Map per-worker probe durations to shard-share ratios (sum to 1).

    ``direct``  — ratio_i = d_i / sum(d)   (reference formula,
                  ``Balanced All-Reduce/dataloader.py:149-151``: slower
                  workers get MORE data);
    ``inverse`` — ratio_i ~ (1/d_i), so faster workers get more (the
                  load-balancing intent, default);
    ``uniform`` — equal shares regardless of the probe.
    """
    d = np.asarray(durations, np.float64)
    if np.any(d <= 0):
        raise ValueError("probe durations must be positive")
    if mode == "direct":
        r = d
    elif mode == "inverse":
        r = 1.0 / d
    elif mode == "uniform":
        r = np.ones_like(d)
    else:
        raise ValueError(f"unknown proportionality mode {mode!r}")
    return r / r.sum()


def contiguous_partition(total_size: int, ratios: np.ndarray) -> list[np.ndarray]:
    """Slice ``range(total_size)`` into per-worker contiguous index blocks of
    size ``int(total * ratio_i)`` (ref dataloader.py:53-75; the int() floor
    can leave a small unassigned tail, as in the reference)."""
    out, start = [], 0
    for ratio in np.asarray(ratios, np.float64):
        n = int(total_size * ratio)
        out.append(np.arange(start, start + n))
        start += n
    return out


def adaptive_partition(total_size: int, ratios: np.ndarray, *,
                       labels: np.ndarray | None = None,
                       fixed_classes: list | None = None,
                       fixed_ratio: float = 0.5,
                       rng: np.random.Generator | None = None
                       ) -> list[np.ndarray]:
    """Full adaptive partition draw: proportional contiguous blocks plus
    the optional non-IID skew overlay — the initial-partition recipe the
    driver runs at round 0, packaged so a MEMBERSHIP BOUNDARY can re-draw
    it identically (elastic membership: on a worker kill the departed shard
    redistributes through the survivors' re-drawn shares; on a join the
    newcomer's share is carved out of everyone's).  ``fixed_classes`` is
    per-worker (ordered like ``ratios``); skew draws consume ``rng`` in
    worker order, train set before val set when the caller partitions
    both."""
    parts = contiguous_partition(total_size, ratios)
    if fixed_classes is not None:
        if labels is None or rng is None:
            raise ValueError(
                "disbalanced adaptive_partition needs labels and rng for "
                "the skew draws")
        parts = [skew_partition(labels, p, fixed_classes[i], fixed_ratio,
                                rng)
                 for i, p in enumerate(parts)]
    return parts


# --------------------------------------------------------------------------
# Re-partition (balanced)
# --------------------------------------------------------------------------

def repartition(total_size: int, prev_indices: np.ndarray, ratio: float,
                prev_fraction: float, next_fraction: float,
                rng: np.random.Generator, *, replace: bool = False) -> np.ndarray:
    """One worker's next-epoch shard (ref dataloader.py:77-104).

    size = int(total * ratio); take ``int(size * prev_fraction)`` sampled from
    the worker's previous indices, and ``int(size * next_fraction)`` from the
    global pool minus those picks.  ``replace`` mirrors the reference split:
    False for balanced (``Balanced .../dataloader.py:93,99``), True for
    disbalanced (``Disbalanced .../dataloader.py:123,129``).
    """
    node_points = int(total_size * ratio)
    prev_size = int(node_points * prev_fraction)
    next_size = int(node_points * next_fraction)
    prev_indices = np.asarray(prev_indices)
    if not replace:
        prev_size = min(prev_size, len(prev_indices))
    prev_pick = rng.choice(prev_indices, size=prev_size, replace=replace) \
        if len(prev_indices) else np.empty(0, np.int64)
    remaining = np.setdiff1d(np.arange(total_size), prev_pick,
                             assume_unique=False)
    next_pick = rng.choice(remaining, size=next_size, replace=replace)
    return np.concatenate([prev_pick, next_pick]).astype(np.int64)


# --------------------------------------------------------------------------
# Non-IID (disbalanced) partitioning
# --------------------------------------------------------------------------

def fixed_classes_for_rank(rank: int, num_classes: int = 10) -> list[int]:
    """Per-worker pinned classes (Disbalanced .../dataloader.py:77-78)."""
    return [(rank * 2) % num_classes, ((rank * 2) + 1) % num_classes]


def skew_partition(labels: np.ndarray, base_indices: np.ndarray,
                   fixed_classes: list[int], fixed_ratio: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Force ``fixed_ratio`` of a shard to the pinned classes
    (Disbalanced .../dataloader.py:80-103).

    Within the base shard, split indices into fixed-class and other; if the
    fixed count falls short of ``round(len(base) * fixed_ratio)``, top up by
    sampling (with replacement) fixed-class points from the WHOLE dataset not
    already in the shard; then trim the excess from the tail of the
    other-class indices and shuffle.
    """
    base = np.asarray(base_indices)
    is_fixed = np.isin(labels[base], fixed_classes)
    fixed_idx = list(base[is_fixed])
    other_idx = list(base[~is_fixed])
    want = int(round(len(base) * fixed_ratio))
    if len(fixed_idx) < want:
        pool = np.setdiff1d(np.where(np.isin(labels, fixed_classes))[0], base)
        if len(pool):
            extra = rng.choice(pool, size=want - len(fixed_idx), replace=True)
            fixed_idx.extend(extra.tolist())
    excess = len(fixed_idx) + len(other_idx) - len(base)
    if excess > 0:
        other_idx = other_idx[:-excess] if excess <= len(other_idx) else []
    final = np.asarray(fixed_idx + other_idx, np.int64)
    rng.shuffle(final)
    return final


def skew_repartition(labels: np.ndarray, indices: np.ndarray,
                     fixed_classes: list[int], fixed_ratio: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Maintain the skew after a re-partition
    (Disbalanced .../dataloader.py:134-153): if the fresh shard has fewer
    fixed-class points than ``int(len * fixed_ratio)``, replace non-fixed
    entries (from the tail) with replacement-sampled fixed-class points drawn
    from outside the shard."""
    final = np.asarray(indices).copy()
    have = int(np.isin(labels[final], fixed_classes).sum())
    want = int(len(final) * fixed_ratio)
    if have >= want:
        rng.shuffle(final)
        return final
    need = want - have
    replaceable = np.where(~np.isin(labels[final], fixed_classes))[0]
    pool = np.setdiff1d(np.where(np.isin(labels, fixed_classes))[0], final)
    if len(pool) == 0 or len(replaceable) == 0:
        rng.shuffle(final)
        return final
    need = min(need, len(replaceable))
    repl = rng.choice(pool, size=need, replace=True)
    # replace from the tail, matching the reference's pop() order
    final[replaceable[::-1][:need]] = repl
    rng.shuffle(final)
    return final


# --------------------------------------------------------------------------
# Step budgeting: unequal shards -> one SPMD program
# --------------------------------------------------------------------------

def step_budget(shard_sizes: list[int], batch_size: int) -> int:
    """Fixed per-round step count = max batches over workers (ceil).

    The reference lets every worker run a different number of batches; SPMD
    collectives need one program, so all workers run the max and padding
    steps are masked out (SURVEY.md section 7.3 'Unequal shard sizes vs
    SPMD')."""
    return max(
        (int(np.ceil(s / batch_size)) for s in shard_sizes), default=0)


def budget_from_time_limit(own_batches: int, probe_sec_per_batch: float,
                           time_limit: float) -> int:
    """Straggler protocol as a step budget: a worker trains at most
    ``time_limit`` seconds' worth of batches past its own shard, replacing
    the reference's fragile finish-flag/grace-timer collective pairing
    (``Balanced All-Reduce/trainer.py:42-44,112-139``; SURVEY.md 2.5.4)."""
    if probe_sec_per_batch <= 0:
        return own_batches
    cap = int(time_limit / probe_sec_per_batch)
    return min(own_batches, max(cap, 1))


def pack_window(images: np.ndarray, labels: np.ndarray, indices: np.ndarray,
                batch_size: int, start_step: int, num_steps: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialize steps [start_step, start_step + num_steps) of one
    worker's epoch as fixed-shape arrays.

    Returns (x [num_steps, B, ...], y [num_steps, B, ...], mask
    [num_steps, B]) where mask is 0 for padding examples.  Padding wraps
    around the worker's own real samples so every step has the same shape
    without skewing batch statistics toward one sample; the mask zeroes
    loss/metric contributions.
    """
    idx = np.asarray(indices)
    n = len(idx)
    lo = start_step * batch_size
    pos = np.arange(lo, lo + num_steps * batch_size)
    if n == 0:
        take = np.zeros(len(pos), np.int64)
        mask = np.zeros(len(pos), np.float32)
    else:
        # real sample at positions < n; beyond that, wrap over own samples
        take = np.where(pos < n, idx[np.minimum(pos, n - 1)],
                        idx[(pos - n) % n])
        mask = (pos < n).astype(np.float32)
    x = images[take].reshape(num_steps, batch_size, *images.shape[1:])
    # labels may be per-example scalars (classification) or per-token
    # sequences [L] (MLM) — keep any trailing label dims
    y = labels[take].reshape(num_steps, batch_size, *labels.shape[1:])
    return x, y, mask.reshape(num_steps, batch_size)
