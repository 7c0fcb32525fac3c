"""Static-shape batching shared by the final evaluation and the serving
engine (a copy of the JAX package's ``utils/batching.py``):

- ``pad_to_batches`` — the last ragged batch pads by repeating the final
  real example and the mask zeroes its loss, metric and prediction
  contributions, so tail examples cannot skew the metrics;
- ``pick_bucket`` / ``pad_to_bucket`` — prompt-length bucketing for the
  serve prefill: a prompt runs at the smallest covering bucket, so the
  engine dispatches one prefill shape per bucket, not per prompt length.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_to_batches(x: np.ndarray, y: np.ndarray, batch_size: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``(x, y)`` of n examples up to whole ``batch_size`` batches.

    Returns ``(x [steps, B, ...], y [steps, B, ...], mask [steps, B])``
    with mask 0.0 on padding rows.  Padding repeats the last real example
    (values stay in-domain for embedding lookups); the mask is the
    correctness boundary — consumers must weight per-example stats by it
    and slice predictions back to n.
    """
    n = len(y)
    if n == 0 or batch_size < 1:
        raise ValueError(
            f"pad_to_batches needs n >= 1 examples and batch_size >= 1, "
            f"got n={n}, batch_size={batch_size}")
    steps = -(-n // batch_size)
    total = steps * batch_size
    take = np.minimum(np.arange(total), n - 1)
    mask = (np.arange(total) < n).astype(np.float32)
    xs = np.take(x, take, axis=0).reshape(steps, batch_size, *x.shape[1:])
    ys = np.take(y, take, axis=0).reshape(steps, batch_size, *y.shape[1:])
    return xs, ys, mask.reshape(steps, batch_size)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """The smallest bucket covering ``length`` (buckets ascending)."""
    for b in buckets:
        if length <= b:
            return int(b)
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket "
        f"{max(buckets)} — extend --serve_prompt_buckets")


def pad_to_bucket(ids: np.ndarray, bucket: int, fill: int = 0
                  ) -> np.ndarray:
    """``ids [n]`` right-padded with ``fill`` to ``[bucket]`` (int32).  The
    prefill routes the padding rows' cache writes to the trash page by its
    valid count, so ``fill`` only needs to be a legal token id."""
    ids = np.asarray(ids, np.int32)
    if ids.ndim != 1 or len(ids) > bucket:
        raise ValueError(
            f"pad_to_bucket needs a 1-D prompt of <= {bucket} ids, got "
            f"shape {ids.shape}")
    out = np.full(bucket, fill, np.int32)
    out[:len(ids)] = ids
    return out
