"""Static-shape batching for the final evaluation (a copy of the JAX
package's ``utils/batching.py:24-45``): the last ragged batch pads by
repeating the final real example and the mask zeroes its loss, metric and
prediction contributions, so tail examples cannot skew the metrics.
"""

from __future__ import annotations

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
