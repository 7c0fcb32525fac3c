"""Serving (port of the JAX package's ``serve/``): continuous-batching
inference off the sharded checkpoints.

- ``engine``    — ``ServeEngine``: the paged KV pools, the fixed-shape
  prefill (per bucket, or one chunk shape) and decode programs, a draft
  engine's pairing and the ``[B, k+1]`` verify of speculative decoding,
  and ``from_checkpoint`` (worker 0's params, streamed shard by shard);
- ``cache``     — host-side page bookkeeping: the refcounted,
  content-addressed ``PageAllocator`` (page 0 is the trash page),
  ``page_prefix_keys``, page-table rows, ``paired_admit`` (a speculative
  pair's all-or-nothing admission across both pools);
- ``scheduler`` — ``ContinuousBatchingScheduler``: admission and eviction
  per decode step, all-or-nothing page claims, EOS/budget/timeout stops,
  prefix reuse, chunked prefill, the speculation tick, telemetry;
- ``api``       — ``main serve`` / ``run_serve``.

The decode math (paged attention, the cache-offset causal mask, sampling
seeded by request and position) is ``models/decode.py``.
"""

from .cache import (PageAllocator, page_prefix_keys, page_table_row,
                    pages_needed, paired_admit)
from .engine import ServeEngine
from .scheduler import Completion, ContinuousBatchingScheduler, Request

__all__ = ["ServeEngine", "ContinuousBatchingScheduler", "Request",
           "Completion", "PageAllocator", "page_prefix_keys",
           "page_table_row", "pages_needed", "paired_admit"]
