"""BatchNorm with flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
dtype=...)`` semantics on NCHW activations (any memory format).

Two differences from ``torch.nn.BatchNorm2d`` matter for parity with the
JAX package, so the running statistics are not left to torch:

- flax stores the *biased* batch variance in its running average, where
  torch's running-stat update stores the unbiased one;
- flax's ``momentum`` is the weight of the old average:
  ``ra <- 0.9 * ra + 0.1 * batch``.

Train mode normalises with the batch's biased statistics (statistics over
the whole batch, padding rows included, as flax computes them) and updates
the running mean and biased variance itself, without gradient, from an
fp32 copy of the activation (flax computes them in fp32 too, by
``E[x^2] - E[x]^2``; ``torch.var_mean`` differs from that by rounding).
Eval mode normalises with the running statistics.  Parameters and
statistics are fp32; the output is in the input's (compute) dtype.

Inside ``running_stats_out()`` a train-mode forward leaves its buffers
alone and puts the new running statistics in the yielded dict instead, by
module (the same ``lerp``, out of place): under ``torch.func`` the buffers
of a vmapped step are stacked inputs, so the scenario lab (``sim.py``)
takes the statistics as outputs and writes (or gates) them itself.  There
(in both modes) the normalisation runs on an fp32 copy of the input and is
rounded once to the input dtype: functorch's batch rule for stacked
statistics and affine weights refuses a bf16 input with fp32 statistics
and promotes a stacked affine's output to fp32, mixing dtypes in its
backward.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

# the dict of ``running_stats_out()`` while it is open, else None
_STATS_OUT: Optional[dict] = None


@contextlib.contextmanager
def running_stats_out() -> Iterator[dict]:
    """Within the block, train-mode ``BatchNorm`` forwards put their new
    ``(running_mean, running_var)`` in the yielded dict (keyed by module)
    instead of updating their buffers, and every ``BatchNorm`` normalises
    an fp32 copy of its input (the vmapped step's form)."""
    global _STATS_OUT
    outer, _STATS_OUT = _STATS_OUT, {}
    try:
        yield _STATS_OUT
    finally:
        _STATS_OUT = outer


class BatchNorm(nn.Module):
    """``weight``/``bias`` are flax's ``scale``/``bias``;
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if _STATS_OUT is not None:      # the vmapped step (see below)
                return F.batch_norm(x.float(), self.running_mean,
                                    self.running_var, self.weight,
                                    self.bias, False, 0.0,
                                    self.eps).to(x.dtype)
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.float()
        with torch.no_grad():
            var, mean = torch.var_mean(xf, (0, *range(2, x.ndim)),
                                       correction=0)
            w = 1.0 - self.momentum
            if _STATS_OUT is None:
                self.running_mean.lerp_(mean, w)
                self.running_var.lerp_(var, w)
            else:
                _STATS_OUT[self] = (torch.lerp(self.running_mean, mean, w),
                                    torch.lerp(self.running_var, var, w))
        # no running buffers given: torch normalises with the batch's
        # biased statistics and updates nothing
        if _STATS_OUT is not None:
            # the vmapped step: functorch batches an affine with stacked
            # weights as a separate multiply-add that promotes the output
            # to fp32, and its backward then mixes dtypes; normalising the
            # fp32 copy keeps every dtype explicit and rounds once, to the
            # input dtype, as the fused kernel does
            return F.batch_norm(xf, None, None, self.weight, self.bias,
                                True, 0.0, self.eps).to(x.dtype)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)
