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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), (0, *range(2, x.ndim)),
                                       correction=0)
            self.running_mean.lerp_(mean, 1.0 - self.momentum)
            self.running_var.lerp_(var, 1.0 - self.momentum)
        # no running buffers given: torch normalises with the batch's
        # biased statistics and updates nothing
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)
