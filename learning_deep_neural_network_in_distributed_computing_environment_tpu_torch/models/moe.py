"""Switch-style Mixture-of-Experts FFN (port of the dense twin of the JAX
package's ``models/moe.py:42-137``: ``ep_size=1``, no expert axis).

Top-1 routing with a capacity limit, as dispatch/combine products over a
one-hot [tokens, experts, capacity] tensor:

- the gate (fp32, no bias) scores every token against the ``num_experts``
  experts; softmax; each token goes to its ``argmax`` expert with weight
  ``gate = max prob`` (``torch.argmax`` and ``jnp.argmax`` both take the
  first of tied maxima);
- a token's place in its expert's queue is ``cumsum(onehot) - 1`` over the
  flattened ``b*t`` tokens in row-major order; an expert takes at most
  ``capacity = max(ceil(cf * tokens / experts), 1)`` tokens and drops the
  rest (the caller's residual carries a dropped token through);
- the Switch load-balance loss ``E * sum_e f_e * P_e`` (``f_e`` the share
  of tokens routed to expert e, ``P_e`` its mean probability) is returned
  beside the output; the engine adds ``moe_aux_weight`` times the sum over
  layers to the objective.  Flax sows it; returning it keeps a recomputed
  (remat) forward from counting it twice.

The dispatch, expert and combine products are plain einsums in the
compute dtype, as in the JAX package (no Pallas kernel there).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .remat import checkpoint_name

INIT_STD = 0.02


def _one_hot(idx: torch.Tensor, n: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot rows of ``idx`` in ``dtype`` (``F.one_hot`` checks its range
    with a device-to-host read on a card; a comparison needs none)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


class MoEFFN(nn.Module):
    """[B, T, H] -> ([B, T, H] in the compute dtype, fp32 aux loss)."""

    def __init__(self, hidden: int, num_experts: int, ffn_dim: int, *,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        e = num_experts
        self.gate = nn.Linear(hidden, e, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(e, hidden, ffn_dim, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, ffn_dim, device=device))
        self.w2 = nn.Parameter(torch.empty(e, ffn_dim, hidden, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, hidden, device=device))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers of the experts: N(0, 0.02) for the expert
        kernels, zeros for their biases.  The gate is an ``nn.Linear``,
        drawn by the model initializer's Linear branch."""
        for w in (self.w1, self.w2):
            w.normal_(0.0, INIT_STD, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def capacity(self, n_tok: int) -> int:
        return max(int(math.ceil(self.capacity_factor * n_tok
                                 / self.num_experts)), 1)

    def route(self, toks: torch.Tensor):
        """Top-1 routing of ``toks`` [N, H]: (probs [N, E] fp32, onehot
        [N, E] fp32, queue position [N] int, keep [N] fp32, capacity)."""
        probs = torch.softmax(F.linear(toks.float(), self.gate.weight), -1)
        onehot = _one_hot(probs.argmax(-1), self.num_experts)
        pos = ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1).int()
        cap = self.capacity(toks.shape[0])
        return probs, onehot, pos, (pos < cap).float(), cap

    def forward(self, x: torch.Tensor):
        b, t, h = x.shape
        dt = self.dtype
        toks = x.reshape(b * t, h)
        probs, onehot, pos, keep, cap = self.route(toks)
        gate = probs.max(-1).values
        aux = self.num_experts * (onehot.mean(0) * probs.mean(0)).sum()
        # [N, E, C]: token n in slot pos[n] of its expert, if kept; built
        # in the compute dtype, where 0 and 1 are exact
        dl = ((onehot * keep[:, None]).to(dt)[..., None]
              * _one_hot(pos.clamp(0, cap - 1), cap, dt)[:, None, :])
        xe = checkpoint_name(torch.einsum("nec,nh->ech", dl, toks.to(dt)),
                             "moe_dispatch")
        h1 = F.gelu(torch.einsum("ech,ehf->ecf", xe, self.w1.to(dt))
                    + self.b1[:, None, :].to(dt), approximate="none")
        ye = (torch.einsum("ecf,efh->ech", h1, self.w2.to(dt))
              + self.b2[:, None, :].to(dt))
        combine = dl * gate[:, None, None].to(dt)
        out = torch.einsum("nec,ech->nh", combine, ye)
        return out.reshape(b, t, h), aux
