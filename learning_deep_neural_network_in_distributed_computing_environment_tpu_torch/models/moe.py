"""Switch-style Mixture-of-Experts FFN with expert parallelism over the
``expert`` axis and Megatron sharding over ``model`` (port of the JAX
package's ``models/moe.py``).

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

Under the rank grid (``ep``: the rank's ``expert`` line, ``tp``: its
``model`` line, ``mesh.Group``s; JAX ``moe.py:42-137``) a rank holds the
experts ``[e*E/ep, (e+1)*E/ep)`` of its expert coordinate e, each on the
F slice ``[t*F/tp, (t+1)*F/tp)`` of its model coordinate t (w1/b1
column-parallel, w2 row-parallel).  The gate, the softmax, the argmax,
the capacity, the aux loss and the ``[N, E, C]`` dispatch are computed on
the whole token set on every rank, then narrowed to the local experts;
``b2`` is scaled by 1/tp so the sum over ``model`` adds it once (its
gradient is summed over ``model`` by an f marker); the layer is one region
of ``parallel/ep.py``'s markers, the output summed over ``expert`` and
then ``model``.  ``ep_param_specs``, ``pp_ep_param_specs`` and
``with_expert_overlay`` name the dimension of each leaf, in the JAX
layout, that the ``expert`` axis shards.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import ep as ep_lib
from ..parallel.tp import copy_to_tp_region
from .remat import checkpoint_name

INIT_STD = 0.02


def _one_hot(idx: torch.Tensor, n: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot rows of ``idx`` in ``dtype`` (``F.one_hot`` checks its range
    with a device-to-host read on a card; a comparison needs none)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def check_shards(num_experts: int, ffn_dim: int, n_ep: int,
                 n_tp: int) -> None:
    """JAX's checks of an MoE layer's cut (``models/moe.py:71-79``), with
    its messages and in its order: the expert line divides the experts and
    the model line their FFN width; the layer and the config both call it."""
    if num_experts % n_ep:
        raise ValueError(f"num_experts {num_experts} not divisible by "
                         f"expert-parallel size {n_ep}")
    if ffn_dim % n_tp:
        raise ValueError(f"ffn_dim {ffn_dim} not divisible by "
                         f"tp_size {n_tp} (column-parallel expert FFN)")


class MoEFFN(nn.Module):
    """[B, T, H] -> ([B, T, H] in the compute dtype, fp32 aux loss).

    ``num_experts`` and ``ffn_dim`` are the global counts; ``ep`` / ``tp``
    (the rank's expert and model lines, None: dense) choose the rank's
    slice of them."""

    def __init__(self, hidden: int, num_experts: int, ffn_dim: int, *,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, tp=None, ep=None,
                 device=None):
        super().__init__()
        e, n_ep, n_tp = num_experts, _size(ep), _size(tp)
        check_shards(e, ffn_dim, n_ep, n_tp)
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.tp, self.ep = tp, ep
        self.e_local = e // n_ep
        f_local = ffn_dim // n_tp
        self.gate = nn.Linear(hidden, e, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(self.e_local, hidden, f_local,
                                           device=device))
        self.b1 = nn.Parameter(torch.zeros(self.e_local, f_local,
                                           device=device))
        self.w2 = nn.Parameter(torch.empty(self.e_local, f_local, hidden,
                                           device=device))
        self.b2 = nn.Parameter(torch.zeros(self.e_local, hidden,
                                           device=device))

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
        # in the compute dtype, where 0 and 1 are exact; then this rank's
        # experts (JAX's dynamic_slice_in_dim)
        dl = ((onehot * keep[:, None]).to(dt)[..., None]
              * _one_hot(pos.clamp(0, cap - 1), cap, dt)[:, None, :])
        if self.ep is not None:
            dl = dl.narrow(1, self.ep.rank * self.e_local, self.e_local)
        xe = checkpoint_name(
            torch.einsum("nec,nh->ech", dl,
                         ep_lib.enter(toks, self.ep, self.tp).to(dt)),
            "moe_dispatch")
        h1 = F.gelu(torch.einsum("ech,ehf->ecf", xe, self.w1.to(dt))
                    + self.b1[:, None, :].to(dt), approximate="none")
        if self.tp is None:
            b2 = self.b2[:, None, :].to(dt)
        else:
            # row-parallel w2: each model rank adds b2 / tp, the sum
            # below adds it once
            b2 = (1.0 / self.tp.world_size) * copy_to_tp_region(
                self.b2, self.tp)[:, None, :].to(dt)
        ye = torch.einsum("ecf,efh->ech", h1, self.w2.to(dt)) + b2
        gate = ep_lib.enter(gate, self.ep, self.tp)
        combine = dl * gate[:, None, None].to(dt)
        out = ep_lib.leave(torch.einsum("nec,ech->nh", combine, ye),
                           self.ep, self.tp)
        return out.reshape(b, t, h), aux


def _size(group) -> int:
    return 1 if group is None else group.world_size


# ----------------------------------------------------------------------
# the expert axis's specs (JAX moe.py:140-210), on the JAX-layout leaves
# ----------------------------------------------------------------------

def _names(key: str) -> list[str]:
    return re.findall(r"\['([^']*)'\]", key)


def _is_expert_leaf(names: list[str]) -> bool:
    return "moe" in names and "gate" not in names


def ep_param_specs(shapes: dict, axis: str = "expert") -> dict:
    """{leaf key: spec} sharding the MoE expert stacks over ``axis`` (JAX
    ``ep_param_specs``): w1/b1/w2/b2 under any ``moe`` submodule on their
    expert dimension, the leading one or dim 1 behind the stacked
    ``layers`` dimension; the gate and everything else replicated."""
    out = {}
    for key, shape in shapes.items():
        names = _names(key)
        parts = [None] * len(shape)
        if _is_expert_leaf(names):
            parts[1 if "layers" in names else 0] = axis
        out[key] = tuple(parts)
    return out


def pp_ep_param_specs(shapes: dict, *, pipe_axis: str = "pipe",
                      axis: str = "expert") -> dict:
    """{leaf key: spec} under both pipeline and expert parallelism (JAX
    ``pp_ep_param_specs``): the stacked ``layers`` leaves shard their
    layer dimension over ``pipe_axis``, the expert stacks their expert
    dimension (dim 1 behind it) over ``axis``."""
    out = ep_param_specs(shapes, axis)
    for key, spec in out.items():
        if "layers" in _names(key):
            out[key] = (pipe_axis, *spec[1:])
    return out


def with_expert_overlay(specs: dict, axis: str = "expert") -> dict:
    """``specs`` (e.g. the Megatron specs of ``bert.tp_param_specs`` /
    ``pp_tp_param_specs``) with the MoE expert stacks' expert dimension
    (leading, or behind the ``layers`` dimension) also sharded over
    ``axis`` (JAX ``with_expert_overlay``): the EP x TP (x PP)
    composition."""
    out = {}
    for key, spec in specs.items():
        names = _names(key)
        if not _is_expert_leaf(names):
            out[key] = spec
            continue
        i = 1 if "layers" in names else 0
        parts = list(spec) + [None] * max(0, i + 1 - len(spec))
        if parts[i] is not None:
            raise ValueError(
                f"expert dim {i} of {'/'.join(names)} already sharded "
                f"over {parts[i]!r}")
        parts[i] = axis
        out[key] = tuple(parts)
    return out
