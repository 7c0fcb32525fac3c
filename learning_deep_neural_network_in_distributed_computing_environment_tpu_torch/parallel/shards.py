"""One rank's share of a worker's parameters on the rank grid
(``mesh.Grid``): the storage the engine trains under the ``model``,
``expert``, ``pipe`` and ``fsdp`` axes (JAX
``LocalSGDEngine._build_state_specs`` and the ``shard_map`` in_specs of its
round program).

The shards are leaves of the JAX package's ``params`` tree, in its layout
and flatten order (``weights.jax_param_leaves``): leaf i is cut by its spec
(``bert.tp_param_specs`` or ``bert.pp_tp_param_specs``, ``pp.pp_param_specs``,
``moe.ep_param_specs`` or ``moe.pp_ep_param_specs``, the Megatron ones
under ``moe.with_expert_overlay``, extended by ``fsdp.add_fsdp_axis`` or
made by ``fsdp.fsdp_param_specs``) at
this rank's coordinates, so the shard holds
the elements of the JAX device at the same coordinates, and a checkpoint
piece is a shard with its global index.  Before each forward the ``fsdp``
shards are gathered (``fsdp.gather_params``) into the leaves of the
rank's tensor-parallel module, whose parameters are views of them
(``unpack``, through the module's own ``weights.wire_layout``) substituted
into the module for the forward and the backward (``substituted``); the
module's own parameter storage is released.  The ``seq`` axis shards no
leaf: each of its ranks holds the shards of its (fsdp, model) coordinate
whole, and under ``--sequence_parallel`` their gradients are summed over
the seq line (``reduce_grads``); without it the seq ranks are replicas.
Under ``pipe`` a stage holds its rows of every stacked ``layers`` leaf and
the other leaves whole; their gradients are summed over the pipe line.
Under ``expert`` a rank holds its experts of every MoE layer and every
other leaf whole; no gradient is summed over the expert line, since the
MoE layer's markers (``parallel/ep.py``) give every replicated leaf its
whole gradient on every rank.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from .. import comms, mesh, weights
from . import fsdp as fsdp_lib

AXES = ("fsdp", "pipe", "expert", "model")


@contextlib.contextmanager
def substituted(module: nn.Module, tensors: dict):
    """Run the body with ``module``'s parameters replaced by ``tensors``
    ({parameter name: tensor}); the parameters come back on exit.  Unlike
    ``torch.func.functional_call``, the substitution holds through the
    backward too, where a remat'd block recomputes its forward."""
    saved = []
    try:
        for name, t in tensors.items():
            path, _, attr = name.rpartition(".")
            sub = module.get_submodule(path)
            saved.append((sub, attr, sub._parameters.pop(attr)))
            setattr(sub, attr, t)
        yield
    finally:
        for sub, attr, p in reversed(saved):
            delattr(sub, attr)
            sub._parameters[attr] = p


def grid_specs(shapes: dict, grid: mesh.Grid, *,
               shard_tok_emb: bool = False) -> dict:
    """{leaf key: spec} for the grid's inner axes (JAX
    ``driver.py:596-692``): the Megatron specs over ``model`` (with the
    stacked layer dimension over ``pipe``), the expert stacks' expert
    dimension overlaid on ``expert``; without ``model`` the expert specs
    (with the layer dimension over ``pipe``) or the pipe specs alone;
    extended with ``fsdp`` on a free dimension, or the fsdp specs
    alone."""
    t, f, p = grid.size("model"), grid.size("fsdp"), grid.size("pipe")
    e = grid.size("expert")
    specs = {k: (None,) * len(s) for k, s in shapes.items()}
    if t > 1:
        from ..models.bert import pp_tp_param_specs, tp_param_specs
        specs = (pp_tp_param_specs(shapes, pipe_axis="pipe", axis="model",
                                   shard_tok_emb=shard_tok_emb) if p > 1
                 else tp_param_specs(shapes, "model",
                                     shard_tok_emb=shard_tok_emb))
        if e > 1:
            from ..models.moe import with_expert_overlay
            specs = with_expert_overlay(specs, "expert")
    elif e > 1:
        from ..models.moe import ep_param_specs, pp_ep_param_specs
        specs = (pp_ep_param_specs(shapes, pipe_axis="pipe", axis="expert")
                 if p > 1 else ep_param_specs(shapes, "expert"))
    elif p > 1:
        from .pp import pp_param_specs
        specs = pp_param_specs(shapes, "pipe")
    if f > 1:
        specs = (fsdp_lib.add_fsdp_axis(specs, shapes, axis="fsdp",
                                        axis_size=f)
                 if t > 1 or p > 1 or e > 1 else
                 fsdp_lib.fsdp_param_specs(shapes, axis="fsdp",
                                           axis_size=f))
    return specs


class GridParams:
    """This rank's parameter shards and how the rank's module reads them.

    ``dense_state``: the worker's whole parameters (``state_dict`` names of
    the dense twin, whose ``weights.state_layout`` is ``dense_layout``);
    ``module``: the rank's module (tensor-parallel under ``model``), whose
    parameter storage is released here."""

    def __init__(self, dense_state: dict, dense_layout: dict,
                 module: nn.Module, grid: mesh.Grid, device: torch.device,
                 *, shard_tok_emb: bool = False, split_seq: bool = True):
        full = weights.jax_param_leaves(dense_state, dense_layout)
        self.grid = grid
        # whether the seq line splits every sequence (--sequence_parallel)
        # or holds replicas of the whole step
        self.split_seq = split_seq
        self.dense_layout = dense_layout
        self.keys = list(full)
        self.full_shapes = {k: tuple(a.shape) for k, a in full.items()}
        self.specs = grid_specs(self.full_shapes, grid,
                                shard_tok_emb=shard_tok_emb)
        self.coords = {a: (grid.index(a), grid.size(a)) for a in AXES}
        self.index = [weights.shard_index(self.full_shapes[k],
                                          self.specs[k], self.coords)
                      for k in self.keys]
        shards = weights.shard_params(full, self.specs, self.coords)
        self.params = [torch.from_numpy(np.ascontiguousarray(shards[k]))
                       .to(device).requires_grad_() for k in self.keys]
        self.dims = {a: [self.specs[k].index(a) if a in self.specs[k]
                         else None for k in self.keys] for a in AXES}
        # the leaves every stage holds whole (embeddings, head, final norm)
        self.pipe_replicated = [d is None for d in self.dims["pipe"]]
        # the leaves every expert rank holds whole (all but the experts)
        self.expert_replicated = [d is None for d in self.dims["expert"]]
        # the module's leaves (after the fsdp gather) and its parameters
        leaves, self.pieces = weights.wire_layout(module)
        want = [tuple(s) for s, _d in leaves]
        have = [tuple(self._local_shape(i)) for i in range(len(self.keys))]
        if want != have:
            raise ValueError(
                "the rank's module does not hold the shards' leaves: "
                f"{want[:4]} vs {have[:4]} ...")
        self.module = module
        named = list(module.named_parameters())
        self.names = [n for n, _p in named]
        self.shapes = [tuple(p.shape) for _n, p in named]
        self.channels_last = [p.ndim == 4 for _n, p in named]
        for _n, p in named:          # the shards are the storage
            p.data = torch.empty(0, device=device, dtype=p.dtype)

    def _local_shape(self, i: int) -> list:
        """Leaf i's shape on this rank after the fsdp gather."""
        spec, shape = self.specs[self.keys[i]], self.full_shapes[self.keys[i]]
        return [n // self.grid.size(spec[d]) if d < len(spec)
                and spec[d] in ("model", "pipe", "expert") else n
                for d, n in enumerate(shape)]

    @property
    def fsdp(self) -> mesh.Group | None:
        g = self.grid.groups.get("fsdp")
        return g if g is not None and g.world_size > 1 else None

    @property
    def pipe(self) -> mesh.Group | None:
        g = self.grid.groups.get("pipe")
        return g if g is not None and g.world_size > 1 else None

    def pipe_replicated_params(self) -> list[torch.Tensor]:
        """This rank's shards of the leaves every stage holds (bitwise
        equal along pipe)."""
        return [p for p, r in zip(self.params, self.pipe_replicated) if r]

    def expert_replicated_params(self) -> list[torch.Tensor]:
        """This rank's shards of the leaves every expert rank holds
        (bitwise equal along expert)."""
        return [p for p, r in zip(self.params, self.expert_replicated) if r]

    @property
    def seq(self) -> mesh.Group | None:
        g = self.grid.groups.get("seq")
        return (g if g is not None and g.world_size > 1 and self.split_seq
                else None)

    def leaves(self) -> list[torch.Tensor]:
        """The module's leaves: the fsdp shards gathered (differentiable:
        the backward is the reduce-scatter)."""
        if self.fsdp is None:
            return list(self.params)
        return fsdp_lib.gather_params(self.params, self.dims["fsdp"],
                                      self.fsdp)

    def unpack(self, leaves) -> dict:
        """{module parameter name: view of its leaf}, each permuted to the
        module's layout (4-D conv weights made channels-last, as the
        module keeps them)."""
        out, li, pos = {}, 0, 0
        for t, axes in self.pieces:
            shape = self.shapes[t]
            n = int(np.prod(shape, dtype=np.int64))
            seg = leaves[li].reshape(-1)[pos:pos + n]
            if axes is None:
                v = seg.view(shape)
            else:
                inv = [axes.index(d) for d in range(len(axes))]
                v = seg.view([shape[a] for a in axes]).permute(*inv)
            if self.channels_last[t]:
                v = v.contiguous(memory_format=torch.channels_last)
            out[self.names[t]] = v
            pos += n
            if pos == leaves[li].numel():
                li, pos = li + 1, 0
        return out

    @contextlib.contextmanager
    def applied(self):
        """The module with this step's gathered parameters substituted:
        the forward and the backward run inside."""
        with substituted(self.module, self.unpack(self.leaves())):
            yield

    def accumulate_grads(self, body) -> list:
        """Run ``body()`` with this step's gathered parameters substituted
        into the module as leaves of their own, into whose ``.grad`` every
        backward of the body accumulates (a pipeline stage's microbatches,
        each its own graph); returns the shards' gradients: the fsdp
        shards are gathered once before and the summed gradients
        reduce-scattered once after (JAX gathers them outside its 1F1B
        schedule)."""
        full = self.leaves()
        leaves = [t.detach().requires_grad_() for t in full]
        with substituted(self.module, self.unpack(leaves)):
            body()
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in leaves]
        if self.fsdp is not None:
            grads = list(torch.autograd.grad(full, self.params, grads))
        return grads

    def reduce_grads(self, grads: list) -> list:
        """The gradients of the leaves every stage holds summed over
        ``pipe`` (each stage computed the part it ran), every gradient
        summed over ``seq`` (each rank computed it on its chunk of every
        sequence; JAX ``train.py:1703-1706``), then the fsdp-replicated
        leaves' summed over ``fsdp`` (each rank computed them on its slice
        of the batch).  Nothing is summed over ``expert``: the MoE layers'
        markers gave every leaf an expert rank holds whole its whole
        gradient (``parallel/ep.py``)."""
        grads = list(grads)
        if self.pipe is not None:
            from .pp import all_reduce_replicated
            grads = all_reduce_replicated(grads, self.pipe_replicated,
                                          self.pipe)
        if self.seq is not None:
            from .sp import all_reduce_grads
            grads = all_reduce_grads(grads, self.seq)
        if self.fsdp is None:
            return grads
        return fsdp_lib.reduce_replicated_grads(grads, self.dims["fsdp"],
                                                self.fsdp)

    @torch.no_grad()
    def global_norm(self, tensors) -> torch.Tensor:
        """The norm of a whole worker's tensors from this rank's shards:
        each leaf's squares summed over the axes that shard it, a
        replicated leaf counted once (JAX ``train.py:1380-1393``)."""
        groups: dict[tuple, torch.Tensor] = {}
        for i, t in enumerate(tensors):
            axes = tuple(a for a in AXES if a in self.specs[self.keys[i]])
            ss = t.float().square().sum()
            groups[axes] = groups.get(axes, 0) + ss
        total = torch.zeros((), device=tensors[0].device)
        for axes, ss in sorted(groups.items()):
            ss = torch.as_tensor(ss, device=total.device).reshape(1)
            for a in axes:
                ss = comms._all_reduce_sum(ss, self.grid.groups[a])
            total = total + ss[0]
        return total.sqrt()

    def writes(self, i: int) -> bool:
        """Whether this rank writes leaf i's checkpoint piece: it is the
        leaf's first replica (coordinate 0 on every axis that does not
        shard it, seq included)."""
        spec = self.specs[self.keys[i]]
        return self.grid.index("seq") == 0 and all(
            self.grid.index(a) == 0 for a in AXES if a not in spec)

    @torch.no_grad()
    def whole(self, tensors) -> list[torch.Tensor]:
        """``tensors`` (shaped like the shards) whole: gathered over fsdp,
        then over pipe, expert and model (a collective of every rank of
        the worker)."""
        out = [t.detach() for t in tensors]
        for a in AXES:
            g = self.grid.groups.get(a)
            if g is not None and g.world_size > 1:
                out = fsdp_lib.gather_leaves(out, self.dims[a], g)
        return out

    def port_params(self) -> dict:
        """The worker's whole parameters by the dense twin's ``state_dict``
        names, as host arrays (a collective)."""
        full = self.whole(self.params)
        return weights.params_from_jax_leaves(
            {f".params{k}": t.cpu().numpy()
             for k, t in zip(self.keys, full)}, self.dense_layout)

    @torch.no_grad()
    def load(self, tensors: list, full: dict) -> None:
        """Copy this rank's shard of each whole leaf of ``full`` ({key:
        array}, the JAX layout) into ``tensors`` (shaped like the
        shards)."""
        for t, key, index in zip(tensors, self.keys, self.index):
            if key not in full:
                raise ValueError(f"no leaf {key} to restore from")
            arr = np.asarray(full[key])
            if tuple(arr.shape) != self.full_shapes[key]:
                raise ValueError(
                    f"leaf {key} shape {tuple(arr.shape)} does not match "
                    f"the model's {self.full_shapes[key]}")
            part = arr[tuple(slice(a, b) for a, b in index)]
            t.copy_(torch.from_numpy(np.ascontiguousarray(part)))
