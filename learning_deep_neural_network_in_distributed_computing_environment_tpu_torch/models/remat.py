"""Per-block rematerialisation: ``--remat_policy`` on each transformer block
(port of the JAX package's ``compat.py:154-270`` policies and the scanned
stack's ``nn.remat``, ``models/bert.py:209-261``).

The JAX package applies remat to the scanned layer stack; the port keeps
one module per block and wraps each block's call, which computes the same
function: the block's input is kept, what the policy names is saved, and
the backward recomputes the rest of the block from them.

- ``everything``: ``torch.utils.checkpoint.checkpoint`` of the whole block
  (``jax.checkpoint`` with its default, nothing saved);
- ``dots_saveable``: a selective checkpoint that saves the outputs of the
  matrix products (``mm``/``addmm``/``bmm``/``baddbmm``) and recomputes the
  elementwise chains between them.  The flash kernels are launched outside
  the dispatcher, so their outputs are recomputed, as ``pallas_call`` is no
  dot in JAX;
- ``save_names:<a,b>``: a selective checkpoint that saves exactly the
  activations labelled by ``checkpoint_name`` with one of the names
  (``attn_out``, ``mlp_out``, ``block_out``, ``moe_dispatch``; the
  vocabulary is ``models.REMAT_NAMES``).  The label is an ``aten.alias`` of
  the activation whose output the policy keeps, so saving costs no copy;
- ``offload_names:<a,b>``: the same set, kept in pinned host memory on a
  card: the label copies the activation to the host (that copy is what is
  saved) and back, and the backward's recompute copies it back again.  On
  the CPU it is demoted to ``save_names`` of the same set with a logged
  reason, as ``compat.py:257-270`` does where there is no host memory
  space apart from the device's.

Every policy computes the same values as ``none`` (remat moves residency,
never arithmetic).  A recomputed block runs its forward again in the
backward, so each flash forward is launched twice per train step under any
policy but ``none``.  torch's selective checkpoint re-runs the block's ops
in order and takes a saved op's output from its cache: the ops upstream of
a saved activation still run (XLA drops those it does not need), so a
named policy saves memory, not recompute.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import logging
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

log = logging.getLogger(__name__)

REMAT_POLICIES = ("none", "dots_saveable", "everything")
NAMED_REMAT_KINDS = ("save_names", "offload_names")

_aten = torch.ops.aten
_DOT_OPS = frozenset({_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default})


def split_remat_policy(policy: str) -> tuple[str, tuple[str, ...]]:
    """``--remat_policy`` -> ``(kind, names)`` (JAX ``compat.py:186-215``):
    the base spellings parse as ``(spelling, ())``, the named tiers as
    ``("save_names" | "offload_names", names)`` with duplicates collapsed.
    Pure syntax: ``Config`` checks the names against the family's
    vocabulary."""
    if ":" not in policy:
        if policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat policy must be one of {REMAT_POLICIES} or "
                f"'save_names:<a,b>' / 'offload_names:<a,b>', got "
                f"{policy!r}")
        return policy, ()
    kind, _, names_csv = policy.partition(":")
    if kind not in NAMED_REMAT_KINDS:
        raise ValueError(
            f"named remat policy must start with one of "
            f"{NAMED_REMAT_KINDS}, got {policy!r}")
    names = tuple(dict.fromkeys(
        n.strip() for n in names_csv.split(",") if n.strip()))
    if not names:
        raise ValueError(
            f"named remat policy {policy!r} names no activation (expected "
            f"'{kind}:<name>[,<name>...]')")
    return kind, names


class _Naming:
    """The labels of one named-policy block call: which names are kept,
    whether on the host, and whether a label's op is being dispatched (the
    policy saves exactly that op's output)."""

    def __init__(self, names: tuple[str, ...], offload: bool):
        self.names = frozenset(names)
        self.offload = offload
        self.marking = False

    def policy(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if self.marking
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def mark(self, x: torch.Tensor) -> torch.Tensor:
        self.marking = True
        try:
            if self.offload:
                kept = x.to("cpu", non_blocking=True)   # pinned host copy
            else:
                kept = _aten.alias.default(x)
        finally:
            self.marking = False
        return kept.to(x.device, non_blocking=True) if self.offload else kept


_NAMING: contextvars.ContextVar[Optional[_Naming]] = contextvars.ContextVar(
    "remat_naming", default=None)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Label ``x`` as the named activation ``name`` (JAX
    ``checkpoint_name``): the identity, except inside a block run under a
    named policy whose set holds ``name``."""
    naming = _NAMING.get()
    if naming is None or name not in naming.names:
        return x
    return naming.mark(x)


@contextlib.contextmanager
def _with_naming(mode, naming: _Naming):
    token = _NAMING.set(naming)
    try:
        with mode:
            yield
    finally:
        _NAMING.reset(token)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Remat:
    """A parsed ``--remat_policy``; ``remat(block, *args)`` calls the block
    under it.  Without gradients (validation, evaluation) a block runs as
    it is: there is no backward to recompute for."""

    def __init__(self, policy: str):
        self.spec = policy
        self.kind, self.names = split_remat_policy(policy)
        self._demotion_logged = False

    def __bool__(self) -> bool:
        return self.kind != "none"

    def _context_fn(self, device_type: str) -> Optional[Callable]:
        if self.kind == "dots_saveable":
            return functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy)
        if self.kind in NAMED_REMAT_KINDS:
            offload = self.kind == "offload_names" and device_type == "cuda"
            if self.kind == "offload_names" and not offload:
                self._log_demotion(device_type)

            def contexts():
                naming = _Naming(self.names, offload)
                fwd, rec = create_selective_checkpoint_contexts(
                    naming.policy)
                return (_with_naming(fwd, naming), _with_naming(rec, naming))
            return contexts
        return None

    def _log_demotion(self, device_type: str) -> None:
        if not self._demotion_logged:
            self._demotion_logged = True
            names = ",".join(self.names)
            log.info("remat policy offload_names:%s demoted to save_names:%s"
                     " — on %s the device memory is host memory, so there "
                     "is nowhere apart to offload to; the same-set saved "
                     "policy keeps the same values", names, names,
                     device_type)

    def __call__(self, block, *args):
        if not self or not torch.is_grad_enabled():
            return block(*args)
        if torch._C._functorch.is_functorch_wrapped_tensor(args[0]):
            # under torch.func (the scenario lab's vmapped grad), which
            # refuses checkpoint's saved-tensor hooks: recompute the whole
            # block in the backward, whatever the policy selects
            return recompute(block, *args)
        context_fn = self._context_fn(args[0].device.type)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        # the blocks draw no random numbers: no RNG state to replay
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)


class _Recompute(torch.autograd.Function):
    """A block whose forward saves only its inputs (and the parameters it
    reads) and whose backward runs it again under ``torch.func.vjp``: the
    recompute ``checkpoint`` does, in a form ``torch.func`` transforms
    take (``setup_context``, a generated vmap rule)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, n_in, *tensors):
        return run(tensors[:n_in], tensors[n_in:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, n_in, *tensors = inputs
        ctx.run, ctx.n_in = run, n_in
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n_in = ctx.n_in
        _, vjp_fn = torch.func.vjp(ctx.run, tuple(saved[:n_in]),
                                   tuple(saved[n_in:]))
        g_in, g_params = vjp_fn(tuple(grads))
        return (None, None, *g_in, *g_params)


def recompute(block, *args):
    """``block(*args)`` through ``_Recompute``; the block returns a tensor
    or a tuple whose entries are tensors or None (an MoE block's aux
    loss is None in a dense block)."""
    names = [n for n, _ in block.named_parameters()]
    params = tuple(p for _, p in block.named_parameters())
    shape = {}

    def run(inputs, ps):
        out = torch.func.functional_call(block, dict(zip(names, ps)),
                                         tuple(inputs))
        outs = out if isinstance(out, tuple) else (out,)
        shape["tuple"] = isinstance(out, tuple)
        shape["none"] = [o is None for o in outs]
        return tuple(o for o in outs if o is not None)

    got = iter(_Recompute.apply(run, len(args), *args, *params))
    outs = tuple(None if none else next(got) for none in shape["none"])
    return outs if shape["tuple"] else outs[0]
