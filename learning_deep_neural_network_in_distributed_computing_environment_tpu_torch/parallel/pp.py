"""Pipeline parallelism over the ``pipe`` axis of the rank grid (port of the
JAX package's ``parallel/pp.py``): the GPipe and the non-interleaved 1F1B
schedules, and the parameter specs that cut the layer stack into stages.

Stage s of a ``pipe`` line of P ranks (``mesh.Group``) holds the
contiguous blocks ``[s*L/P, (s+1)*L/P)``: dim 0 of every stacked
``['layers']`` leaf of the JAX layout is sharded over ``pipe``
(``pp_param_specs``), and the rank's module is built with L/P blocks.
The embedding runs on stage 0 and the head and the loss on the last
stage; every stage holds those replicated leaves, and their gradients are
summed over the line (``all_reduce_replicated``: zeros where a stage did
not use them), so they stay bitwise equal along ``pipe``.

A step runs M microbatches (contiguous slices of the rank's batch) in the
order of ``gpipe_order`` (all M forwards, then all M backwards) or
``onef1b_order`` (stage s runs P-s-1 warm-up forwards, then one forward
and one backward in turn, then the remaining backwards: at most P-s
microbatches in flight).  Both orders are lists of steps, ``("F", i)``,
``("B", i)`` and ``("X", ops)``: one batch of point-to-point ops, each
``(kind, i)`` with kind ``send_act``, ``recv_act``, ``send_grad`` or
``recv_grad`` for microbatch i.  ``run`` executes an order on a rank.  A
stage hop moves an activation forward or a cotangent backward between
neighbours, staged through the line's pinned host buffers over gloo (as
``parallel/sp.py``'s exchanges are), the bytes moved as ``uint8``; where
1F1B sends one way and receives the other, both ops ride one
``batch_isend_irecv``, so two neighbours never block on facing sends.

What differs from the JAX package, by design: JAX runs the schedule as one
SPMD program, computes bubble steps on zeros and masks them, and its
1F1B recomputes each stage forward in the backward slot; here each rank
runs its own order, skips the bubbles on the host, and keeps each
in-flight microbatch's autograd graph until its backward, so the forward
runs once per microbatch (``--remat_policy`` / ``--pp_remat`` recompute
per block as on every other path).  The boundary of a stage is a leaf:
the received activation requires grad, and its gradient is the cotangent
the backward hop sends back.  An MoE stage's load-balance loss of each
microbatch, weighted, joins that microbatch's backward on its own stage
(JAX seeds the 1F1B slot with a weight-valued cotangent and sums the
GPipe stages' aux over pipe); a skipped bubble adds none, as JAX's
validity scale 0 gives none.
"""

from __future__ import annotations

import re
import time
from typing import Callable

import torch
import torch.distributed as dist

from .. import comms, mesh

# per process: the stage hops of the forward (activations) and of the
# backward (cotangents) run, the bytes handed to gloo and their wall time
# (host staging included; a batch that moves both splits its wall by
# bytes), the all-reduce of the replicated leaves' gradients over pipe,
# the most microbatches this stage held in flight and the most device
# memory allocated after a training forward (0 on the CPU)
STATS = {"fwd_calls": 0, "fwd_bytes": 0, "fwd_ms": 0.0,
         "bwd_calls": 0, "bwd_bytes": 0, "bwd_ms": 0.0,
         "grad_calls": 0, "grad_bytes": 0, "grad_ms": 0.0,
         "in_flight": 0, "mem_in_flight": 0}

_TAGS = {"act": 0, "grad": 1}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("ms") else 0


def pp_param_specs(shapes: dict, axis: str = "pipe") -> dict:
    """{leaf key: spec} for the JAX-layout ``params`` leaves (JAX
    ``pp_param_specs``): every leaf under the stacked ``layers``
    collection is sharded over ``axis`` on its leading (layer) dimension,
    everything else replicated."""
    out = {}
    for key, shape in shapes.items():
        names = re.findall(r"\['([^']*)'\]", key)
        out[key] = ((axis, *([None] * (len(shape) - 1))) if "layers" in names
                    else (None,) * len(shape))
    return out


# ----------------------------------------------------------------------
# the schedules' orders (pure Python: the tests run them without
# processes)
# ----------------------------------------------------------------------

def _fwd(p: int, s: int, i: int) -> list:
    out = [("X", (("recv_act", i),))] if s > 0 else []
    out.append(("F", i))
    if s < p - 1:
        out.append(("X", (("send_act", i),)))
    return out


def _bwd(p: int, s: int, i: int) -> list:
    out = [("X", (("recv_grad", i),))] if s < p - 1 else []
    out.append(("B", i))
    if s > 0:
        out.append(("X", (("send_grad", i),)))
    return out


def gpipe_order(p: int, s: int, m: int, backward: bool = True) -> list:
    """Stage ``s``'s GPipe order: the M forwards (fill), then, when
    ``backward``, the M backwards (drain), each microbatch's hops
    around it."""
    out = [step for i in range(m) for step in _fwd(p, s, i)]
    if backward:
        out += [step for i in range(m) for step in _bwd(p, s, i)]
    return out


def onef1b_order(p: int, s: int, m: int) -> list:
    """Stage ``s``'s non-interleaved 1F1B order: ``w = min(P-s-1, M)``
    warm-up forwards, then one forward and one backward in turn (the
    activation sent forward with the cotangent received in one batch, the
    cotangent sent back with the next activation received in another),
    then the ``w`` remaining backwards."""
    w = min(p - s - 1, m)
    r = m - w
    out = [step for i in range(w) for step in _fwd(p, s, i)]
    if r > 0 and s > 0:
        out.append(("X", (("recv_act", w),)))
    for j in range(r):
        f = w + j
        out.append(("F", f))
        if s < p - 1:
            out.append(("X", (("send_act", f), ("recv_grad", j))))
        out.append(("B", j))
        if s > 0:
            ops = (("send_grad", j),)
            if j + 1 < r:
                ops += (("recv_act", f + 1),)
            out.append(("X", ops))
    out += [step for j in range(r, m) for step in _bwd(p, s, j)]
    return out


def order(schedule: str, p: int, s: int, m: int) -> list:
    if schedule == "gpipe":
        return gpipe_order(p, s, m)
    if schedule == "1f1b":
        return onef1b_order(p, s, m)
    raise ValueError(f"pipeline schedule must be gpipe or 1f1b, got "
                     f"{schedule!r}")


# ----------------------------------------------------------------------
# the hops and the executor
# ----------------------------------------------------------------------

def hop(group: mesh.Group, sends: list, recvs: list) -> list:
    """One batch of point-to-point ops on the pipe line: ``sends`` are
    ``(kind, tensor, dst)`` (kind ``act`` or ``grad``), ``recvs`` are
    ``(kind, shape, dtype, device, src)``; returns the received tensors on
    their devices, in order."""
    t0 = time.perf_counter()
    device = (sends[0][1].device if sends else recvs[0][3])
    if device.type == "cuda":
        # the previous hop's device copies out of the receive buffers are
        # done before gloo writes into them again
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    ops, got, nbytes = [], [], {"act": 0, "grad": 0}
    for kind, x, dst in sends:
        buf = comms._to_host(x.detach(), group, f"pp/{kind}/send")
        ops.append(dist.P2POp(dist.isend, buf.view(torch.uint8),
                              group.peer(dst), group=group.pg,
                              tag=_TAGS[kind]))
        nbytes[kind] += buf.nbytes
    for kind, shape, dtype, _dev, src in recvs:
        numel = 1
        for n in shape:
            numel *= int(n)
        buf = group.host_buffer(f"pp/{kind}/recv", numel, dtype)
        ops.append(dist.P2POp(dist.irecv, buf.view(torch.uint8),
                              group.peer(src), group=group.pg,
                              tag=_TAGS[kind]))
        got.append(buf)
        nbytes[kind] += buf.nbytes
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [comms._to_device(buf, r[3]).view(r[1])
           for buf, r in zip(got, recvs)]
    ms = (time.perf_counter() - t0) * 1e3
    total = sum(nbytes.values())
    for kind, pre in (("act", "fwd"), ("grad", "bwd")):
        if nbytes[kind]:
            STATS[f"{pre}_calls"] += 1
            STATS[f"{pre}_bytes"] += nbytes[kind]
            STATS[f"{pre}_ms"] += ms * nbytes[kind] / total
    return out


def run(steps: list, group: mesh.Group, *, first: Callable,
        body: Callable, last: Callable, shape: Callable,
        dtype: torch.dtype, device: torch.device, train: bool = True,
        aux_weight: float = 0.0):
    """Execute ``steps`` (``gpipe_order`` / ``onef1b_order``) on this rank,
    stage ``group.rank`` of the pipe line ``group``.

    ``first(i)``: stage 0's input to its blocks for microbatch i (the
    embedding); ``body(x)``: the stage's blocks, ``(output, aux)`` with
    ``aux`` their MoE load-balance loss or None; ``last(y, i)``: on the
    last stage, ``(loss, metrics)`` of microbatch i from the blocks'
    output (``loss`` a scalar the backward starts from, None when not
    ``train``; ``metrics`` a detached tensor); ``shape(i)``: the
    activation's shape for microbatch i, of ``dtype``.  With ``train`` each
    backward accumulates the gradients into the leaves the graph reaches
    (``.grad``), each microbatch's ``aux_weight`` x aux included.  Returns
    ``(loss, metrics)`` summed over the microbatches: the loss on the
    last stage, and elsewhere the weighted aux (None without it); the
    metrics on the last stage, None elsewhere."""
    p, s = group.world_size, group.rank
    is_last = s == p - 1
    ins: dict = {}        # microbatch -> the stage's input leaf
    outs: dict = {}       # microbatch -> its output (the loss, last stage)
    auxes: dict = {}      # microbatch -> the stage's weighted aux (not last)
    grads: dict = {}      # microbatch -> the cotangent of its output
    loss_sum = metric_sum = None
    for kind, arg in steps:
        if kind == "F":
            i = arg
            x = first(i) if s == 0 else (ins[i] if train else ins.pop(i))
            y, aux = body(x)
            aux = aux * aux_weight if train and aux is not None else None
            if is_last:
                loss, metrics = last(y, i)
                metric_sum = (metrics if metric_sum is None
                              else metric_sum + metrics)
                if aux is not None:
                    loss, aux = loss + aux, None
                y = loss
            part = y if is_last else aux
            if part is not None:
                loss_sum = (part.detach() if loss_sum is None
                            else loss_sum + part.detach())
            if train or not is_last:
                # until its backward (or its send)
                outs[i] = y
            if aux is not None:
                auxes[i] = aux
            if train:
                STATS["in_flight"] = max(STATS["in_flight"], len(outs))
                if device.type == "cuda":
                    STATS["mem_in_flight"] = max(
                        STATS["mem_in_flight"],
                        torch.cuda.memory_allocated(device))
        elif kind == "B":
            i = arg
            y = outs.pop(i)
            if is_last:
                torch.autograd.backward(y)
            else:
                # the cotangent and the stage's weighted aux, one backward
                ys, cotangents = [y], [grads.pop(i)]
                if i in auxes:
                    ys.append(auxes.pop(i))
                    cotangents.append(None)
                torch.autograd.backward(ys, cotangents)
        else:
            sends, recvs = [], []
            for op, i in arg:
                if op == "send_act":
                    y = outs[i] if train else outs.pop(i)
                    sends.append(("act", y, s + 1))
                elif op == "send_grad":
                    x = ins.pop(i)
                    g = (x.grad if x.grad is not None
                         else torch.zeros_like(x))
                    sends.append(("grad", g, s - 1))
                elif op == "recv_act":
                    recvs.append(("act", shape(i), dtype, device, s - 1))
                else:
                    recvs.append(("grad", shape(i), dtype, device, s + 1))
            got = hop(group, sends, recvs)
            for (op, i), t in zip([o for o in arg if o[0].startswith("recv")],
                                  got):
                if op == "recv_act":
                    ins[i] = t.requires_grad_(train)
                else:
                    grads[i] = t
    if outs or grads or ins or auxes:
        raise RuntimeError(f"pipeline stage {s}: microbatches left in "
                           f"flight {sorted(outs)}")
    return loss_sum, metric_sum


def model_pass(model, group: mesh.Group, xs, last: Callable,
               schedule: str | None, device: torch.device,
               aux_weight: float = 0.0):
    """The microbatches ``xs`` through this stage of a transformer of the
    registry (``embed`` on stage 0, ``stage`` on its blocks, ``last`` on
    the blocks' output of the last stage): ``schedule``'s order when
    training (each microbatch's MoE aux times ``aux_weight`` in its
    backward), the forwards alone in the GPipe order when None.  Returns
    ``run``'s sums."""
    p, s, m = group.world_size, group.rank, len(xs)
    steps = (gpipe_order(p, s, m, backward=False) if schedule is None
             else order(schedule, p, s, m))
    return run(steps, group, first=lambda i: model.embed(xs[i]),
               body=model.stage, last=last,
               shape=lambda i: model.activation_shape(xs[i]),
               dtype=model.dtype, device=device, train=schedule is not None,
               aux_weight=aux_weight)


@torch.no_grad()
def all_reduce_replicated(grads: list, replicated: list,
                          group: mesh.Group) -> list:
    """The gradients of the leaves ``replicated`` marks (not sharded over
    pipe: the embeddings, the head, the final norm) summed over the pipe
    line in one fp32 all-reduce: each stage holds the contribution of the
    part it ran, zeros elsewhere; GPT's tied table gets the embedding's
    from stage 0 and the head's from the last stage."""
    idx = [i for i, r in enumerate(replicated) if r]
    if not idx:
        return list(grads)
    t0 = time.perf_counter()
    part = [grads[i] for i in idx]
    flat = comms.flatten(part)
    total = comms._all_reduce_sum(flat, group)
    out = list(grads)
    for i, g in zip(idx, comms.unflatten(total, part)):
        out[i] = g
    STATS["grad_calls"] += 1
    STATS["grad_bytes"] += flat.nbytes
    STATS["grad_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def microbatches(m: int, *tensors) -> list:
    """Each tensor cut into ``m`` contiguous microbatches along dim 0 (JAX
    reshapes the batch to ``[M, B/M, ...]``)."""
    b = tensors[0].shape[0]
    if b % m:
        raise ValueError(f"per-worker batch {b} not divisible by "
                         f"{m} microbatches")
    return [t.chunk(m) for t in tensors]


def in_flight_bound(schedule: str, p: int, s: int, m: int) -> int:
    """The most microbatches stage ``s`` holds in flight: M under GPipe,
    min(P - s, M) under 1F1B."""
    return m if schedule == "gpipe" else min(p - s, m)

