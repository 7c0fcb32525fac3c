"""Flash attention: wrappers around the hand-written Hopper kernels, their
plain PyTorch versions, and the autograd glue (port of the JAX package's
``ops/pallas_ops.py:118-563``).

Four kernels (``csrc/``, built by ``ops/_build.py``):

- ``flash_fwd``       <- ``_flash_kernel`` / ``_fwd_kernel_nolse``: O and,
  when training, the per-row log-sum-exp (fp32 [B, H, Lq]);
- ``flash_bwd_dq``    <- ``_bwd_dq_kernel``: dq, key tiles innermost;
- ``flash_bwd_dkv``   <- ``_bwd_dkv_kernel``: dk/dv, query tiles innermost,
  summed over each K/V head's query group;
- ``flash_bwd_fused`` <- ``_bwd_fused_kernel``: dq, dk and dv in one pass
  (p recomputed once per tile pair), selected by ``FLASH_BWD=fused``.

``FLASH_BWD`` is read once, at import, as the JAX package reads it
(``pallas_ops.py:522-534``): the backward of every flash call in the
process is either the two-pass pair or the fused kernel, never a mix.

The bf16 instances of all four kernels run their products on the tensor
cores (``mma.sync`` from ``cp.async``-staged bf16 tiles); the fp32
instances keep full fp32 products on the FMA pipes.  The two-pass pair
writes each output once from registers, so its gradients are the same bits
from run to run; the fused kernel sums dq by atomics.

A wrapper launches its kernel for CUDA tensors (or raises) and computes the
plain fp32 version for CPU tensors.  The model calls them through three
``autograd.Function`` ops (``FlashForward``, ``FlashAttention``,
``FlashBackward``) whose forward takes no ctx, so ``torch.func`` takes
them, and whose vmap rule folds a vmapped worker dim into the batch
(``[N, B, L, H, D]`` -> ``[N*B, L, H, D]``): under ``torch.func.vmap`` one
launch serves all N workers (the scenario lab, ``sim.py``), and the CPU's
plain versions go through the same rule.  Before a launch it copies an operand
the kernels cannot read in place (``_kernel_layout``: head_dim not
contiguous, or rows not 16-byte aligned for cp.async).  ``LAUNCHES`` counts
kernel launches, one per launch and nowhere else, so a run can show which
path it took.  The plain versions are also what ``chip_smoke.py`` holds the
kernels against.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .attention import NEG_INF, dot_product_attention, kv_group_size

log = logging.getLogger(__name__)

# head dims the kernels are instantiated for (csrc/flash_mma.cuh
# FLASH_HEAD_DIM lists the same)
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launch_counts()
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": 0}

# The backward switch: FLASH_BWD=fused runs the single-pass fused backward
# instead of the two-pass pair.  Read once at import (A/B the two in
# separate processes, as the JAX package does).
_FUSED_BWD = os.environ.get("FLASH_BWD") == "fused"


def _use_fused_bwd() -> bool:
    return _FUSED_BWD


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shapes and types the CUDA kernels take.  They mask ragged sequence
    tails themselves, so unlike the TPU kernel there is no 128-multiple
    rule; what remains is the instantiated head dims, whole query groups,
    and bf16/fp32 inputs of one dtype."""
    return (q.shape[-1] in SUPPORTED_HEAD_DIMS
            and q.shape[2] % k.shape[2] == 0
            and q.dtype in _DTYPE_CODES
            and q.dtype == k.dtype == v.dtype)


_DENSE_LOGGED: set = set()


def _log_dense(reason: str, q: torch.Tensor) -> None:
    """Warn once per (reason, shape) when requested flash attention runs the
    dense path instead, so a config that asks for flash cannot quietly
    measure dense."""
    key = (reason, tuple(q.shape))
    if key not in _DENSE_LOGGED:
        _DENSE_LOGGED.add(key)
        log.warning("flash attention requested but running dense for q "
                    "shape %s: %s", tuple(q.shape), reason)


# --------------------------------------------------------------------------
# plain PyTorch versions (fp32), the CPU path and the kernels' reference
# --------------------------------------------------------------------------

def _scores(q, k, causal):
    """Scaled fp32 scores [B, KV, rep, Lq, Lk], masked with NEG_INF."""
    b, lq, h, d = q.shape
    lk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, lq, kv, h // kv, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * d ** -0.5
    if causal:
        keep = (torch.arange(lk, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def plain_forward(q, k, v, causal=False):
    """(O in q's dtype [B, Lq, H, D], lse fp32 [B, H, Lq])."""
    b, lq, h, d = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float()).reshape(b, lq, h, d)
    return o.to(q.dtype), lse.reshape(b, h, lq)


def _probs_and_ds(q, k, v, do, lse, delta, causal):
    b, lq, h, d = q.shape
    kv = k.shape[2]
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(b, kv, h // kv, lq)[..., None])
    dog = do.float().reshape(b, lq, kv, h // kv, d)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = p * (dp - delta.reshape(b, kv, h // kv, lq)[..., None]) * d ** -0.5
    return p, ds


def _dq(q, k, ds):
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def _dkv(q, k, v, do, p, ds):
    b, lq, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, lq, kv, h // kv, d)
    dog = do.float().reshape(b, lq, kv, h // kv, d)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_bwd_dq(q, k, v, do, lse, delta, causal=False):
    """dq in q's dtype, from lse and delta = rowsum(dO * O) [B, H, Lq]."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    return _dq(q, k, ds)


def plain_bwd_dkv(q, k, v, do, lse, delta, causal=False):
    """(dk, dv) in k's dtype, summed over each K/V head's query group."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    return _dkv(q, k, v, do, p, ds)


def plain_bwd_fused(q, k, v, do, lse, delta, causal=False):
    """(dq, dk, dv) in the inputs' dtypes from one computation of p and
    ds, as the fused kernel does."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    return (_dq(q, k, ds), *_dkv(q, k, v, do, p, ds))


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

# cp.async stages operand rows in 16-byte chunks
_ROW_ALIGN = 16


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether a kernel can read ``t`` [B, L, H, D] where it lies: head_dim
    contiguous, and the base address and the batch/seq/head strides
    multiples of 16 bytes."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % _ROW_ALIGN == 0
            and all(s * size % _ROW_ALIGN == 0 for s in t.stride()[:3]))


def _kernel_layout(*ts):
    """The explicit layout fix before a launch: an operand whose head_dim is
    not contiguous or whose rows are not 16-byte aligned is copied to a
    fresh contiguous tensor; every other operand, such as the model's q/k/v
    views of one projection, goes in as it is."""
    return [t if _rows_aligned(t) else
            t.clone(memory_format=torch.contiguous_format) for t in ts]


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _common_args(q, k):
    b, lq, h, d = q.shape
    return [_DTYPE_CODES[q.dtype], b, h, k.shape[2], lq, k.shape[1], d]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_forward(q, k, v, causal=False, with_lse=False):
    """Launch ``flash_fwd``: (O, lse or None)."""
    from ._build import function
    q, k, v = _kernel_layout(q, k, v)
    b, lq, h, d = q.shape
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = function("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), *_common_args(q, k),
            *_strides(q, k, v), int(causal), d ** -0.5, _stream(q))
    _check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def kernel_bwd_dq(q, k, v, do, lse, delta, causal=False):
    from ._build import function
    q, k, v, do = _kernel_layout(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = function("flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_common_args(q, k), *_strides(q, k, v, do), int(causal),
            q.shape[-1] ** -0.5, _stream(q))
    _check(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def kernel_bwd_dkv(q, k, v, do, lse, delta, causal=False):
    from ._build import function
    q, k, v, do = _kernel_layout(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = function("flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_common_args(q, k), *_strides(q, k, v, do), int(causal),
            q.shape[-1] ** -0.5, _stream(q))
    _check(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def kernel_bwd_fused(q, k, v, do, lse, delta, causal=False):
    """Launch ``flash_bwd_fused``: (dq, dk, dv).  dq is summed in a
    zero-filled fp32 accumulator by atomic adds from the key-tile blocks,
    then cast to q's dtype once."""
    from ._build import function
    q, k, v, do = _kernel_layout(q, k, v, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = function("flash_bwd_fused")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_common_args(q, k), *_strides(q, k, v, do),
            int(causal), q.shape[-1] ** -0.5, _stream(q))
    _check(err, "flash_bwd_fused")
    LAUNCHES["flash_bwd_fused"] += 1
    return dq.to(q.dtype), dk, dv


# --------------------------------------------------------------------------
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# --------------------------------------------------------------------------

def _on_cuda(q: torch.Tensor) -> bool:
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"flash attention takes CUDA or CPU tensors, got "
                         f"{q.device}")
    return False


def flash_forward(q, k, v, causal=False, with_lse=False):
    if _on_cuda(q):
        return kernel_forward(q, k, v, causal, with_lse)
    o, lse = plain_forward(q, k, v, causal)
    return o, (lse if with_lse else None)


def flash_backward(q, k, v, o, lse, do, causal=False):
    """(dq, dk, dv) from the fused kernel under ``FLASH_BWD=fused``, else
    from the two-pass pair; delta = rowsum(dO * O) is a plain reduction, as
    in the JAX package."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    if _use_fused_bwd():
        fused = kernel_bwd_fused if _on_cuda(q) else plain_bwd_fused
        return fused(q, k, v, do, lse, delta, causal)
    if _on_cuda(q):
        dq = kernel_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = kernel_bwd_dkv(q, k, v, do, lse, delta, causal)
    else:
        dq = plain_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = plain_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# --------------------------------------------------------------------------
# the ops: autograd.Functions whose forward takes no ctx (setup_context), so
# torch.func transforms take them, each with a vmap rule that folds the
# vmapped worker dim into the batch: [N, B, L, H, D] -> [N*B, L, H, D], one
# launch for all N workers (LAUNCHES counts launches, not workers)
# --------------------------------------------------------------------------

def _fold(t: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """``t`` with its vmapped dim ``dim`` (None: not vmapped, shared by all
    ``n`` rows) first and merged into the batch dim."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class FlashForward(torch.autograd.Function):
    """Inference flash attention (no lse, no backward): O of [B, L, H, D]
    q, k, v.  The op a no-grad forward takes, also under ``vmap``."""

    @staticmethod
    def forward(q, k, v, causal: bool):
        return flash_forward(q, k, v, causal)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, do):
        raise RuntimeError("FlashForward has no backward; gradients go "
                           "through FlashAttention")

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        n = info.batch_size
        o = FlashForward.apply(*(_fold(t, d, n) for t, d
                                 in zip((q, k, v), in_dims[:3])), causal)
        return _unfold(o, n), 0


class FlashBackward(torch.autograd.Function):
    """(dq, dk, dv) of flash attention from its residuals: the two-pass
    pair, or the fused kernel under ``FLASH_BWD=fused``
    (``flash_backward``).  The op ``FlashAttention.backward`` calls, so a
    vmapped backward folds the workers and launches once."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal: bool):
        return flash_backward(q, k, v, o, lse, do, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention has no double backward")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal):
        n = info.batch_size
        grads = FlashBackward.apply(
            *(_fold(t, d, n) for t, d
              in zip((q, k, v, o, lse, do), in_dims[:6])), causal)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward returns O and lse (not
    differentiable) and keeps q, k, v, O and lse as residuals; the
    backward is ``FlashBackward``."""

    @staticmethod
    def forward(q, k, v, causal: bool):
        return flash_forward(q, k, v, causal, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashBackward.apply(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        n = info.batch_size
        o, lse = FlashAttention.apply(
            *(_fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3])),
            causal)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """[B, Lq, H, D] flash attention (K/V may carry fewer heads — GQA).

    An arbitrary ``mask`` is not tiled: it runs the dense path, logged once
    per shape.  A CUDA input the kernels do not take raises."""
    if mask is not None:
        _log_dense("arbitrary masks are not tiled (use causal=True for "
                   "autoregressive masking)", q)
        return dot_product_attention(q, k, v, mask, causal=causal)
    kv_group_size(q, k)
    if q.is_cuda and not _supported(q, k, v):
        raise ValueError(
            f"flash attention kernels take head_dim in {SUPPORTED_HEAD_DIMS}, "
            f"query heads divisible by kv heads and bf16/fp32 inputs of one "
            f"dtype; got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
            f"{k.dtype}, v {v.dtype} (use --attention_impl dense)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)[0]
    return FlashForward.apply(q, k, v, causal)
