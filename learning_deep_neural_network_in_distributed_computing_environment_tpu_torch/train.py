"""Local training phase: the per-step loss, Adam, and one worker's local-SGD
round (port of the JAX package's ``train.py``: ``TrainState`` :71-134,
``steplr``/CE/masking :232-320, Adam :518 + :1718-1720, the MoE aux loss
:1596-1615, gradient accumulation :1625-1674, the step and round bodies
:1676-1823, and ``round`` :2343 for one worker of the group).

PyTorch runs eagerly, so the round is a Python loop over steps instead of
a compiled scan.  A step whose batch is all padding (or ignore-index) is
skipped on the host before any work: in the JAX engine such a step leaves
params, optimizer state, carried gradients and BatchNorm statistics
untouched and records a zero loss, which is exactly what skipping does.

Train steps run the module in train mode (``train=True`` in flax), with
on-device augmentation of image batches when ``cfg.augment`` is set (the
JAX engine's rule, ``train.py:1827``: the pack is [S, B, H, W, C]);
validation runs it in eval mode, without augmentation.  BatchNorm
statistics live in the module as buffers, so they carry across rounds
with it and ``rank0_variables`` returns them.

With N workers each process runs one engine on its own row of the
worker-stacked packs; the sync point aggregates over the group
(``comms.aggregate``), and the round's metrics are gathered so that every
rank returns the JAX engine's [N, ...] arrays, the cross-worker means
included.

``round_streamed`` (``--stream_chunk_steps C``; JAX ``train.py:350-430,
2554-2765``) runs the same step bodies over fixed-shape windows of C steps
instead of one whole-round pack: a ``ChunkStager`` thread packs the next
windows and stages them while the current one computes, on the card
through pinned host buffers and a side-stream copy.  The same bytes reach
the same steps in the same order, so a streamed round is bitwise the whole
round.

On the rank grid (``--mesh_shape`` with inner axes; JAX
``train.py:1405, 1503-1545, 1617-1622, 1687-1713, 1950-1953``) each worker
is a block of ranks and ``grid_params`` (``parallel.shards.GridParams``)
holds this rank's shards of the worker's parameters, in the JAX layout:
the engine trains them, its Adam moments mirror them and the sync runs on
them over the ``data`` line (``group``).  Each step gathers the ``fsdp``
shards into the rank's module (tensor-parallel over ``model``), the
worker's batch is split over ``fsdp`` (contiguous by index), the loss is
the local numerator over the whole batch's denominator (vocab-parallel
under ``model``: ``tp.vocab_parallel_token_stats``), the replicated
leaves' gradients are summed over ``fsdp``, BatchNorm statistics are
averaged over it, and the augmentation stream is decorrelated by the
``fsdp`` index.  Under sequence parallelism (``seq``; JAX ``train.py:456-459,
1640-1650, 1703-1706, 1954-1956``) each rank also takes its contiguous
chunk of the sequence of every example (tokens and labels), the module's
attention runs over the ``seq`` line, and every gradient is summed over it
before the fsdp reduction, so the seq ranks stay bitwise equal.  Under
pipeline parallelism (``pipe``; JAX ``train.py:464-473, 1409-1532``) the
rank's module is one stage of the layer stack: each step runs its
microbatches through ``parallel.pp``'s schedule (``--pp_schedule``), the
loss of each microbatch its masked numerator over the whole batch's
denominator, computed on the last stage; the fsdp shards are gathered
once outside the schedule and reduce-scattered once after it, and the
leaves every stage holds get their gradients summed over ``pipe``.
Validation runs the microbatches forward in the GPipe order.  Under
expert parallelism (``expert``) the MoE layers hold the rank's experts
and sum their outputs over the line, and every rank runs the whole
step.  The MoE aux loss is divided by the fsdp and seq sizes (each part
routes its own tokens; JAX ``train.py:1596-1615``); under ``pipe`` each
stage adds its blocks' aux of each microbatch, over M, to what it
backpropagates.  The
per-step metric sums are summed over ``fsdp``, ``seq`` (the axes along
which a rank's batch is partial) and ``pipe`` (only the last stage holds
them) once per epoch; the round's metrics are gathered over every rank and
each worker's are its first rank's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from . import comms, mesh, probe, weights
from .config import Config
from .data.augment import augment_batch

log = logging.getLogger(__name__)

# set (to anything) to run each stale sync to its end at dispatch: the
# same delivery schedule with nothing overlapped, the serial twin the
# staleness gates compare with (JAX's JAX_GRAFT_STALENESS_SERIAL)
STALENESS_SERIAL_ENV = "PORT_STALENESS_SERIAL"


def steplr(lr0: float, gamma: float, step_size: int, epoch: int) -> float:
    """torch StepLR, stepped per LOCAL epoch."""
    return lr0 * gamma ** (epoch // step_size)


class SoftmaxCrossEntropy(torch.autograd.Function):
    """Per-example CE (``nn.CrossEntropyLoss`` semantics) whose only
    residuals are the logits (in their own dtype) and the fp32 log-sum-exp:
    the backward recomputes the softmax instead of keeping an fp32
    [.., vocab] ``log_softmax``.  Labels are clamped into range once, so the
    forward's gather and the backward's one-hot agree for any input
    (ignore-index positions are masked by the caller).  The forward takes
    no ctx (``setup_context``) and the vmap rule is generated, so the
    scenario lab's ``torch.func.vmap(grad_and_value(...))`` step takes
    it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(logits: torch.Tensor, labels: torch.Tensor):
        labels = labels.clamp(0, logits.shape[-1] - 1)
        lse = torch.logsumexp(logits.float(), dim=-1)
        ll = logits.float().gather(-1, labels[..., None])[..., 0]
        return lse - ll, labels, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits = inputs[0]
        _, labels, lse = output
        ctx.mark_non_differentiable(labels, lse)
        ctx.save_for_backward(logits, labels, lse)

    @staticmethod
    def backward(ctx, g: torch.Tensor, _g_labels, _g_lse):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        d = d.scatter_add(-1, labels[..., None],
                          torch.full_like(lse[..., None], -1.0))
        return (d * g[..., None]).to(logits.dtype), None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    return SoftmaxCrossEntropy.apply(logits, labels)[0]


def masked_weights(labels: torch.Tensor, batch_mask: torch.Tensor
                   ) -> torch.Tensor:
    """Per-position fp32 loss weights: the batch mask broadcast over the
    label dims, with ignore-index positions (label < 0) zeroed."""
    w = batch_mask.reshape(
        batch_mask.shape + (1,) * (labels.ndim - batch_mask.ndim))
    return torch.broadcast_to(w, labels.shape).float() * (labels >= 0)


def masked_token_stats(logits: torch.Tensor, labels: torch.Tensor,
                       batch_mask: torch.Tensor):
    """(ce, weight, correct) for classification ([B] labels) and token
    tasks ([B, L] labels; label < 0 is ignored)."""
    ce = softmax_cross_entropy(logits, labels.clamp_min(0))
    w = masked_weights(labels, batch_mask)
    correct = ((logits.argmax(-1) == labels) * w).sum()
    return ce, w, correct


def _adam_update(params: list, grads: list, mu: list, nu: list, b1: float,
                 b2: float, eps: float, count: int, lr: float) -> None:
    """One optax ``scale_by_adam`` step followed by ``-lr * u``, in place,
    with one ``count`` and ``lr`` for every tensor."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    # bias corrections in fp32, as optax computes them
    one = np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** np.float32(count))
    bc2 = float(one - np.float32(b2) ** np.float32(count))
    mu_hat = torch._foreach_div(mu, bc1)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(mu_hat, denom)
    torch._foreach_add_(params, mu_hat, alpha=-lr)


class Adam:
    """``optax.scale_by_adam(b1, b2, eps)`` followed by ``-lr * u``, in place
    on fp32 parameters (moments are fp32, ``count`` advances only on
    real steps)."""

    def __init__(self, params: list[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             lr: float) -> None:
        self.count += 1
        _adam_update(params, grads, self.mu, self.nu, self.b1, self.b2,
                     self.eps, self.count, lr)

    def state_tensors(self) -> list[torch.Tensor]:
        return self.mu + self.nu


class StackedAdam:
    """``Adam`` for N workers whose tensors are stacked on a leading [N]
    axis (the scenario lab): ``count`` is an [N] array, and each step
    takes a per-row learning rate and a per-row gate.  A gated row
    (a padding step, or nothing to train) keeps its parameters, moments
    and count unchanged, as JAX's ``_tree_where(total > 0, ...)`` keeps
    them (``train.py:1722-1731``).  When every row steps with one count
    and one lr the update is ``Adam``'s, op for op; otherwise the betas,
    bias corrections (fp32, per row, as optax computes them) and lr
    become [N] coefficients, with a gated row's set to leave it as it
    was (beta 1, weight 0, correction 1, lr 0)."""

    def __init__(self, params: list[torch.Tensor], n: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.n = n
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = np.zeros(n, np.int64)

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             lr: np.ndarray, do: np.ndarray) -> None:
        """One step of every row ``i`` with ``do[i]`` at lr ``lr[i]``."""
        do = np.asarray(do, bool)
        lr = np.asarray(lr, np.float32)
        count = self.count + do
        if do.all() and (lr == lr[0]).all() and (count == count[0]).all():
            _adam_update(params, grads, self.mu, self.nu, self.b1, self.b2,
                         self.eps, int(count[0]), float(lr[0]))
            self.count = count
            return
        f32 = np.float32
        one = f32(1.0)
        cols = np.stack([
            np.where(do, f32(self.b1), one),
            np.where(do, f32(1.0 - self.b1), f32(0.0)),
            np.where(do, f32(self.b2), one),
            np.where(do, f32(1.0 - self.b2), f32(0.0)),
            np.where(do, one - f32(self.b1) ** count.astype(f32), one),
            np.where(do, one - f32(self.b2) ** count.astype(f32), one),
            np.where(do, -lr, f32(0.0))]).astype(f32)
        c = torch.from_numpy(cols).to(params[0].device)
        rows = lambda j: [c[j].view(self.n, *([1] * (p.ndim - 1)))
                          for p in params]
        b1, c1, b2, c2, bc1, bc2, neg_lr = (rows(j) for j in range(7))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_addcmul_(self.mu, grads, c1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, torch._foreach_mul(grads, c2),
                                grads)
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_addcmul_(params, mu_hat, neg_lr)
        self.count = count

    def state_tensors(self) -> list[torch.Tensor]:
        return self.mu + self.nu


def to_device(a: np.ndarray, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array on ``device``: images as fp32 (NHWC), token ids as
    int64, unless ``dtype`` says otherwise."""
    if dtype is None:
        dtype = input_dtype(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def to_host(tensors: dict) -> dict:
    """Device tensors to host memory: on a card pinned buffers filled by
    ``non_blocking`` copies on the current stream (complete at the next
    fence; no host wait now), on the CPU copies."""
    out = {}
    for k, v in tensors.items():
        if not v.is_cuda:
            out[k] = v.detach().clone()
            continue
        out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        out[k].copy_(v, non_blocking=True)
    return out


def input_dtype(a: np.ndarray) -> torch.dtype:
    """The device dtype of an input array: fp32 images, int64 token ids."""
    return torch.float32 if np.issubdtype(a.dtype, np.floating) else torch.long


def step_weights(y: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Each step's count of real loss positions (0 = an all-padding step,
    skipped) of a host window ``y [..., S, B, ...]``, ``m [..., S, B]``
    (a leading worker axis gives one row per worker)."""
    m = np.asarray(m)
    return (masked_weights(torch.from_numpy(np.asarray(y)),
                           torch.from_numpy(m))
            .reshape(*m.shape[:-1], -1).sum(-1).numpy())


def wait_event(event) -> None:
    """Wait on the host until ``event`` has passed, by polling: an
    ``Event.synchronize`` could count under ``--sanitize``'s sync-debug
    mode, which is process-wide, while a guarded round runs on the main
    thread (the event waited on here has almost always passed)."""
    while not event.query():
        time.sleep(1e-4)


class ChunkStager:
    """Bounded producer thread of the streamed round's input pipeline (JAX
    ``train.py:350-430``).

    Wraps a generator of host windows: the producer packs the next
    window(s) and stages them (``stage_fn``) while the consumer's current
    window computes.  ``depth`` bounds the staged windows ahead of the
    consumer (2 = double buffering).  A generator or staging error
    re-raises at the consumer's next pull.  A consumer that stops early
    must ``close()`` the stager: it stops the producer, joins it and drops
    what is already staged, so no device buffer stays pinned by a parked
    thread."""

    _DONE = object()

    def __init__(self, gen: Iterable, stage_fn: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._produce,
                                   args=(gen, stage_fn), daemon=True,
                                   name="chunk-stager")
        self._t.start()

    def _put(self, item) -> bool:
        """A stop-aware bounded put: blocks while the consumer drains,
        gives up once ``close()`` was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, gen, stage_fn) -> None:
        try:
            for item in gen:
                if self._stop.is_set() or not self._put(stage_fn(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._err = e
        finally:
            self._put(self._DONE)

    def close(self) -> None:
        """Stop the producer, join it, and drop every staged window.
        Idempotent."""
        self._stop.set()
        # drain, let the producer see the stop (its puts give up within
        # 0.1 s), then drain what its last put landed
        for _ in range(2):
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._t.join(timeout=5.0)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


class WindowStaging:
    """Stages host windows ``(x, y, m)`` onto ``device`` as ``(x, y, m, w,
    weights, ready)``: ``weights`` is ``step_weights`` on the host (the
    round's control flow), ``w`` the same counts on the device (its
    per-epoch sums), and ``ready`` the event the consumer waits on before
    it reads the tensors.

    On the card each window is copied into a pinned host buffer (one of
    ``slots``, reused only after its last copy's event has passed, in the
    device dtypes: fp32 images, int64 labels, fp32 mask and counts), then
    to the device by a ``non_blocking`` copy on a side stream, so the
    copies overlap the consumer's compute and no host thread waits on the
    card for them.  The device allocation holds ``probe.MEASURE_LOCK``, so
    it never falls inside a program's measured first call.  On the CPU it
    is ``from_numpy`` (``ready`` is None)."""

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._slots: deque = deque()       # (pinned buffers, last event)
        self._nslots = max(2, int(slots))

    def _pinned(self, arrays: tuple) -> tuple:
        dtypes = (input_dtype(arrays[0]), torch.long, torch.float32,
                  torch.float32)
        want = [(a.shape, d) for a, d in zip(arrays, dtypes)]
        if len(self._slots) >= self._nslots:
            bufs, ev = self._slots.popleft()
            wait_event(ev)                 # its last H2D copy has finished
            if [(tuple(b.shape), b.dtype) for b in bufs] == want:
                return bufs
        return tuple(torch.empty(shape, dtype=d, pin_memory=True)
                     for shape, d in want)

    def __call__(self, window):
        x, y, m = (np.ascontiguousarray(a) for a in window)
        weights = step_weights(y, m)
        if not self.cuda:
            return (to_device(x, self.device), to_device(y, self.device,
                                                         torch.long),
                    to_device(m, self.device, torch.float32),
                    torch.from_numpy(weights), weights, None)
        bufs = self._pinned((x, y, m, weights))
        for b, a in zip(bufs, (x, y, m, weights)):
            b.copy_(torch.from_numpy(a))
        with probe.MEASURE_LOCK, torch.cuda.device(self.device), \
                torch.cuda.stream(self.stream):
            out = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self._slots.append((bufs, ready))
        return (*out, weights, ready)


def take_window(item, device: torch.device):
    """The consumer's side of ``WindowStaging``: wait for the window's copy
    on the current stream and tie its tensors to that stream (the
    allocator must not hand their memory back to the side stream while the
    current one still reads it).  Returns ``(x, y, m, w, weights)``."""
    *tensors, weights, ready = item
    if ready is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ready)
        for t in tensors:
            t.record_stream(cur)
    return (*tensors, weights)


def worker_seed(seed: int, rank: int) -> int:
    """Seed of worker ``rank``'s augmentation stream, the twin of JAX
    ``fold_in(key(seed), rank)``: ``seed`` itself for worker 0 (so one
    worker draws what it always drew), a ``SeedSequence`` of (seed, rank)
    for the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0])


def seed_words(seed: int) -> np.ndarray:
    """A 64-bit seed as the uint32[2] (low, high) the checkpoint's ``.rng``
    leaf holds (the JAX package keeps its raw PRNG key there)."""
    return np.array([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF],
                    np.uint32)


def round_seed(rng: np.ndarray, lr_epoch: int) -> int:
    """The augmentation generator's seed for a round that starts after
    ``lr_epoch`` local epochs: the worker's seed itself for the first
    round, a ``SeedSequence`` of (seed words, lr_epoch) after it.  The
    stream is a function of the checkpointed state alone, so a resumed
    run draws what the uninterrupted run drew."""
    lo, hi = (int(w) for w in np.asarray(rng, np.uint32).reshape(2))
    if lr_epoch == 0:
        return lo | (hi << 32)
    return int(np.random.SeedSequence([lo, hi, int(lr_epoch)])
               .generate_state(1, np.uint64)[0])


def cross_worker_means(mx: dict) -> dict:
    """Add the cross-worker means to a round's [N, ...] metric arrays, in
    place (JAX ``train.py:1862, 1887-1898``): ``avg_acc`` per local epoch
    and the ``global_*`` means of the per-worker epoch means, broadcast
    over the workers."""
    mx["avg_acc"] = np.broadcast_to(mx["train_acc"].mean(axis=0),
                                    mx["train_acc"].shape)
    for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
        per_worker = mx[k].mean(axis=1)
        mx[f"global_{k}"] = np.broadcast_to(
            per_worker.mean(keepdims=True), per_worker.shape)
    return mx


@dataclasses.dataclass
class TrainState:
    """One worker's state between rounds.  The parameters (and BatchNorm
    statistics) live in the engine's module; this holds what the JAX
    ``TrainState`` carries beside them: the Adam moments, the StepLR clock,
    the seed words of the worker's augmentation stream, and the fast sync
    engines' state: the error-feedback residual (fp32, shaped like the
    parameters; weights mode with ``--sync_compression ef``), the round
    optimizer's moments (``comms.round_opt_init``'s row; gradients mode
    under the sharded engine), the scatter-resident parameters and the
    buddy rows (JAX ``train.py:71-134``)."""

    opt: Adam
    lr_epoch: int = 0            # local epochs completed (StepLR clock)
    rng: Optional[np.ndarray] = None   # uint32[2] (``seed_words``)
    sync_residual: Optional[list] = None
    round_opt: Optional[dict] = None
    # the scatter-resident consensus (``--param_residency resident``):
    # ``{bucket: [padded // n]}``, this worker's 1/n shard of the packed
    # parameters after the sync's apply; between rounds it is the only
    # parameter state (the module's parameter storage is released) and
    # the next round's entry gathers the whole tensors from it
    params_resident: Optional[dict] = None
    # the buddy rows (``--shard_redundancy buddy``): ``{bucket: {"params",
    # "res", "mu", "nu"}}``, the ring predecessor's shard-resident rows as
    # the sync's extra hop delivered them; derived state, stripped from
    # checkpoints
    buddy: Optional[dict] = None
    # the hierarchical sync's outer error-feedback residual (a compressed
    # --sync_dtype_outer with --sync_compression ef): ``{bucket: [padded //
    # W]}``, the fp32 rounding of this worker's own outer transmission
    # (JAX ``TrainState.sync_residual_outer``); the inner level keeps
    # ``sync_residual``
    sync_residual_outer: Optional[dict] = None


class LocalSGDEngine:
    """One worker's local-SGD rounds: ``epochs_local`` x (train loop +
    per-epoch validation on the worker's own shard), then the sync point
    over ``group`` (None: one worker)."""

    def __init__(self, model: nn.Module, cfg: Config, device: torch.device,
                 group: mesh.Group | None = None, nan_screen: bool = False,
                 grid_params=None, vocab_parallel: bool = False,
                 slices: mesh.Grid | None = None):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.group = group
        self.rank = 0 if group is None else group.rank
        self.n_workers = 1 if group is None else group.world_size
        # the hierarchical sync (--num_slices; JAX train.py:439-460): the
        # world's slice grid, ``n_workers`` = S x W in all, slice-major;
        # the inner level is this worker's slice (its data line), the
        # outer one the same data coordinate in every slice
        self.n_slices = 1 if slices is None else slices.size("slice")
        self.n_inner = self.n_workers // self.n_slices
        self.inner_group = group if slices is None else slices.groups["data"]
        self.outer_group = None if slices is None else slices.groups["slice"]
        # the rank grid's shards (parallel.shards.GridParams) or None: the
        # whole worker in this process
        self.gp = grid_params
        self.grid = None if grid_params is None else grid_params.grid
        # the fsdp line, when the worker's batch splits over it, and the
        # seq line, when every sequence does; the axes along which this
        # rank's batch is partial
        self.fsdp = None if grid_params is None else grid_params.fsdp
        self.seq = None if grid_params is None else grid_params.seq
        # the pipe line: this rank is one stage of the worker's layer
        # stack, and only the last stage holds the loss and the metrics
        self.pipe = None if grid_params is None else grid_params.pipe
        self.pp_microbatches = (cfg.pp_microbatches
                                or (1 if self.pipe is None
                                    else self.pipe.world_size))
        self.part_groups = [g for g in (self.fsdp, self.seq, self.pipe)
                            if g is not None]
        # the MoE aux loss's divisor of the axes along which this rank's
        # batch is partial (JAX ``_part_axes``): each part routed its own
        # tokens, and the sum over the parts must be the mean
        self.aux_parts = float(np.prod([g.world_size for g in
                                        (self.fsdp, self.seq)
                                        if g is not None]))
        # the model's output is its local vocab slice (tensor parallelism)
        self.vp_group = (self.grid.groups["model"] if vocab_parallel
                         else None)
        if grid_params is not None:
            self.names = list(grid_params.keys)
            self.params = grid_params.params
        else:
            self.names = [n for n, _ in model.named_parameters()]
            self.params = [p for p in model.parameters()]
            # a module reused across a membership boundary may come with
            # its parameters released: give them their shapes back first
            self._unrelease()
        # the augmentation draws: one stream per worker, on its device,
        # seeded at each round from the state (``round_seed``)
        self.generator = torch.Generator(device=device)
        # --- the sync engine, resolved once (JAX train.py:530-700) ------
        self.sync_mode = cfg.resolve_sync_mode()
        self.hier = self.sync_mode == "hier"
        if self.hier and slices is None:
            raise ValueError(
                f"--num_slices {cfg.num_slices}: the hierarchical sync "
                "needs the slice grid of its S x W worker processes (run "
                "it through main.run or driver.run_group)")
        if self.hier and self.n_inner < 2:
            raise ValueError(
                f"--num_slices {self.n_slices} needs >= 2 workers per "
                f"slice (got a data axis of {self.n_inner}): the outer "
                "gossip hop rides the 1/W inner scatter shard — with "
                "W = 1 there is no inner level, run the flat gossip "
                "engine (--num_slices 1)")
        self.opt_placement = cfg.resolve_opt_placement()
        # where the consensus lives between rounds, and whether its
        # uniquely held rows have a second copy (JAX train.py:599-652;
        # a one-worker axis demotes resident, with the log line JAX gives;
        # under slices each worker keeps 1/W of its slice's consensus)
        self.param_residency = cfg.resolve_param_residency(self.n_inner)
        if (cfg.param_residency == "resident"
                and self.param_residency == "replicated"):
            log.info("param_residency resident requested but %s: resolved "
                     "to 'replicated'",
                     "inner mesh axes shard the param leaves: the bucket "
                     "plan must stay per-worker" if cfg.inner_axes() else
                     "the worker axis is 1" if self.n_inner < 2 else
                     f"{cfg.aggregation_by}/{cfg.aggregation_type} "
                     "aggregation leaves per-worker params")
        self.resident_on = self.param_residency == "resident"
        self.shard_redundancy = cfg.resolve_shard_redundancy(self.n_workers)
        self.buddy_on = self.shard_redundancy == "buddy"
        if cfg.shard_redundancy == "buddy" and not self.buddy_on:
            log.info("shard_redundancy buddy requested but nothing resolves "
                     "shard-resident (param_residency=%s, workers=%d): "
                     "resolved to 'off'", self.param_residency,
                     self.n_workers)
        # the chaos screen (nan@R faults): the sync takes a poison flag,
        # set per round by ``stage_poison``
        self.nan_screen = bool(nan_screen)
        self._poison = False
        self.sync_wire_dtype = cfg.sync_wire_dtype()
        # the outer hops' wire (JAX train.py:533-538); EF per level: the
        # inner residual when the inner wire is compressed, the outer one
        # when the outer wire is
        self.sync_wire_dtype_outer = (cfg.sync_wire_dtype_outer()
                                      if self.hier else None)
        fast = self.sync_mode in ("sharded", "gossip", "hier")
        ef = cfg.sync_compression == "ef" and cfg.aggregation_by == "weights"
        self.sync_ef = (ef and fast and self.sync_wire_dtype is not None)
        self.sync_ef_outer = (ef and self.hier
                              and self.sync_wire_dtype_outer is not None)
        self.sync_bucket_bytes = max(1, int(cfg.sync_bucket_mb * (1 << 20)))
        # the round optimizer follows the cross-worker mean gradient:
        # gradients mode under the sharded engine (JAX train.py:576-580)
        self.round_opt_on = cfg.round_opt_on() and self.sync_mode == \
            "sharded"
        # the packed order of the fast engines: the JAX package's flatten
        # order of the model's flax params (buckets, int8 scales and the
        # round optimizer's rows are JAX's); the grid's shards are leaves
        # in that order already
        self.layout = None
        if fast:
            self.layout = (comms.WireLayout.identity(self.params)
                           if grid_params is not None else
                           comms.WireLayout(*weights.wire_layout(model)))
        # the per-worker template the resident layout and the host
        # re-layouts address buckets with
        self.params_template = (comms.ParamsTemplate.of(
            self.names, self.params, self.layout)
            if self.layout is not None else None)
        self.last_sync_stats: dict = {}
        # --- semi-synchronous rounds (JAX train.py:676-700, 2110-2290) --
        self.staleness = max(0, int(cfg.sync_staleness))
        self.staleness_serial = bool(os.environ.get(STALENESS_SERIAL_ENV))
        self._pending: list[dict] = []     # in-flight syncs, oldest first
        self.stale_log: list[dict] = []    # one row per delivered delta
        self._stale_residual = None        # the EF residual, engine-side
        self._delivered: Optional[dict] = None
        self._sync_pool = None
        # on a card the sync thread's kernels and copies run on a stream
        # of their own, beside the next round's compute
        self._sync_stream = None
        # a stale sync runs its collectives on a process group of its own,
        # so they never interleave with the main thread's gathers (on a
        # grid: a second group of every coordinate's data line)
        self._sync_group = group
        if self.staleness and group is not None:
            self._sync_group = (group.split() if self.grid is None
                                else self.grid.split_lines("data"))
        # the metric gather of ``finish_metrics`` too (made at the first
        # round's start, on every rank): the overlapped driver runs it on
        # a thread while the main thread syncs the next round, and two
        # threads' collectives on one group could meet in another order on
        # each rank
        self._metrics_group: Optional[mesh.Group] = None
        # the programs' memory rows (JAX train.py:519-525): label ->
        # probe.TrackedProgram, each registered at its first use
        self._programs: dict[str, probe.TrackedProgram] = {}
        # this worker's device tensors of the module (parameters and
        # buffers), read by the step programs' memory rows
        self._buffers = list(model.buffers())
        self._staging: Optional[WindowStaging] = None   # stage_pack's

    def memory_programs(self) -> dict:
        """Label -> ``probe.TrackedProgram`` of every program this engine
        ran (JAX ``memory_programs``): ``train_step`` and ``eval_step`` of
        the packed rounds, ``chunk_train`` and ``chunk_eval`` of the
        streamed ones, the engine's ``sync`` (``stale_sync`` under
        ``--sync_staleness``) and the resident layout's
        ``resident_enter`` gather."""
        return dict(self._programs)

    def _step_state(self, state: TrainState, *_args) -> list:
        """What a train step reads and updates in place besides its
        batch: the parameters, the buffers and Adam's moments."""
        return [*self.params, *self._buffers, *state.opt.mu, *state.opt.nu]

    def _module_state(self, *_args) -> list:
        return [*self.params, *self._buffers]

    def init_state(self) -> TrainState:
        residual = ([torch.zeros_like(p, dtype=torch.float32)
                     for p in self.params] if self.sync_ef else None)
        round_opt = (comms.round_opt_init(
            self.layout.leaves, self.n_workers, self.rank,
            placement=self.opt_placement,
            bucket_bytes=self.sync_bucket_bytes, device=self.device)
            if self.round_opt_on else None)
        outer = (comms.hier_outer_residual_init(
            self.layout.leaves, self.n_inner,
            bucket_bytes=self.sync_bucket_bytes, device=self.device)
            if self.sync_ef_outer else None)
        state = TrainState(opt=Adam(self.params),
                           rng=seed_words(worker_seed(self.cfg.seed,
                                                      self.rank)),
                           sync_residual=residual, round_opt=round_opt,
                           sync_residual_outer=outer)
        # the resident rows tile the inner line: a slice's W workers (JAX
        # train.py:1205-1215: the one init is every slice's consensus)
        n, rank = self.n_inner, self.inner_group_rank
        full = None
        if self.resident_on:
            # the init is one consensus on every rank: its shard is the
            # resident state from round 0 on
            full = comms.resident_from_tree(
                [p.detach().cpu() for p in self.params], n,
                template=self.params_template,
                bucket_bytes=self.sync_bucket_bytes)
            state.params_resident = {
                k: torch.from_numpy(np.ascontiguousarray(v[rank])).to(
                    self.device) for k, v in full.items()}
        if self.buddy_on:
            # derivable here without a hop (JAX derives it on host): the
            # predecessor's resident row is a row of the same consensus,
            # its residual span and round-optimizer rows are zeros
            prev = (rank - 1) % n
            state.buddy = {}
            for name, parts in self._own_buddy_rows(state):
                state.buddy[name] = {
                    k: (torch.from_numpy(np.ascontiguousarray(
                        full[name][prev])).to(self.device)
                        if k == "params" else torch.zeros_like(t))
                    for k, t in parts.items()}
        return state

    # ------------------------------------------------------------------
    # the sync point's engines
    # ------------------------------------------------------------------
    @property
    def inner_group_rank(self) -> int:
        """This worker's rank on its inner line (its slice)."""
        return 0 if self.inner_group is None else self.inner_group.rank

    def sync_wire_split(self) -> tuple[int, int]:
        """``(ici, dcn)``: the bytes this worker sends per round sync by
        level (JAX ``train.py:905-967``); a flat engine's are all ICI."""
        if self.hier:
            split = comms.hier_wire_bytes(
                self.layout.leaves, self.n_inner, topology=self.cfg.topology,
                wire_dtype=self.sync_wire_dtype,
                outer_wire_dtype=self.sync_wire_dtype_outer,
                bucket_bytes=self.sync_bucket_bytes)
            return split["ici"], split["dcn"]
        return self.sync_wire_bytes(), 0

    def sync_wire_bytes(self) -> int:
        """Bytes this worker sends per round sync (JAX
        ``comms.sync_wire_bytes`` for the resolved engine)."""
        if self.hier:
            return sum(self.sync_wire_split())
        shapes = (self.layout.leaves if self.layout is not None
                  else [(tuple(p.shape), p.dtype) for p in self.params])
        wire = self.sync_wire_dtype if self.layout is not None else None
        return comms.sync_wire_bytes(
            shapes, self.n_workers, mode=self.sync_mode, wire_dtype=wire,
            bucket_bytes=self.sync_bucket_bytes,
            topology=self.cfg.topology) + self.buddy_wire_bytes()

    def buddy_wire_bytes(self) -> int:
        """Bytes this worker's buddy hop sends per round sync (JAX
        ``comms.buddy_wire_bytes``; 0 without the hop)."""
        if not self.buddy_on:
            return 0
        return comms.buddy_wire_bytes(
            self.layout.leaves, self.n_workers,
            wire_dtype=self.sync_wire_dtype,
            bucket_bytes=self.sync_bucket_bytes, params=self.resident_on,
            tracker=self.round_opt_on and self.opt_placement == "sharded",
            ef=self.resident_on and self.sync_ef)

    def _engine_sync(self, tensors, residual=None, tracker=None,
                     group: mesh.Group | None = None, **extra):
        """One sync of ``tensors`` by the resolved engine over ``group``
        (the engine's group by default): ``(synced, residual, tracker)``
        and what ``extra`` arms (``residency``, ``buddy``, ``poison``;
        ``comms.fast_sync``); the fast engines never fall back to the
        dense path."""
        cfg = self.cfg
        sync = probe.track(self._programs,
                           "sync" if group is None else "stale_sync",
                           comms.fast_sync)
        if self.hier:
            extra.update(outer_group=self.outer_group,
                         outer_wire_dtype=self.sync_wire_dtype_outer)
            group = self.inner_group
        return sync(
            tensors, group=self.group if group is None else group,
            mode=self.sync_mode, how=cfg.aggregation_type,
            topology=cfg.topology, local_weight=cfg.local_weight,
            wire_dtype=self.sync_wire_dtype, residual=residual,
            bucket_bytes=self.sync_bucket_bytes,
            opt_placement=("replicated" if self.opt_placement == "replicated"
                           else "sharded"),
            tracker=tracker, layout=self.layout, **extra)

    def _stale_enter(self, state: TrainState) -> TrainState:
        """Round entry under staleness: move the EF residual engine-side
        (first round), then deliver every due consensus delta (oldest
        first, while more than K are in flight)."""
        if self.sync_ef and state.sync_residual is not None:
            self._stale_residual = state.sync_residual
            state.sync_residual = None
        self._delivered = None
        while len(self._pending) > self.staleness:
            self._deliver_oldest()
        return state

    @torch.no_grad()
    def _deliver_oldest(self) -> None:
        """Fold the oldest in-flight delta into the parameters
        (``comms.deliver_stale``, in place): ``exposed_ms`` is how long
        this thread waited for it, ``hidden_ms`` the rest of its wall."""
        rec = self._pending.pop(0)
        t0 = time.perf_counter()
        delta, wall_ms = rec["future"].result()
        exposed_ms = (time.perf_counter() - t0) * 1e3
        hidden_ms = (0.0 if self.staleness_serial
                     else max(0.0, wall_ms - exposed_ms))
        self._on_this_stream(delta)
        torch._foreach_add_(self.params, delta)
        self._delivered = {"sync_ms": round(wall_ms, 3),
                           "sync_hidden_ms": round(hidden_ms, 3)}
        self.stale_log.append({**self._delivered,
                               "exposed_ms": round(exposed_ms, 3)})

    def _on_this_stream(self, tensors) -> None:
        """Tie tensors the sync stream made to the current stream (the
        allocator must not hand their memory back to the sync stream
        while this one still reads it)."""
        if self._sync_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            for t in tensors:
                t.record_stream(cur)

    def _stale_dispatch(self) -> None:
        """Start this round's sync on the sync thread, on a copy of the
        trained parameters taken now (the next round trains the live
        ones), and enqueue it; the EF residual chains from sync to sync on
        the thread (one thread: the syncs run in dispatch order)."""
        from concurrent.futures import ThreadPoolExecutor
        if self._sync_pool is None:
            self._sync_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="stale-sync")
        base = [p.detach().clone() for p in self.params]
        stream = ready = None
        if self.device.type == "cuda":
            if self._sync_stream is None:
                self._sync_stream = torch.cuda.Stream(self.device)
            stream = self._sync_stream
            ready = torch.cuda.Event()
            ready.record()                 # the copies above are queued
            for t in base:
                t.record_stream(stream)

        def job():
            t0 = time.perf_counter()
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()), torch.no_grad():
                if stream is not None:
                    stream.wait_event(ready)
                agg, res, _ = self._engine_sync(
                    base, self._stale_residual if self.sync_ef else None,
                    group=self._sync_group)
                if self.sync_ef:
                    self._stale_residual = res
                delta = comms.stale_delta(agg, base)
                if stream is not None:
                    stream.synchronize()
            return delta, (time.perf_counter() - t0) * 1e3

        fut = self._sync_pool.submit(job)
        self._pending.append({"future": fut})
        if self.staleness_serial:
            fut.result()

    def drain_pending(self, state: TrainState) -> TrainState:
        """End of the run: deliver every delta still in flight (oldest
        first) and put the engine-side EF residual back into the state;
        a no-op without staleness."""
        while self._pending:
            self._deliver_oldest()
        if self._stale_residual is not None:
            self._on_this_stream(self._stale_residual)
            state.sync_residual = self._stale_residual
            self._stale_residual = None
        if self._sync_pool is not None:
            self._sync_pool.shutdown(wait=True)
            self._sync_pool = None
        return state

    def state_resident_bytes(self, state: TrainState) -> dict:
        """Per-worker bytes of each state component, with JAX's keys
        (``train.py:996-1055``): the optimizer row counts the moments and
        an int32 step count, the round optimizer its moment rows.  Under
        the resident layout ``params`` counts the 1/N bucket rows (the
        only between-round parameter state) and ``params_gathered_peak``
        the padded vectors the entry gather rebuilds (exactly N x the
        rows); ``buddy`` the second copy of the predecessor's rows."""
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        round_opt = [m for b in (state.round_opt or {}).values()
                     for m in b.values()]
        resident = list((state.params_resident or {}).values())
        buddy = [t for b in (state.buddy or {}).values() for t in b.values()]
        return {"params": (nbytes(resident) if resident
                           else nbytes(self.params)),
                # the entry gather rebuilds the padded vectors from the
                # rows of the inner line (the slice)
                "params_gathered_peak": self.n_inner * nbytes(resident),
                "opt_state": nbytes(state.opt.state_tensors()) + 4,
                "ef_residual": nbytes(state.sync_residual or []),
                "ef_residual_outer": nbytes(
                    list((state.sync_residual_outer or {}).values())),
                "round_opt": nbytes(round_opt),
                "buddy": nbytes(buddy),
                "batch_stats": nbytes([b for n, b in
                                       self.model.named_buffers()
                                       if ".running_" in f".{n}"]),
                "bookkeeping": 4 + 8}

    # ------------------------------------------------------------------
    # the scatter-resident layout, the buddy rows and the screen
    # ------------------------------------------------------------------
    @property
    def _released(self) -> bool:
        return hasattr(self.model, "_released_params")

    @torch.no_grad()
    def _release_params(self) -> None:
        """Free the parameters' memory between rounds (the resident
        layout's point: the 1/N rows are the only parameter state).  The
        Parameter objects stay (Adam holds them); their shapes and strides
        are kept on the module for ``_unrelease``."""
        if self._released:
            return
        self.model._released_params = [(tuple(p.shape), p.stride())
                                       for p in self.params]
        for p in self.params:
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def _unrelease(self) -> None:
        """Fresh (uninitialized) memory of the released shapes and
        strides; the caller fills it."""
        meta = getattr(self.model, "_released_params", None)
        if meta is None:
            return
        for p, (shape, stride) in zip(self.params, meta):
            p.data = torch.empty_strided(shape, stride, dtype=p.dtype,
                                         device=p.device)
        del self.model._released_params

    @torch.no_grad()
    def _gather_params(self, state: TrainState) -> float:
        """The round-entry gather (JAX ``resident_gather``): every rank's
        resident rows, unpacked into the module's parameters.  A
        collective; returns its milliseconds."""
        t0 = time.perf_counter()
        self._unrelease()
        gather = probe.track(self._programs, "resident_enter", lambda rows:
                             comms.resident_gather(
                                 rows, group=self.inner_group,
                                 layout=self.layout,
                                 like=self.params,
                                 bucket_bytes=self.sync_bucket_bytes))
        full = gather(state.params_resident)
        torch._foreach_copy_(self.params, full)
        self._sync()
        return (time.perf_counter() - t0) * 1e3

    def params_checksum(self, state: TrainState) -> str:
        """``comms.checksum`` of the parameters this worker trains the
        next round with (a resident state's gather first: a collective)."""
        self.materialize_params(state)
        return comms.checksum(self.params)

    def materialize_params(self, state: TrainState) -> TrainState:
        """Give the module the consensus parameters of a resident state
        (the entry gather, a collective: every rank calls it); a no-op
        otherwise."""
        if state.params_resident is not None and self._released:
            self._gather_params(state)
        return state

    def stage_poison(self, poisoned: bool) -> None:
        """This worker's poison flag for the next sync (the ``nan@R:wI``
        fault; JAX ``stage_poison``)."""
        if not self.nan_screen:
            raise ValueError("stage_poison needs an engine built with "
                             "nan_screen=True (the chaos schedule's nan "
                             "faults arm it)")
        self._poison = bool(poisoned)

    def _block_poison(self, poison: bool, tensors, residual) -> bool:
        """The screen's verdict on this worker's contribution: on a rank
        grid the AND over its block's ranks of each shard's own
        (``comms.contribution_ok``), taken before the data line gathers
        the flags, so that every coordinate's sync quarantines the same
        workers; this rank's flag alone off the grid."""
        if self.grid is None or self.grid.block is None:
            return poison
        ok = comms.contribution_ok(poison, tensors or [], residual)
        flags = comms._all_reduce_sum(
            torch.tensor([float(ok)]), self.grid.block)
        return float(flags[0]) < self.grid.block.world_size

    def _own_buddy_rows(self, state: TrainState) -> list:
        """This worker's shard-resident rows in the buddy layout's order:
        per bucket the resident row, the EF residual's owned span and the
        sharded round optimizer's rows (what the sync's hop sends)."""
        out = []
        n, rank = self.n_workers, self.rank
        res = (self.layout.pack(state.sync_residual)
               if self.resident_on and state.sync_residual is not None
               else None)
        starts = comms._leaf_starts(self.layout.leaves)
        for i, b in enumerate(comms.bucket_plan(self.layout.leaves, n,
                                                self.sync_bucket_bytes)):
            name, row = comms.bucket_name(i), b.padded // n
            parts = {}
            if self.resident_on:
                parts["params"] = state.params_resident[name]
                if res is not None:
                    pos = comms._positions(b, starts)
                    full = res.new_zeros(b.padded)
                    full[:len(pos)] = res[torch.from_numpy(pos).to(
                        res.device)]
                    parts["res"] = full[rank * row:(rank + 1) * row]
            if self.round_opt_on and self.opt_placement == "sharded":
                parts["mu"] = state.round_opt[name]["mu"]
                parts["nu"] = state.round_opt[name]["nu"]
            out.append((name, parts))
        return out

    @torch.no_grad()
    def refresh_buddy(self, state: TrainState) -> TrainState:
        """``state`` with its buddy rows (re)derived: one ring hop of this
        worker's shard-resident rows (fp32), so every rank holds its
        predecessor's (JAX ``refresh_buddy``/``derive_buddy``; used at
        init, restore and restage, where the sync's hop has not run yet).
        A collective; a no-op without the hop."""
        if not self.buddy_on:
            state.buddy = None
            return state
        rows = self._own_buddy_rows(state)
        flat = [t for _n, parts in rows for t in parts.values()]
        got = iter(comms.ring_hop(flat, self.group, "buddy/refresh",
                                  kind="buddy_refresh"))
        state.buddy = {name: {k: next(got) for k in parts}
                       for name, parts in rows}
        return state

    def checkpoint_fence(self, state: TrainState) -> TrainState:
        """The barrier a host copy of ``state`` needs: the card has
        finished every kernel that writes it (JAX ``checkpoint_fence``)."""
        self._sync()
        return state

    @torch.no_grad()
    def host_row(self, state: TrainState) -> dict:
        """This worker's state as host numpy (copies, behind the fence):
        the row ``elastic.stack_rows`` stacks, ``stage_state`` restages."""
        self.checkpoint_fence(state)
        cpu = lambda t: t.detach().to("cpu", copy=True).numpy()
        tree = lambda d: (None if d is None else
                          {k: tree(v) if isinstance(v, dict) else cpu(v)
                           for k, v in d.items()})
        resident = state.params_resident is not None
        return {
            "params": (None if resident else
                       {n: cpu(p) for n, p in zip(self.names, self.params)}),
            "buffers": {n: cpu(b) for n, b in self.model.named_buffers()},
            "mu": dict(zip(self.names, map(cpu, state.opt.mu))),
            "nu": dict(zip(self.names, map(cpu, state.opt.nu))),
            "count": int(state.opt.count), "lr_epoch": int(state.lr_epoch),
            "rng": np.array(state.rng, np.uint32),
            "sync_residual": (None if state.sync_residual is None else
                              dict(zip(self.names,
                                       map(cpu, state.sync_residual)))),
            "round_opt": tree(state.round_opt),
            "params_resident": tree(state.params_resident),
            "buddy": tree(state.buddy)}

    @torch.no_grad()
    def stage_state(self, row: dict) -> TrainState:
        """A host row (``host_row``'s dict, e.g. a membership snapshot's)
        staged on this worker's device (JAX ``stage_state``): the module's
        parameters (or, resident, the rows, with the parameters released
        until the entry gather) and buffers, the Adam moments and count,
        the clock, the seed words and the engine state.  Buddy rows
        missing from the row are re-derived (a collective)."""
        if not self.resident_on and row["params_resident"] is not None:
            raise ValueError(
                f"stage_state: the row's params are scatter-resident but "
                f"the engine's residency is {self.param_residency!r} — "
                "re-lay the host state out first")
        if self.resident_on and row["params_resident"] is None:
            # a replicated consensus row (e.g. a quorum of one that grew
            # again): its shard is this position's resident row
            row = {**row, "params_resident": {
                k: v.numpy() for k, v in comms.resident_rows(
                    [row["params"][n] for n in self.names], self.n_workers,
                    self.rank, template=self.params_template,
                    bucket_bytes=self.sync_bucket_bytes).items()},
                "params": None}
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        tree = lambda d: (None if d is None else
                          {k: tree(v) if isinstance(v, dict) else put(v)
                           for k, v in d.items()})
        if row["params"] is not None:
            for name, p in zip(self.names, self.params):
                p.copy_(put(row["params"][name]))
        buffers = dict(self.model.named_buffers())
        for name, b in buffers.items():
            b.copy_(put(row["buffers"][name]))
        opt = Adam(self.params)
        for dst, part in ((opt.mu, "mu"), (opt.nu, "nu")):
            for t, name in zip(dst, self.names):
                t.copy_(put(row[part][name]))
        opt.count = int(row["count"])
        state = TrainState(
            opt=opt, lr_epoch=int(row["lr_epoch"]),
            rng=np.asarray(row["rng"], np.uint32).reshape(2),
            sync_residual=(None if row["sync_residual"] is None else
                           [put(row["sync_residual"][n])
                            for n in self.names]),
            round_opt=tree(row["round_opt"]),
            params_resident=tree(row["params_resident"]),
            buddy=tree(row["buddy"]) if self.buddy_on else None)
        if self.resident_on:
            self._release_params()
        if self.buddy_on and state.buddy is None:
            state = self.refresh_buddy(state)
        return state

    def checkpoint_state(self, state: TrainState):
        """The live tensors of ``state`` as a ``checkpoint.WorkerState``
        (the checkpoint engine snapshots them)."""
        from .checkpoint import WorkerState
        from .weights import state_layout
        resident = state.params_resident is not None
        if self.gp is not None:
            # this rank's shards, keyed by leaf, with where they sit in the
            # whole leaves and whether this rank writes them
            gp = self.gp
            keyed = lambda ts: dict(zip(self.names, ts))
            return WorkerState(
                params=keyed(self.params),
                buffers=dict(self.model.named_buffers()),
                mu=keyed(state.opt.mu), nu=keyed(state.opt.nu),
                count=state.opt.count, lr_epoch=state.lr_epoch,
                rng=state.rng, layout=gp.dense_layout, worker=self.rank,
                n_workers=self.n_workers,
                residual=(None if state.sync_residual is None
                          else keyed(state.sync_residual)),
                grid=dict(keys=list(gp.keys), index=gp.index,
                          full_shapes=[gp.full_shapes[k] for k in gp.keys],
                          writes=[gp.writes(i) for i in range(len(gp.keys))],
                          lead=all(self.grid.index(a) == 0
                                   for a in ("fsdp", "seq", "pipe",
                                             "expert", "model"))))
        return WorkerState(
            params={} if resident else dict(zip(self.names, self.params)),
            buffers=dict(self.model.named_buffers()),
            mu=dict(zip(self.names, state.opt.mu)),
            nu=dict(zip(self.names, state.opt.nu)),
            count=state.opt.count, lr_epoch=state.lr_epoch, rng=state.rng,
            layout=state_layout(self.model), worker=self.rank,
            n_workers=self.n_workers,
            residual=(None if state.sync_residual is None
                      else dict(zip(self.names, state.sync_residual))),
            round_opt=state.round_opt,
            params_resident=state.params_resident,
            residual_outer=state.sync_residual_outer)

    @torch.no_grad()
    def load_checkpoint_state(self, state: TrainState, restored
                              ) -> TrainState:
        """Copy a restored ``checkpoint.WorkerState`` (host arrays) into
        the module and ``state``; returns ``state``.  On the grid the
        restored leaves are whole (``checkpoint.restore_grid``) and this
        rank's shard of each is taken."""
        if self.gp is not None:
            self.gp.load(self.params, restored.params)
            self.gp.load(state.opt.mu, restored.mu)
            self.gp.load(state.opt.nu, restored.nu)
            if state.sync_residual is not None:
                if restored.residual is None:
                    raise ValueError(
                        "the checkpoint has no .sync_residual leaves, "
                        "required by --sync_compression ef")
                self.gp.load(state.sync_residual, restored.residual)
            for name, t in self.model.named_buffers():
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    restored.buffers[name])))
            state.opt.count = int(restored.count)
            state.lr_epoch = int(restored.lr_epoch)
            state.rng = np.asarray(restored.rng, np.uint32).reshape(2)
            return state
        live = self.checkpoint_state(state)
        for part in ("params", "buffers", "mu", "nu"):
            src = getattr(restored, part)
            for name, t in getattr(live, part).items():
                t.copy_(torch.from_numpy(np.ascontiguousarray(src[name])))
        for part in ("residual", "round_opt", "params_resident",
                     "residual_outer"):
            src, dst = getattr(restored, part), getattr(live, part)
            if dst is None:
                continue
            if part == "round_opt":
                src = {f"{b}/{m}": v for b, ms in src.items()
                       for m, v in ms.items()}
                dst = {f"{b}/{m}": v for b, ms in dst.items()
                       for m, v in ms.items()}
            for name, t in dst.items():
                t.copy_(torch.from_numpy(np.ascontiguousarray(src[name])))
        state.opt.count = int(restored.count)
        state.lr_epoch = int(restored.lr_epoch)
        state.rng = np.asarray(restored.rng, np.uint32).reshape(2)
        # buddy rows are never saved: derive them from what was restored
        return self.refresh_buddy(state)

    def rank0_variables(self, state: TrainState | None = None
                        ) -> dict[str, torch.Tensor]:
        """This worker's parameters and buffers by ``state_dict`` name
        (detached).  Given a resident ``state`` whose parameters are
        released, the consensus is gathered into the module first (JAX
        ``resident_consensus``; a collective: every rank calls it)."""
        if state is not None:
            self.materialize_params(state)
        if self.gp is not None:
            # the worker's whole parameters, by the dense twin's names (a
            # collective of the worker's ranks)
            out = {k: torch.from_numpy(v).to(self.device)
                   for k, v in self.gp.port_params().items()}
            out.update({k: b.detach() for k, b in
                        self.model.named_buffers()})
            return out
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def stage_pack(self, train_pack, val_pack):
        """This worker's rows of the round's numpy packs, staged on the
        device ahead of the round (JAX ``stage_pack``): each pack is
        worker-stacked ``[N, S, ...]`` or holds this worker's row alone
        (``[1, S, ...]``, what the driver builds).  The overlapped driver
        calls this on its prep thread while the previous round computes:
        on a card the copies run from pinned buffers on a side stream,
        and the round waits for their event on its own stream."""
        if self._staging is None:
            self._staging = WindowStaging(self.device)
        return tuple(self._staging(self._row(pack))
                     for pack in (train_pack, val_pack))

    def _row(self, pack) -> tuple:
        rows = np.shape(pack[0])[0]
        if rows not in (1, self.n_workers):
            raise ValueError(
                f"a pack of {rows} worker rows for a group of "
                f"{self.n_workers}: give every worker's row, or this "
                "worker's alone")
        row = self.rank if rows > 1 else 0
        return tuple(np.asarray(a)[row] for a in pack)

    def _token_stats(self, logits, y, m):
        """(ce, w, correct): vocab-parallel over the model line when the
        logits are this rank's vocab slice (JAX ``train.py:1403-1407``)."""
        if self.vp_group is not None:
            from .parallel.tp import vocab_parallel_token_stats
            return vocab_parallel_token_stats(logits, y, m, self.vp_group)
        return masked_token_stats(logits, y, m)

    def _applied(self):
        """The context a forward (and its backward) runs in: on the grid,
        the step's gathered parameters substituted into the module."""
        return (self.gp.applied() if self.gp is not None
                else contextlib.nullcontext())

    def _part_slice(self, x, y, m):
        """This rank's part of the worker's batch (JAX
        ``train.py:1950-1956``): its contiguous slice of the examples over
        fsdp, then its contiguous chunk of every sequence over seq (the
        tokens and the labels; the batch mask is per example); the whole
        batch off those axes."""
        if self.fsdp is not None:
            f, n = self.fsdp.rank, self.fsdp.world_size
            x, y, m = (t.chunk(n)[f] for t in (x, y, m))
        if self.seq is not None:
            s, n = self.seq.rank, self.seq.world_size
            if x.shape[1] % n:
                raise ValueError(
                    f"sequence length {x.shape[1]} is not divisible by the "
                    f"'seq' axis size {n}")
            x, y = (t.chunk(n, dim=1)[s] for t in (x, y))
        return x, y, m

    def _loss(self, x, y, m, denom, aux_div: float):
        """(loss, correct) of one forward: the masked CE numerator over
        ``denom``, plus ``moe_aux_weight`` times the summed MoE
        load-balance loss over ``aux_div`` and the part axes' sizes (JAX
        ``train.py:1596-1615``)."""
        if self.cfg.num_experts > 0:
            logits, aux = self.model(x, with_aux=True)
        else:
            logits, aux = self.model(x), None
        ce, w, correct = self._token_stats(logits, y, m)
        loss = (ce * w).sum() / denom
        if aux is not None:
            loss = loss + (self.cfg.moe_aux_weight * aux
                           / (aux_div * self.aux_parts))
        return loss, correct

    def _train_step(self, state: TrainState, x, y, m, lr: float,
                    augment: bool):
        # the whole worker batch's denominator (on the grid the same on
        # every fsdp and seq rank, which then takes its part of the batch)
        denom = masked_weights(y, m).sum().clamp_min(1.0)
        x, y, m = self._part_slice(x, y, m)
        if augment:
            x = augment_batch(x, self.generator)
        # --grad_accum K (JAX train.py:1625-1674): K slices of the batch,
        # each slice's numerator over the full step's denominator and its
        # aux over K, gradients summed in fp32, one Adam step; MoE capacity
        # is per slice, as in JAX.  K=1 is the plain step.
        k = self.cfg.grad_accum
        if self.pipe is not None:
            loss, correct, grads = self._pipe_grads(x, y, m, denom, k)
        else:
            loss, correct, grads = self._accum_grads(x, y, m, denom, k)
        if self.gp is not None:
            grads = self.gp.reduce_grads(list(grads))
        state.opt.step(self.params, grads, lr)
        if self.fsdp is not None and self._buffers:
            self._average_buffers()
        return loss.detach(), correct.detach(), grads

    def _accum_grads(self, x, y, m, denom, k: int):
        """``(loss, correct, gradients)`` of a train step: K slices of the
        batch, each slice's numerator over the full step's denominator,
        gradients summed in fp32."""
        loss = correct = grads = None
        for xs, ys, ms in zip(*(t.chunk(k) for t in (x, y, m))):
            with self._applied():
                loss_k, correct_k = self._loss(xs, ys, ms, denom, float(k))
                g_k = torch.autograd.grad(loss_k, self.params)
            if grads is None:
                loss, correct, grads = loss_k.detach(), correct_k, g_k
            else:
                loss, correct = loss + loss_k.detach(), correct + correct_k
                torch._foreach_add_(grads, g_k)
        return loss, correct, grads

    def _pipe_pass(self, x, y, m, denom, train: bool, aux_div: float = 1.0):
        """This stage's part of one pass of the microbatches of ``(x, y,
        m)`` (JAX ``train.py:1409-1532``): stage 0 embeds, every stage
        runs its blocks, the last computes each microbatch's masked CE
        numerator over ``denom`` (the whole step's) and its metric sums.
        Training runs ``--pp_schedule``'s order and returns the summed loss
        (with every stage's MoE aux, each microbatch's over M, ``aux_div``
        and the part axes' sizes) and correct count; evaluation runs the
        forwards in the GPipe order and returns the [CE sum, correct,
        weight] sums.  The correct count and the sums are None off the
        last stage, and so is the loss without experts."""
        from .parallel import pp
        xs, ys, ms = pp.microbatches(self.pp_microbatches, x, y, m)

        def last(h, i):
            ce, w, correct = self._token_stats(self.model.logits(h), ys[i],
                                               ms[i])
            if train:
                return (ce * w).sum() / denom, correct.detach()
            return None, torch.stack([(ce * w).sum(), correct, w.sum()])

        aux_weight = (self.cfg.moe_aux_weight
                      / (len(xs) * aux_div * self.aux_parts))
        return pp.model_pass(self.model, self.pipe, xs, last,
                             self.cfg.pp_schedule if train else None,
                             self.device, aux_weight=aux_weight)

    def _pipe_grads(self, x, y, m, denom, k: int):
        """``(loss, correct, gradients)`` of a train step under the pipe
        axis: K accumulation slices, each run through the schedule, the
        gradients accumulated in fp32 over every microbatch (JAX
        ``_accum_value_and_grad`` around ``_onef1b_loss_and_metrics``;
        ``GridParams.accumulate_grads``).  Off the last stage the loss and
        the correct count are zeros."""
        sums = []

        def passes():
            for xs, ys, ms in zip(*(t.chunk(k) for t in (x, y, m))):
                sums.append(self._pipe_pass(xs, ys, ms, denom, True,
                                            aux_div=float(k)))

        grads = self.gp.accumulate_grads(passes)
        loss = correct = torch.zeros((), device=self.device)
        for loss_k, correct_k in sums:
            if loss_k is not None:
                loss = loss + loss_k
            if correct_k is not None:
                correct = correct + correct_k
        return loss, correct, grads

    @torch.no_grad()
    def _average_buffers(self) -> None:
        """BatchNorm under FSDP: each rank normalised its slice of the
        batch with its own statistics; the running statistics are averaged
        over fsdp so they stay replicated (JAX ``train.py:1617-1622``)."""
        total = comms._all_reduce_sum(comms.flatten(self._buffers),
                                      self.fsdp)
        avg = comms.unflatten(total / self.fsdp.world_size, self._buffers)
        torch._foreach_copy_(self._buffers, avg)

    @torch.no_grad()
    def _eval_step(self, x, y, m):
        x, y, m = self._part_slice(x, y, m)
        with self._applied():
            if self.pipe is not None:
                _loss, sums = self._pipe_pass(x, y, m, None, False)
                return (sums if sums is not None
                        else torch.zeros(3, device=self.device))
            ce, w, correct = self._token_stats(self.model(x), y, m)
        return torch.stack([(ce * w).sum(), correct, w.sum()])

    def _part_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the fsdp and seq lines (metric sums of each
        rank's part of the batch; JAX ``_part_axes``); ``t`` off them."""
        for g in self.part_groups:
            t = comms._all_reduce_sum(t, g).view(t.shape)
        return t

    def _take_extras(self, state: TrainState, rest, extra: dict):
        """Store the buddy rows a sync returned; its validity flag (None
        without the screen)."""
        rest = list(rest)
        if extra.get("buddy"):
            state.buddy = rest.pop(0)
        return rest.pop(0) if "poison" in extra else None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def round(self, state: TrainState, train_pack, val_pack):
        """``round_start`` then ``finish_metrics``: one round on
        worker-stacked packs ``(x, y, mask)`` of shape [N, S, B, ...]
        (this worker reads row ``rank``; a pack of one row is this
        worker's own; numpy, or what ``stage_pack`` staged).  Returns
        ``(state, metrics)`` with the JAX engine's per-worker metric arrays
        (leading worker axis N, gathered over the group) plus host
        timings: this worker's ``train_ms``, ``train_steps`` and
        ``val_steps``, and every worker's ``wall_s`` (round start to its
        sync point: a wait for slower peers is not its own time),
        ``train_ms``, ``train_steps``, ``sync_ms``, its process's peak
        ``max_memory_allocated`` (``probe.max_memory_allocated``) and the
        ``memory_allocated`` it holds after the sync, on a card (0 on the
        CPU), under ``workers_*``."""
        state, handle = self.round_start(state, train_pack, val_pack)
        return state, self.finish_metrics(handle)

    def round_start(self, state: TrainState, train_pack, val_pack):
        """The round up to its metrics (JAX ``round_start``): the local
        epochs and the sync, fenced on the card when it returns (an eager
        round leaves nothing in flight).  Returns ``(state, handle)``;
        ``finish_metrics(handle)`` (from any thread) gives the metrics.
        The per-epoch values are copied to pinned host memory before the
        round's last fence, so the handle holds host arrays only."""
        t_round = time.perf_counter()
        staged = isinstance(train_pack[0], torch.Tensor)
        train, val = ((train_pack, val_pack) if staged
                      else self.stage_pack(train_pack, val_pack))
        stage_ms = (time.perf_counter() - t_round) * 1e3
        return self._run_round(state, t_round, lambda e: [train],
                               lambda e: [val], stage_ms, False)

    def round_streamed(self, state: TrainState, train_chunks, val_chunks):
        """``round_streamed_start`` then ``finish_metrics``."""
        state, handle = self.round_streamed_start(state, train_chunks,
                                                  val_chunks)
        return state, self.finish_metrics(handle)

    def round_streamed_start(self, state: TrainState, train_chunks,
                             val_chunks):
        """``round_start`` over fixed-shape windows (JAX
        ``train.py:2554-2765``): ``train_chunks(epoch)`` /
        ``val_chunks(epoch)`` give this worker's host windows ``(x [C, B,
        ...], y [C, B, ...], m [C, B])`` (``data.window_feed``) for local
        epoch ``epoch``.  With ``cfg.stream_prefetch > 0`` one
        ``ChunkStager`` of that depth stages the round's windows ahead of
        compute, across the epochs' boundaries; 0 stages each when it is
        needed (the serial twin).  The same step bodies run on the same
        bytes in the same order as ``round``, all-padding steps skipped;
        the metrics have the JAX streamed round's shapes (steps padded to
        whole windows, masked)."""
        t_round = time.perf_counter()
        depth = self.cfg.stream_prefetch
        staging = WindowStaging(self.device, slots=depth + 2)

        def source():
            # the whole round's windows in the order the round consumes
            # them, None closing each feed, so one producer keeps packing
            # ahead across the epochs' boundaries
            for epoch in range(self.cfg.epochs_local):
                for chunks in (train_chunks, val_chunks):
                    yield from chunks(epoch)
                    yield None

        def stage(window):
            return None if window is None else staging(window)

        staged = (ChunkStager(source(), stage, depth=depth) if depth > 0
                  else map(stage, source()))
        pull = iter(staged).__next__

        def feed(epoch):
            return iter(pull, None)        # this feed's windows
        try:
            return self._run_round(state, t_round, feed, feed, 0.0, True)
        finally:
            if isinstance(staged, ChunkStager):
                staged.close()

    def _windows(self, feed, epoch: int):
        """One epoch's staged windows as ``(x, y, m, w, weights)``."""
        return (take_window(item, self.device) for item in feed(epoch))

    def _epoch_scalars(self, losses, corrects, weights: np.ndarray, w):
        """Reference per-epoch scalars: loss = mean over real batches,
        accuracy = 100 * correct / total (``weights`` on the host, ``w``
        the same counts on the device).  The sums stop at the last real
        step, so trailing padding steps (a streamed round's whole-window
        tail) leave them bit for bit unchanged."""
        real = np.flatnonzero(weights > 0)
        n = int(real[-1]) + 1 if len(real) else 0
        real_step = (w[:n] > 0).float()
        loss = ((losses[:n] * real_step).sum()
                / real_step.sum().clamp_min(1))
        acc = 100.0 * corrects[:n].sum() / w[:n].sum().clamp_min(1)
        return loss, acc

    def _run_round(self, state: TrainState, t_round: float, train_feed,
                   val_feed, stage_ms: float, streamed: bool):
        """The round's body over windows: ``train_feed(epoch)`` and
        ``val_feed(epoch)`` yield staged windows ``(x, y, m, w, weights,
        ready)`` (one whole-round window for ``round_start``); the step
        programs register as ``train_step``/``eval_step``, or
        ``chunk_train``/``chunk_eval`` for ``streamed`` windows (JAX's
        labels of its streamed programs).  Returns ``(state, handle)``."""
        cfg = self.cfg
        if self._metrics_group is None and self.grid is not None:
            # every rank's metrics meet on the grid's world
            self._metrics_group = self.grid.world.split()
        elif self._metrics_group is None and self.group is not None:
            self._metrics_group = self.group.split()
        if self.staleness:
            state = self._stale_enter(state)
        gather_ms = 0.0
        if state.params_resident is not None:
            # the resident layout: the round starts with the entry gather
            gather_ms = self._gather_params(state)
        train_name, eval_name = (("chunk_train", "chunk_eval") if streamed
                                 else ("train_step", "eval_step"))
        train_step = probe.track(self._programs, train_name,
                                 self._train_step, state=self._step_state)
        eval_step = probe.track(self._programs, eval_name, self._eval_step,
                                state=self._module_state)
        seed = round_seed(state.rng, state.lr_epoch)
        if self.fsdp is not None:
            # the worker's stream is the same on its fsdp ranks while the
            # batch is split over them: decorrelate by the fsdp index (JAX
            # train.py:1687-1692)
            seed = int(np.random.SeedSequence([seed, self.fsdp.rank])
                       .generate_state(1, np.uint64)[0])
        self.generator.manual_seed(seed)
        dev = self.device
        per_epoch = {k: [] for k in ("batch_losses", "batch_mask",
                                     "train_loss", "train_acc", "val_loss",
                                     "val_acc")}
        last_grads: Optional[list] = None
        train_s, train_steps, val_steps = 0.0, 0, 0
        for e in range(cfg.epochs_local):
            lr = steplr(cfg.lr, cfg.lr_gamma, cfg.lr_step_size,
                        state.lr_epoch)
            losses, corrects, weights, ws = [], [], [], []
            self.model.train()
            self._sync()
            t0 = time.perf_counter()
            for x, y, m, w, real in self._windows(train_feed, e):
                augment = cfg.augment and x.ndim == 5   # [S, B, H, W, C]
                lw = torch.zeros(len(real), device=dev)
                cw = torch.zeros(len(real), device=dev)
                for s in range(len(real)):
                    if real[s] == 0:     # all padding: the step is a no-op
                        continue
                    lw[s], cw[s], last_grads = train_step(
                        state, x[s], y[s], m[s], lr, augment)
                    train_steps += 1
                losses.append(lw)
                corrects.append(cw)
                weights.append(real)
                ws.append(w)
            self._sync()
            train_s += time.perf_counter() - t0
            losses = (torch.cat(losses) if losses
                      else torch.zeros(0, device=dev))
            corrects = (torch.cat(corrects) if corrects
                        else torch.zeros(0, device=dev))
            if self.part_groups and len(losses):
                # each rank's numerators of its part, summed once an epoch
                losses, corrects = self._part_sum(
                    torch.stack([losses, corrects])).unbind(0)
            weights = (np.concatenate(weights) if weights
                       else np.zeros(0, np.float32))
            ws = torch.cat(ws) if ws else torch.zeros(0, device=dev)
            train_loss, train_acc = self._epoch_scalars(losses, corrects,
                                                        weights, ws)
            vsum = torch.zeros(3, device=dev)
            self.model.eval()
            for xv, yv, mv, _wv, real_v in self._windows(val_feed, e):
                for s in range(len(real_v)):
                    if real_v[s] > 0:
                        vsum += eval_step(xv[s], yv[s], mv[s])
                        val_steps += 1
            vsum = self._part_sum(vsum)
            per_epoch["batch_losses"].append(losses)
            per_epoch["batch_mask"].append((ws > 0).float())
            per_epoch["train_loss"].append(train_loss)
            per_epoch["train_acc"].append(train_acc)
            per_epoch["val_loss"].append(vsum[0] / vsum[2].clamp_min(1))
            per_epoch["val_acc"].append(100.0 * vsum[1] / vsum[2].clamp_min(1))
            state.lr_epoch += 1

        self._sync()
        wall_s = time.perf_counter() - t_round
        # the per-epoch values to pinned host memory, queued now and
        # complete at the sync point's fence below
        own = to_host({k: torch.stack(v) for k, v in per_epoch.items()})

        # --- the sync point (the identity at one worker) -----------------
        # weights mode aggregates the parameters only: BatchNorm
        # statistics and Adam moments stay per worker (JAX models/cnn.py:
        # 13-16); gradients mode aggregates the last real step's
        # gradients (zeros if the worker ran none) into agg_grad_norm and
        # leaves the parameters untouched (JAX train.py:818-822), the
        # round optimizer's moments taking the mean gradient.  Under
        # --sync_staleness K the weights sync starts on the sync thread
        # and its delta lands at the entry of round R+K+1.
        t0 = time.perf_counter()
        agg_norm = torch.zeros((), device=dev)
        # the buddy hop and the chaos screen ride the sync when armed
        extra = {}
        if self.buddy_on:
            extra["buddy"] = True
        if self.nan_screen:
            extra["poison"] = self._block_poison(
                self._poison, last_grads if cfg.aggregation_by != "weights"
                else self.params, state.sync_residual)
            self._poison = False
        if self.hier and cfg.aggregation_by == "weights":
            # the outer level's residual rides the hierarchical sync
            extra["outer_residual"] = state.sync_residual_outer
        ok = None
        if cfg.aggregation_by == "weights":
            if self.staleness:
                self._stale_dispatch()
            elif self.resident_on:
                # the sync ends at the scatter: the decoded shard is the
                # state, and the parameters' storage goes until the entry
                rets = self._engine_sync(self.params, state.sync_residual,
                                         residency="resident", **extra)
                state.params_resident, state.sync_residual = rets[:2]
                if self.hier:
                    state.sync_residual_outer = rets[3]
                else:
                    ok = self._take_extras(state, rets[3:], extra)
                self._release_params()
            else:
                rets = self._engine_sync(self.params, state.sync_residual,
                                         **extra)
                agg, state.sync_residual = rets[:2]
                if self.hier:
                    state.sync_residual_outer = rets[3]
                else:
                    ok = self._take_extras(state, rets[3:], extra)
                if self.group is not None:
                    with torch.no_grad():
                        torch._foreach_copy_(self.params, agg)
        else:
            grads = (last_grads if last_grads is not None
                     else [torch.zeros_like(p) for p in self.params])
            # (hier: the collectives run replicated and the aggregate is
            # discarded after its norm, JAX train.py:775-783)
            rets = self._engine_sync(grads, tracker=state.round_opt,
                                     **extra)
            agg, state.round_opt = rets[0], rets[2]
            if not self.hier:
                ok = self._take_extras(state, rets[3:], extra)
            agg_norm = (self.gp.global_norm(agg) if self.gp is not None
                        else comms.global_norm(agg))
        own.update(to_host({"agg_grad_norm": agg_norm}))
        self._sync()
        sync_ms = (time.perf_counter() - t0) * 1e3
        delivered = self._delivered or {}
        if self.staleness:
            # the wall of the sync whose delta landed at this round's
            # entry (its dispatch here takes ~nothing)
            sync_ms = delivered.get("sync_ms", 0.0)
        # the per-level split of the wall: a byte-proportional model
        # (JAX train.py:2104-2107), not a measurement
        ici_ms, dcn_ms = probe.attribute_sync_wall(
            sync_ms, *self.sync_wire_split())
        self.last_sync_stats = {
            "sync_mode": self.sync_mode, "sync_ms": round(sync_ms, 3),
            "sync_hidden_ms": delivered.get("sync_hidden_ms", 0.0),
            "gather_ms": round(gather_ms, 3), "sync_ms_ici": ici_ms,
            "sync_ms_dcn": dcn_ms}
        if ok is not None:
            own["sync_ok"] = np.float32(ok)
        peak = probe.max_memory_allocated(dev)
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        return state, dict(
            own=own, timing=(wall_s, train_s * 1e3, train_steps, sync_ms,
                             peak, held),
            train_ms=train_s * 1e3, train_steps=train_steps,
            val_steps=val_steps, stage_ms=round(stage_ms, 3))

    def finish_metrics(self, handle) -> dict:
        """A round's metrics from its ``round_start`` handle (JAX
        ``finish_metrics``; safe on another thread while the next round
        runs): this worker's host values, every worker's gathered over
        the engine's metric group, and the cross-worker means."""
        own = {k: (np.array(v.numpy()) if isinstance(v, torch.Tensor)
                   else v) for k, v in handle["own"].items()}
        own["timing"] = handle["timing"]
        rows = ranks = mesh.all_gather(self._metrics_group, own)
        blocks = [[r] for r in rows]
        if self.grid is not None:
            # on the grid: each worker's values are its first rank's (every
            # rank of the worker holds the same), its wall its slowest
            # rank's; the memory counters stay per rank
            data = [self.grid.coords_of(r)["data"]
                    for r in range(len(rows))]
            blocks = [[row for row, d in zip(rows, data) if d == w]
                      for w in range(self.grid.size("data"))]
            rows = [rows[r] for r in self.grid.block_leads()]
        mx = cross_worker_means(
            {k: np.stack([r[k] for r in rows]) for k in own
             if k != "timing"})
        mx["train_ms"] = handle["train_ms"]
        mx["train_steps"] = handle["train_steps"]
        mx["val_steps"] = handle["val_steps"]
        for i, k in enumerate(("wall_s", "train_ms", "train_steps",
                               "sync_ms", "max_memory_allocated",
                               "memory_allocated")):
            mx[f"workers_{k}"] = [max(b["timing"][i] for b in block)
                                  for block in blocks]
        if self.grid is not None:
            for i, k in ((1, "train_ms"), (4, "max_memory_allocated"),
                         (5, "memory_allocated")):
                mx[f"ranks_{k}"] = [b["timing"][i] for block in blocks
                                    for b in block]
            if "sync_ok" in own:
                # every rank's verdict, by world rank (the same within a
                # block: the screen's is block-wide)
                mx["ranks_sync_ok"] = [float(r["sync_ok"]) for r in ranks]
        return mx
