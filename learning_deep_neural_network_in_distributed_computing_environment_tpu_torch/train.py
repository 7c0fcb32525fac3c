"""Local training phase: the per-step loss, Adam, and one worker's local-SGD
round (port of the JAX package's ``train.py``: ``TrainState`` :71-134,
``steplr``/CE/masking :232-320, Adam :518 + :1718-1720, the step and round
bodies :1676-1823, and the single-worker part of ``round`` :2343).

PyTorch runs eagerly, so the round is a Python loop over steps instead of
a compiled scan.  A step whose batch is all padding (or ignore-index) is
skipped on the host before any work: in the JAX engine such a step leaves
params, optimizer state and carried gradients untouched and records a
zero loss, which is exactly what skipping does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import comms
from .config import Config


def steplr(lr0: float, gamma: float, step_size: int, epoch: int) -> float:
    """torch StepLR, stepped per LOCAL epoch."""
    return lr0 * gamma ** (epoch // step_size)


class SoftmaxCrossEntropy(torch.autograd.Function):
    """Per-example CE (``nn.CrossEntropyLoss`` semantics) whose only
    residuals are the logits (in their own dtype) and the fp32 log-sum-exp:
    the backward recomputes the softmax instead of keeping an fp32
    [.., vocab] ``log_softmax``.  Labels are clamped into range once, so the
    forward's gather and the backward's one-hot agree for any input
    (ignore-index positions are masked by the caller)."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor):
        labels = labels.clamp(0, logits.shape[-1] - 1)
        lse = torch.logsumexp(logits.float(), dim=-1)
        ll = logits.float().gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        d.scatter_add_(-1, labels[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return (d * g[..., None]).to(logits.dtype), None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    return SoftmaxCrossEntropy.apply(logits, labels)


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


class Adam:
    """``optax.scale_by_adam(b1, b2, eps)`` followed by ``-lr * u``, in
    place on fp32 parameters (moments are fp32, ``count`` advances only on
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
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        # bias corrections in fp32, as optax computes them
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(params, mu_hat, alpha=-lr)

    def state_tensors(self) -> list[torch.Tensor]:
        return self.mu + self.nu


@dataclasses.dataclass
class TrainState:
    """One worker's state between rounds.  The parameters live in the
    engine's module; this holds what the JAX ``TrainState`` carries beside
    them for this slice: the Adam moments and the StepLR clock."""

    opt: Adam
    lr_epoch: int = 0            # local epochs completed (StepLR clock)


class LocalSGDEngine:
    """One worker's local-SGD rounds: ``epochs_local`` x (train loop +
    per-epoch validation on the worker's own shard), then the sync point."""

    def __init__(self, model: nn.Module, cfg: Config, device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.n_workers = 1
        self.params = [p for p in model.parameters()]

    def init_state(self) -> TrainState:
        return TrainState(opt=Adam(self.params))

    def rank0_variables(self) -> dict[str, torch.Tensor]:
        """Worker 0's parameters by ``state_dict`` name (detached)."""
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def _to_device(self, pack):
        x, y, m = (np.asarray(a)[0] for a in pack)     # worker 0 of [N, S, ...]
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dt)
        real = (masked_weights(torch.from_numpy(y), torch.from_numpy(m))
                .reshape(len(m), -1).sum(-1).numpy())
        return t(x, torch.long), t(y, torch.long), t(m, torch.float32), real

    def _train_step(self, state: TrainState, x, y, m, lr: float):
        logits = self.model(x)
        ce, w, correct = masked_token_stats(logits, y, m)
        total = w.sum()
        loss = (ce * w).sum() / total.clamp_min(1.0)
        grads = torch.autograd.grad(loss, self.params)
        state.opt.step(self.params, grads, lr)
        return loss.detach(), correct.detach(), grads

    @torch.no_grad()
    def _eval_step(self, x, y, m):
        ce, w, correct = masked_token_stats(self.model(x), y, m)
        return torch.stack([(ce * w).sum(), correct, w.sum()])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def round(self, state: TrainState, train_pack, val_pack):
        """Run one round on numpy packs ``(x, y, mask)`` of shape
        [1, S, B, ...]; returns ``(state, metrics)`` with the JAX engine's
        per-worker metric arrays (leading worker axis of 1) plus host
        timings (``train_ms``, ``train_steps``, ``val_steps``)."""
        cfg = self.cfg
        x, y, m, real = self._to_device(train_pack)
        xv, yv, mv, real_v = self._to_device(val_pack)
        dev = self.device
        steps = len(real)
        per_epoch = {k: [] for k in ("batch_losses", "batch_mask",
                                     "train_loss", "train_acc", "val_loss",
                                     "val_acc")}
        last_grads: Optional[list] = None
        train_s, train_steps, val_steps = 0.0, 0, 0
        for _ in range(cfg.epochs_local):
            lr = steplr(cfg.lr, cfg.lr_gamma, cfg.lr_step_size,
                        state.lr_epoch)
            losses = torch.zeros(steps, device=dev)
            corrects = torch.zeros(steps, device=dev)
            self._sync()
            t0 = time.perf_counter()
            for s in range(steps):
                if real[s] == 0:      # all padding: the step is a no-op
                    continue
                losses[s], corrects[s], last_grads = self._train_step(
                    state, x[s], y[s], m[s], lr)
                train_steps += 1
            self._sync()
            train_s += time.perf_counter() - t0
            real_step = torch.as_tensor(real > 0, dtype=torch.float32,
                                        device=dev)
            # reference per-epoch scalars: loss = mean over real batches,
            # accuracy = 100 * correct / total
            totals = torch.as_tensor(real, dtype=torch.float32, device=dev)
            train_loss = (losses * real_step).sum() / real_step.sum().clamp_min(1)
            train_acc = 100.0 * corrects.sum() / totals.sum().clamp_min(1)
            vsum = torch.zeros(3, device=dev)
            for s in range(len(real_v)):
                if real_v[s] > 0:
                    vsum += self._eval_step(xv[s], yv[s], mv[s])
                    val_steps += 1
            per_epoch["batch_losses"].append(losses)
            per_epoch["batch_mask"].append(real_step)
            per_epoch["train_loss"].append(train_loss)
            per_epoch["train_acc"].append(train_acc)
            per_epoch["val_loss"].append(vsum[0] / vsum[2].clamp_min(1))
            per_epoch["val_acc"].append(100.0 * vsum[1] / vsum[2].clamp_min(1))
            state.lr_epoch += 1

        # --- the sync point (identity at one worker) ---------------------
        agg_norm = torch.zeros((), device=dev)
        if cfg.aggregation_by == "weights":
            comms.aggregate(self.params, how=cfg.aggregation_type,
                            topology=cfg.topology,
                            local_weight=cfg.local_weight,
                            world_size=self.n_workers)
        elif last_grads is not None:
            agg_norm = comms.global_norm(comms.aggregate(
                last_grads, how=cfg.aggregation_type, topology=cfg.topology,
                local_weight=cfg.local_weight, world_size=self.n_workers))

        mx = {k: torch.stack(v)[None].cpu().numpy()
              for k, v in per_epoch.items()}
        mx["avg_acc"] = mx["train_acc"]       # mean over the one worker
        for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
            mx[f"global_{k}"] = mx[k].mean(axis=1)
        mx["agg_grad_norm"] = agg_norm.cpu().numpy()[None]
        mx["train_ms"] = train_s * 1e3
        mx["train_steps"] = train_steps
        mx["val_steps"] = val_steps
        return state, mx
