"""Scenario lab: N local-SGD workers simulated in one process on one device
(port of the JAX package's ``sim.py:70-512``).

The real engine (``train.LocalSGDEngine``) runs one process per worker, so
N workers cost N processes, N CUDA contexts, N launch streams and a sync
staged through the host.  ``SimEngine`` makes N a batch dimension instead:
every worker's parameters, BatchNorm statistics and Adam moments are
stacked on a leading ``[N, ...]`` axis, each local step is ONE
``torch.func.vmap`` of ``grad_and_value`` over ``functional_call`` for all
N workers (a conv becomes one grouped conv, a flash-attention call one
kernel launch over the folded ``[N*B, ...]`` batch), and the once-per-round
sync point is stacked math on the device (``comms.aggregate_sim``): no
device-to-host copy, no collective, no host-to-device copy.

The round keeps the real engine's order (``LocalSGDEngine._run_round``):
``epochs_local`` x (train steps, validation), then the sync.  Per worker:

- the data is the worker's own row of the ``[N, S, B, ...]`` pack; a step
  that is padding for some rows only is run for all and gated per row
  (``train.StackedAdam``; BatchNorm statistics by a row select), so a
  gated row's parameters, moments, count and statistics stay as they were;
- augmentation draws from the worker's own generator, seeded each round
  with ``round_seed(rng_i, lr_epoch_i)`` and drawn only on that row's real
  steps: the real engine's stream, row by row;
- the lr is StepLR of the worker's own clock (times the jitter scale).

The scenario surface follows JAX (``--sim_sample_frac``, ``--sim_dropout``,
``--sim_byzantine``, ``--sim_lr_jitter``, ``--sim_staleness``): the draws
come from ``default_rng(SeedSequence([seed, 0x51AB]))`` in JAX's order, so
a run draws JAX's participants and drop-outs; a sampled-out or dropped row
trains and is then reverted to its entry state (JAX discards its local
phase); a dropped row also skips adoption; the Byzantine rows are the last
``count``.  With every knob at its default none of this machinery runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from . import comms, probe, weights
from .config import Config
from .data.augment import apply_augment, draw
from .models.norm import BatchNorm, running_stats_out
from .train import (
    StackedAdam,
    WindowStaging,
    cross_worker_means,
    masked_token_stats,
    masked_weights,
    round_seed,
    seed_words,
    steplr,
    take_window,
    to_host,
    worker_seed,
)

@dataclasses.dataclass
class SimState:
    """Every simulated worker's state, stacked on a leading [N] axis: the
    parameters and BatchNorm statistics (in the module's order), the
    stacked Adam (moments ``[N, ...]``, ``count`` [N]), each worker's
    StepLR clock and augmentation seed words, and the simulated wire's
    error-feedback residual."""

    params: list                               # [N, ...] per parameter
    buffers: list                              # [N, ...] per statistic
    opt: StackedAdam
    lr_epoch: np.ndarray                       # [N] local epochs done
    rng: np.ndarray                            # [N, 2] uint32 seed words
    sync_residual: Optional[list] = None       # [N, ...] per parameter


def _row_where(mask: torch.Tensor, a: list, b: list) -> list:
    """Row ``i`` of each result is ``a``'s where ``mask[i]``, else
    ``b``'s (``mask`` [N] bool on the tensors' device)."""
    return [torch.where(mask.view(-1, *([1] * (x.ndim - 1))), x, y)
            for x, y in zip(a, b)]


class SimEngine:
    """N local-SGD workers as stacked state on one device (the driver's
    ``--sim_workers N``).  ``model`` supplies the architecture and the one
    init every worker starts from (``init_state`` stacks it); its own
    tensors stay that init until ``rank0_variables`` loads worker 0's
    into it."""

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 device: torch.device):
        n = int(cfg.sim_workers)
        if n < 1:
            raise ValueError(f"SimEngine needs --sim_workers >= 1, got {n}")
        self.model = model
        self.cfg = cfg
        self.device = device
        self.n_workers = n
        self.sync_mode = "sim"
        self.names = [k for k, _ in model.named_parameters()]
        self.buffer_names = [k for k, _ in model.named_buffers()]
        # the new running statistics come out of the vmapped step by
        # module (models/norm.py); their places in the stacked buffers
        index = {k: i for i, k in enumerate(self.buffer_names)}
        self._stat_slots = [
            (mod, index[f"{name}.running_mean"],
             index[f"{name}.running_var"])
            for name, mod in model.named_modules()
            if isinstance(mod, BatchNorm)]
        if len(self._stat_slots) * 2 != len(self.buffer_names):
            raise ValueError(
                "the scenario lab stacks BatchNorm statistics as its only "
                f"buffers; {type(model).__name__} has others: "
                f"{self.buffer_names}")
        # one augmentation stream per worker, seeded every round
        self.generators = [torch.Generator(device=device) for _ in range(n)]
        self._grad_fn = vmap(grad_and_value(self._loss, has_aux=True),
                             randomness="error")
        self._eval_fn = vmap(self._eval_sums, randomness="error")
        # the simulated wire (compressed only under --sim_workers) and its
        # error feedback, armed on weights aggregation as JAX arms it
        self.wire_dtype = cfg.sync_wire_dtype()
        # which tensors share a row's int8 scale: one JAX leaf each (a
        # stacked leaf is every layer's tensor), as JAX's wire scales
        self.wire_groups = (weights.leaf_groups(model)
                            if self.wire_dtype == torch.int8 else None)
        self.sync_ef = (cfg.sync_compression == "ef"
                        and cfg.aggregation_by == "weights"
                        and self.wire_dtype is not None)
        # --- scenario surface (JAX sim.py:132-160) ------------------------
        byz = cfg.parse_sim_byzantine()
        self.byz_kind, self.byz_count, self.byz_scale = (
            byz if byz is not None else (None, 0, 0.0))
        self.scenario_on = (cfg.sim_sample_frac < 1.0
                            or cfg.sim_dropout > 0.0 or self.byz_count > 0)
        self._scen_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0x51AB]))
        if cfg.sim_lr_jitter > 0.0:
            u = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, 0x17E9])).uniform(
                    -1.0, 1.0, n)
            self.lr_scale = (1.0 + cfg.sim_lr_jitter * u).astype(np.float32)
        else:
            self.lr_scale = None
        self.rounds_scenario: list[dict] = []
        # --sim_staleness K: round R's consensus delta is delivered at the
        # entry of round R+K+1, the rest at the end (drain_pending)
        self.sim_staleness = max(0, int(cfg.sim_staleness))
        self._pending: list[list[torch.Tensor]] = []
        self._sync_bytes = comms.sim_wire_bytes(
            [(p.shape, p.dtype) for p in model.parameters()], n,
            topology=cfg.topology, wire_dtype=self.wire_dtype)
        self.last_sync_stats: dict = {}
        # the programs' memory rows (JAX sim.py's "sim_round"): the
        # vmapped train step with its stacked Adam, the vmapped eval step
        # and the stacked blend, each registered at its first use
        self._programs: dict[str, probe.TrackedProgram] = {}
        self._staging: Optional[WindowStaging] = None

    def memory_programs(self) -> dict:
        """Label -> ``probe.TrackedProgram``: ``sim_step``, ``sim_eval``
        and ``sim_blend`` (once they ran)."""
        return dict(self._programs)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self) -> SimState:
        """Every worker at the module's init (N copies of one init, as
        ``torch.func.stack_module_state`` stacks them)."""
        n = self.n_workers
        stack = lambda t: t.detach().unsqueeze(0).repeat(
            n, *([1] * t.ndim)).contiguous()
        params = [stack(p) for p in self.model.parameters()]
        return SimState(
            params=params,
            buffers=[stack(b) for b in self.model.buffers()],
            opt=StackedAdam(params, n),
            lr_epoch=np.zeros(n, np.int64),
            rng=np.stack([seed_words(worker_seed(self.cfg.seed, i))
                          for i in range(n)]),
            sync_residual=([torch.zeros_like(p) for p in params]
                           if self.sync_ef else None))

    @torch.no_grad()
    def rank0_variables(self, state: SimState) -> dict[str, torch.Tensor]:
        """Worker 0's parameters and statistics, loaded into the module
        (for the evaluation and the plots) and returned by ``state_dict``
        name (detached)."""
        for t, s in zip(self.model.parameters(), state.params):
            t.copy_(s[0])
        for t, s in zip(self.model.buffers(), state.buffers):
            t.copy_(s[0])
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def state_resident_bytes(self, state: SimState) -> dict:
        """Per-worker bytes of each state component (JAX
        ``train.py:996-1055``'s keys): each stacked tensor's bytes over N.
        The optimizer row counts the moments and an int32 step count, as
        the JAX ``opt_state`` holds it."""
        n = self.n_workers

        def per_worker(tensors) -> int:
            return sum(t.numel() * t.element_size() for t in tensors) // n

        return {"params": per_worker(state.params),
                "params_gathered_peak": 0,
                "opt_state": per_worker(state.opt.state_tensors()) + 4,
                "ef_residual": per_worker(state.sync_residual or []),
                "ef_residual_outer": 0,
                "round_opt": 0,
                "buddy": 0,
                "batch_stats": per_worker(state.buffers),
                # the StepLR clock counted as JAX's int32 (the port keeps
                # it on the host) and the seed words
                "bookkeeping": 4 + state.rng.nbytes // n}

    # ------------------------------------------------------------------
    # the vmapped step bodies (one worker's view; vmap adds the [N] axis)
    # ------------------------------------------------------------------
    def _call(self, params, buffers, x, **kw):
        return functional_call(
            self.model, (dict(zip(self.names, params)),
                         dict(zip(self.buffer_names, buffers))), (x,), kw)

    def _loss(self, params, buffers, x, y, m, denom, *, aux_div):
        """(loss, (correct, new statistics)) of one worker's train step:
        the masked CE numerator over ``denom``, plus ``moe_aux_weight``
        times the summed MoE load-balance loss over ``aux_div``, as
        ``LocalSGDEngine._loss`` computes it."""
        with running_stats_out() as stats:
            if self.cfg.num_experts > 0:
                logits, aux = self._call(params, buffers, x, with_aux=True)
            else:
                logits, aux = self._call(params, buffers, x), None
        ce, w, correct = masked_token_stats(logits, y, m)
        new = list(buffers)
        for mod, i_mean, i_var in self._stat_slots:
            new[i_mean], new[i_var] = stats[mod]
        loss = (ce * w).sum() / denom
        if aux is not None:
            loss = loss + self.cfg.moe_aux_weight * aux / aux_div
        return loss, (correct, tuple(new))

    def _step(self, state: SimState, x, y, m, denom):
        """Every worker's gradients, loss, correct count and new statistics
        of one train step.  ``--grad_accum K`` (JAX train.py:1625-1674):
        K slices of each worker's batch, each slice's numerator over the
        full step's denominator, the gradients summed in fp32 (BatchNorm
        models take no accumulation, ``driver.build_model_for``)."""
        params, buffers = tuple(state.params), tuple(state.buffers)
        k = self.cfg.grad_accum
        if k == 1:
            grads, (loss, (correct, stats)) = self._grad_fn(
                params, buffers, x, y, m, denom, aux_div=1.0)
            return list(grads), loss.detach(), correct, stats
        total = loss = correct = None
        for xs, ys, ms in zip(*(t.chunk(k, dim=1) for t in (x, y, m))):
            g_k, (loss_k, (correct_k, stats)) = self._grad_fn(
                params, buffers, xs, ys, ms, denom, aux_div=float(k))
            if total is None:
                total, loss, correct = list(g_k), loss_k.detach(), correct_k
            else:
                torch._foreach_add_(total, list(g_k))
                loss, correct = loss + loss_k.detach(), correct + correct_k
        return total, loss, correct, stats

    def _train_step(self, state: SimState, x, y, m, denom, lr, do):
        """One vmapped train step of every worker and its stacked Adam
        update: a row with ``do[i]`` false keeps its parameters, moments
        and statistics.  Returns ``(loss [N], correct [N], grads, gate)``,
        ``gate`` the [N] device mask of the rows that stepped (None: all
        did)."""
        grads, loss, correct, stats = self._step(state, x, y, m, denom)
        state.opt.step(state.params, grads, lr, do)
        if do.all():
            state.buffers = list(stats)
            return loss, correct, grads, None
        gate = torch.from_numpy(do).to(self.device)
        state.buffers = _row_where(gate, list(stats), state.buffers)
        return loss, correct, grads, gate

    @staticmethod
    def _step_state(state: SimState, *_args) -> list:
        """What the train step reads and updates besides its batch."""
        return [*state.params, *state.buffers, *state.opt.mu,
                *state.opt.nu]

    def _eval_sums(self, params, buffers, x, y, m):
        with running_stats_out():           # BatchNorm's vmapped form
            logits = self._call(params, buffers, x)
        ce, w, correct = masked_token_stats(logits, y, m)
        return torch.stack([(ce * w).sum(), correct, w.sum()])

    def _augment(self, x: torch.Tensor, real: np.ndarray) -> torch.Tensor:
        """Each real row of ``x`` [N, B, H, W, C] augmented with draws from
        its worker's generator (``data.augment.draw``, as
        ``augment_batch`` draws them), applied once to the folded batch;
        a row with nothing real takes no draw from its stream (placeholder
        draws augment its padding, which the step's gate discards)."""
        n, b, h, w, c = x.shape
        dev = x.device
        rows = [draw(b, h, w, self.generators[i], dev) if real[i] else None
                for i in range(n)]
        if not real.all():
            hold = dict(flip=torch.zeros(b, dtype=torch.bool, device=dev),
                        oy=torch.zeros(b, dtype=torch.long, device=dev),
                        ox=torch.zeros(b, dtype=torch.long, device=dev),
                        gain=torch.ones(b, device=dev),
                        bias=torch.zeros(b, device=dev),
                        cy=torch.zeros(b, dtype=torch.long, device=dev),
                        cx=torch.zeros(b, dtype=torch.long, device=dev))
            rows = [hold if r is None else r for r in rows]
        draws = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
        return apply_augment(x.reshape(n * b, h, w, c), draws).reshape(
            x.shape)

    # ------------------------------------------------------------------
    # the scenario draws (JAX sim.py:214-242)
    # ------------------------------------------------------------------
    def _draw_scenario(self):
        """One round's seeded draw: ``(active bool [N], dropped bool [N],
        noise key uint32 [2])``; active = sampled and not dropped."""
        cfg = self.cfg
        n = self.n_workers
        part = np.ones(n, np.bool_)
        if cfg.sim_sample_frac < 1.0:
            k = max(1, int(np.ceil(cfg.sim_sample_frac * n)))
            part = np.zeros(n, np.bool_)
            part[self._scen_rng.choice(n, size=k, replace=False)] = True
        dropped = np.zeros(n, np.bool_)
        if cfg.sim_dropout > 0.0:
            dropped = self._scen_rng.random(n) < cfg.sim_dropout
        key = np.zeros(2, np.uint32)
        if self.byz_kind == "noise":
            key = self._scen_rng.integers(0, 2 ** 32, size=2,
                                          dtype=np.uint32)
        return part & ~dropped, dropped, key

    def byzantine_rows(self) -> np.ndarray:
        """The adversaries: the LAST ``byz_count`` worker ids."""
        return np.arange(self.n_workers) >= self.n_workers - self.byz_count

    def _corrupt(self, contrib: list, entry: Optional[list],
                 key: np.ndarray) -> list:
        """The Byzantine rows' payloads: signflip sends the round's update
        negated (weights: ``2 * entry - trained``; gradients: ``-grad``);
        noise adds ``scale * N(0, 1)`` from a generator seeded with the
        round's key, one draw per tensor."""
        if not self.byz_count:
            return contrib
        k = self.byz_count
        if self.byz_kind == "signflip":
            flipped = ([2.0 * e[-k:] - t[-k:] for e, t in zip(entry, contrib)]
                       if entry is not None else [-t[-k:] for t in contrib])
        else:
            g = torch.Generator(device=self.device).manual_seed(
                int(key[0]) | (int(key[1]) << 32))
            flipped = [t[-k:] + self.byz_scale * torch.randn(
                t[-k:].shape, generator=g, device=self.device,
                dtype=torch.float32) for t in contrib]
        return [torch.cat([t[:-k], f]) for t, f in zip(contrib, flipped)]

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stage_pack(self, train_pack, val_pack):
        """The worker-stacked packs ``(x, y, m)`` [N, S, B, ...] staged on
        the device ahead of the round (``LocalSGDEngine.stage_pack``), each
        with every row's step weights [N, S] on the host and the device."""
        for pack in (train_pack, val_pack):
            if np.shape(pack[0])[0] != self.n_workers:
                raise ValueError(
                    f"a pack of {np.shape(pack[0])[0]} worker rows for "
                    f"{self.n_workers} simulated workers")
        if self._staging is None:
            self._staging = WindowStaging(self.device)
        return self._staging(train_pack), self._staging(val_pack)

    def _snapshot(self, state: SimState):
        return dict(params=[p.clone() for p in state.params],
                    buffers=[b.clone() for b in state.buffers],
                    mu=[t.clone() for t in state.opt.mu],
                    nu=[t.clone() for t in state.opt.nu],
                    count=state.opt.count.copy(),
                    lr_epoch=state.lr_epoch.copy())

    @torch.no_grad()
    def _revert(self, state: SimState, entry: dict,
                active: np.ndarray) -> None:
        """Rows not ``active`` back to their round-entry state: JAX
        discards a sampled-out or dropped worker's local phase."""
        keep = torch.from_numpy(active).to(self.device)
        state.params = _row_where(keep, state.params, entry["params"])
        state.buffers = _row_where(keep, state.buffers, entry["buffers"])
        state.opt.mu = _row_where(keep, state.opt.mu, entry["mu"])
        state.opt.nu = _row_where(keep, state.opt.nu, entry["nu"])
        state.opt.count = np.where(active, state.opt.count, entry["count"])
        state.lr_epoch = np.where(active, state.lr_epoch,
                                  entry["lr_epoch"])

    def round(self, state: SimState, train_pack, val_pack):
        """One round of all N workers on worker-stacked packs ``(x, y,
        mask)`` [N, S, B, ...] (numpy, or what ``stage_pack`` staged):
        ``round_start`` then ``finish_metrics``.  Returns ``(state,
        metrics)`` with ``LocalSGDEngine.round``'s [N, ...] metric arrays
        and timings: ``train_steps`` / ``val_steps`` count the vmapped
        steps (one for all workers), ``workers_train_steps`` each worker's
        real steps, and the other ``workers_*`` rows tile the one
        process's wall, train ms, sync ms and peak memory."""
        state, handle = self.round_start(state, train_pack, val_pack)
        return state, self.finish_metrics(handle)

    def round_start(self, state: SimState, train_pack, val_pack):
        """The round up to its metrics, fenced on the card when it returns
        (``LocalSGDEngine.round_start``); returns ``(state, handle)``."""
        cfg = self.cfg
        n = self.n_workers
        dev = self.device
        t_round = time.perf_counter()
        staged = isinstance(train_pack[0], torch.Tensor)
        train, val = ((train_pack, val_pack) if staged
                      else self.stage_pack(train_pack, val_pack))
        stage_ms = (time.perf_counter() - t_round) * 1e3
        x, y, m, wd_train, w_train = take_window(train, dev)
        xv, yv, mv, _wd_val, w_val = take_window(val, dev)
        train_step = probe.track(self._programs, "sim_step",
                                 self._train_step, state=self._step_state)
        eval_step = probe.track(self._programs, "sim_eval", self._eval_fn)
        blend = probe.track(self._programs, "sim_blend", comms.aggregate_sim)
        if self.sim_staleness > 0 and len(self._pending) > self.sim_staleness:
            # the due (oldest) consensus delta, folded into the params
            # this round trains off
            state.params = comms.deliver_stale(state.params,
                                               self._pending.pop(0))
        active = dropped = key = None
        entry = None
        if self.scenario_on:
            active, dropped, key = self._draw_scenario()
            self.rounds_scenario.append(
                {"active": int(active.sum()), "dropped": int(dropped.sum()),
                 "byzantine": int(self.byz_count)})
            entry = self._snapshot(state)
        for i in range(n):
            self.generators[i].manual_seed(
                round_seed(state.rng[i], state.lr_epoch[i]))
        weights_mode = cfg.aggregation_by == "weights"
        per_epoch = {k: [] for k in ("batch_losses", "batch_mask",
                                     "train_loss", "train_acc", "val_loss",
                                     "val_acc")}
        last_grads = None
        train_s, train_steps, val_steps = 0.0, 0, 0
        real_steps = np.zeros(n, np.int64)
        augment = cfg.augment and x.ndim == 6      # [N, S, B, H, W, C]
        steps = w_train.shape[1]
        real = w_train > 0                         # [N, S]
        for e in range(cfg.epochs_local):
            lr = np.array([steplr(cfg.lr, cfg.lr_gamma, cfg.lr_step_size,
                                  int(c)) for c in state.lr_epoch],
                          np.float32)
            if self.lr_scale is not None:
                lr = lr * self.lr_scale
            # JAX carries the last real step's gradients per local epoch
            # from zeros (train.py:1774)
            last_grads = (None if weights_mode
                          else [torch.zeros_like(p) for p in state.params])
            losses = torch.zeros(n, steps, device=dev)
            corrects = torch.zeros(n, steps, device=dev)
            self.model.train()
            self._sync()
            t0 = time.perf_counter()
            for s in range(steps):
                do = real[:, s]
                if not do.any():        # padding for every worker
                    continue
                xb = self._augment(x[:, s], do) if augment else x[:, s]
                yb, mb = y[:, s], m[:, s]
                denom = masked_weights(yb, mb).reshape(n, -1).sum(
                    1).clamp_min(1.0)
                loss, correct, grads, gate = train_step(
                    state, xb, yb, mb, denom, lr, do)
                losses[:, s] = loss
                corrects[:, s] = correct
                if last_grads is not None:
                    last_grads = (grads if gate is None
                                  else _row_where(gate, grads, last_grads))
                train_steps += 1
                real_steps += do
            self._sync()
            train_s += time.perf_counter() - t0
            realf = (wd_train > 0).float()
            totals = wd_train
            per_epoch["batch_losses"].append(losses)
            per_epoch["batch_mask"].append(realf)
            per_epoch["train_loss"].append(
                (losses * realf).sum(1) / realf.sum(1).clamp_min(1))
            per_epoch["train_acc"].append(
                100.0 * corrects.sum(1) / totals.sum(1).clamp_min(1))
            vsum = torch.zeros(n, 3, device=dev)
            self.model.eval()
            with torch.no_grad():
                for s in range(w_val.shape[1]):
                    if (w_val[:, s] > 0).any():
                        vsum += eval_step(tuple(state.params),
                                          tuple(state.buffers), xv[:, s],
                                          yv[:, s], mv[:, s])
                        val_steps += 1
            per_epoch["val_loss"].append(vsum[:, 0]
                                         / vsum[:, 2].clamp_min(1))
            per_epoch["val_acc"].append(100.0 * vsum[:, 1]
                                        / vsum[:, 2].clamp_min(1))
            state.lr_epoch = state.lr_epoch + 1
        self.model.train()
        if entry is not None and not active.all():
            self._revert(state, entry, active)
        self._sync()
        wall_s = time.perf_counter() - t_round

        # --- the sync point: stacked math on the device -----------------
        t0 = time.perf_counter()
        agg_norm = torch.zeros(n, device=dev)
        kw = dict(how=cfg.aggregation_type, topology=cfg.topology,
                  local_weight=cfg.local_weight, wire_dtype=self.wire_dtype,
                  groups=self.wire_groups,
                  ok=(None if active is None
                      else torch.from_numpy(active).to(dev)))
        with torch.no_grad():
            if weights_mode:
                contrib = (state.params if entry is None else self._corrupt(
                    state.params, entry["params"], key))
                blended, residual = blend(
                    contrib, residual=state.sync_residual, **kw)
                if residual is not None:
                    state.sync_residual = residual
                if dropped is not None and dropped.any():
                    # dropped rows miss the consensus too
                    blended = _row_where(torch.from_numpy(dropped).to(dev),
                                         state.params, blended)
                if self.sim_staleness > 0:
                    # the params stay trained; the displacement arrives
                    # K + 1 rounds later
                    self._pending.append(comms.stale_delta(blended,
                                                           state.params))
                else:
                    state.params = blended
            else:
                contrib = (last_grads if entry is None
                           else self._corrupt(last_grads, None, key))
                agg, _ = blend(contrib, **kw)
                # the aggregate is read for its norm only (params stay)
                agg_norm = torch.sqrt(sum(
                    (g.float() ** 2).reshape(n, -1).sum(1) for g in agg))
        self._sync()
        sync_ms = (time.perf_counter() - t0) * 1e3
        self.last_sync_stats = {
            "sync_bytes": self._sync_bytes, "sync_mode": self.sync_mode,
            "sync_ms": sync_ms, "sync_hidden_ms": 0.0,
            "sync_bytes_ici": self._sync_bytes, "sync_bytes_dcn": 0,
            "sync_ms_ici": sync_ms, "sync_ms_dcn": 0.0}

        own = {k: torch.stack(v, 1) for k, v in per_epoch.items()}
        own["agg_grad_norm"] = agg_norm
        own = to_host(own)
        self._sync()                     # the copies are complete
        own = {k: np.array(v.numpy()) for k, v in own.items()}
        peak = probe.max_memory_allocated(dev)
        return state, dict(
            own=own, stage_ms=round(stage_ms, 3), train_ms=train_s * 1e3,
            train_steps=train_steps, val_steps=val_steps,
            workers_wall_s=[wall_s] * n,
            workers_train_ms=[train_s * 1e3] * n,
            workers_train_steps=real_steps.tolist(),
            workers_sync_ms=[sync_ms] * n,
            workers_max_memory_allocated=[peak] * n)

    @staticmethod
    def finish_metrics(handle) -> dict:
        """A round's metrics from its ``round_start`` handle: the host
        arrays with the cross-worker means and the timings."""
        mx = cross_worker_means(dict(handle["own"]))
        mx.update({k: v for k, v in handle.items()
                   if k not in ("own", "stage_ms")})
        return mx

    @torch.no_grad()
    def drain_pending(self, state: SimState) -> SimState:
        """Fold every still-pending consensus delta, oldest first, so the
        final state reflects every simulated sync (``--sim_staleness``)."""
        while self._pending:
            state.params = comms.deliver_stale(state.params,
                                               self._pending.pop(0))
        return state

    def sim_summary(self, round_timings: list[dict],
                    state: SimState) -> dict:
        """``results["sim"]`` with the JAX schema (``sim.py:484-512``):
        the simulated scale, rounds/s over the measured round walls, the
        per-worker state and sync bytes, and the scenario."""
        cfg = self.cfg
        comp = [t.get("compute_ms", 0.0) for t in round_timings]
        total_ms = float(sum(comp))
        out = {
            "workers": self.n_workers,
            "rounds": len(comp),
            "rounds_per_s": (round(1e3 * len(comp) / total_ms, 3)
                             if total_ms > 0 else None),
            "round_ms": [round(c, 3) for c in comp],
            "per_worker_state_bytes": self.state_resident_bytes(state),
            "per_worker_sync_bytes": int(self._sync_bytes),
            "staleness": self.sim_staleness,
            "scenario": {
                "sample_frac": cfg.sim_sample_frac,
                "dropout": cfg.sim_dropout,
                "byzantine": cfg.sim_byzantine or None,
                "lr_jitter": cfg.sim_lr_jitter,
            },
        }
        if self.rounds_scenario:
            out["rounds_scenario"] = list(self.rounds_scenario)
        return out
