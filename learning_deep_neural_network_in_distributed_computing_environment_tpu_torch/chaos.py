"""Chaos-injection harness: scripted + seeded-random fault events for the
N-worker driver (the port's copy of the JAX package's ``chaos.py``; the
port imports nothing of that package).  In the port every worker is a
process of the gloo group, and the faults stay simulated exactly as in
JAX: they perturb the host-side wall vector, the membership roster and
the poison flags, never a process itself.

The paper's scenario is heterogeneous, UNRELIABLE workers; at production
scale that means membership churn (preemption, joins) and pathological
timing (slowdowns, stalls), none of which a clean CI host ever produces
on its own.  This module manufactures those faults deterministically so
the elastic round loop (``elastic.py`` + ``driver.train_global``) can be
exercised and gated in ordinary pytest runs:

- ``kill@R:wI``      — logical worker I departs at the boundary entering
                       round R (its state row is dropped, its shard
                       redistributed by the membership re-partition);
- ``join@R``         — a new worker joins at the boundary entering round
                       R (clones the first survivor's state, fresh RNG
                       stream, zero EF residual — ``elastic.reshard``);
- ``slow@R:wIxF``    — from round R on, worker I's measured round wall
                       is multiplied by F (feeds the straggler EMA, so
                       step caps and shard shares respond exactly as a
                       genuinely slow worker's would);
- ``stall@R:wI+S``   — worker I's wall gains S seconds for the rounds
                       [R, R + K) (``*K`` suffix, default 1).  A stall
                       that pushes the wall past ``time_limit`` plus the
                       retry/backoff-extended grace makes the straggler
                       policy declare the worker DEPARTED (an implicit
                       kill at the next boundary);
- ``crash@R:wI``     — worker I vanishes MID-ROUND, non-cooperatively:
                       its measured wall for round R is
                       non-finite — the simulated form of a missed
                       round-fence deadline — and the straggler policy
                       returns the distinct verdict CRASHED (no retry
                       ladder: a missed fence means the worker is gone,
                       not slow).  The driver voids the round, rolls
                       back to the last completed round boundary in
                       memory, reconstructs the lost resident shard
                       spans from the worker's ring buddy (or the
                       newest committed checkpoint on a double fault),
                       and re-runs the round on the surviving quorum;
- ``nan@R:wI``       — worker I's round-R sync contribution is poisoned
                       with NaN: the sync engines' integrity
                       screen quarantines the contribution for the
                       round (the blend renormalizes over the finite
                       survivors) and the driver escalates repeated
                       strikes to a departure after ``--chaos_retries``.

Events are pure data keyed by ABSOLUTE round index, so a checkpoint
resume (or a fresh run started from a membership snapshot) replays the
identical fault sequence — the property the crash-during-reshard test
and the loss-trajectory bitwise gate rely on.  Wall perturbations only
ever touch the HOST-side measured-wall vector (the same surface
``simulated_round_durations`` overrides): device numerics are untouched,
which is what keeps chaos runs bit-deterministic.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

KINDS = ("kill", "join", "slow", "stall", "crash", "nan")

# kinds `--chaos random` draws from by default: the cooperative /
# timing faults.  The unplanned-failure kinds (crash/nan) are opt-in via
# --chaos_kinds — a random schedule must never silently start exercising
# the rollback-recovery machinery under a config that predates it.
DEFAULT_RANDOM_KINDS = ("kill", "join", "slow", "stall")

# kind@round[:wID][xFACTOR][+SECONDS][*ROUNDS]
_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<round>\d+)"
    r"(?::w(?P<worker>\d+))?"
    r"(?:x(?P<factor>[0-9.]+))?"
    r"(?:\+(?P<seconds>[0-9.]+))?"
    r"(?:\*(?P<rounds>\d+))?$")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault.  ``round`` is the 0-based global epoch the
    event takes effect at: membership events (kill/join/depart) apply at
    the BOUNDARY entering that round; wall events (slow/stall) perturb
    that round's measured wall.  ``worker`` is a LOGICAL worker id
    (stable across membership changes: the initial workers are 0..N-1,
    joiners take the next free ids) — None means "driver picks" (joins
    never need one; random kills resolve via ``worker_frac``)."""

    kind: str
    round: int
    worker: int | None = None
    factor: float = 1.0       # slow: wall multiplier
    seconds: float = 0.0      # stall: extra wall seconds
    rounds: int = 1           # stall: consecutive rounds affected
    # random-mode kill target as a fraction of the CURRENT membership
    # list — resolved at apply time so the draw is independent of how
    # membership evolved (deterministic under resume replay)
    worker_frac: float | None = None

    def describe(self) -> dict:
        """JSON-able form for ``results["elastic"]["events"]``."""
        out = {"round": int(self.round), "kind": self.kind}
        if self.worker is not None:
            out["worker"] = int(self.worker)
        if self.kind == "slow":
            out["factor"] = float(self.factor)
        if self.kind == "stall":
            out["seconds"] = float(self.seconds)
            out["rounds"] = int(self.rounds)
        return out


def parse_chaos_spec(spec: str) -> list[ChaosEvent]:
    """Parse a ``--chaos`` scripted spec: comma/semicolon-separated
    ``kind@round[:wID][xF][+S][*K]`` entries (see the module docstring
    for the grammar and per-kind semantics).  Raises ``ValueError`` with
    the offending entry on any malformed piece — config validation calls
    this eagerly so a bad spec fails at argparse time, not mid-run."""
    events: list[ChaosEvent] = []
    for part in re.split(r"[,;]", spec):
        part = part.strip()
        if not part:
            continue
        m = _EVENT_RE.match(part)
        if not m:
            raise ValueError(
                f"malformed chaos event {part!r}: expected "
                "kind@round[:wID][xFACTOR][+SECONDS][*ROUNDS] with kind "
                f"in {KINDS}")
        kind = m.group("kind")
        if kind not in KINDS:
            raise ValueError(
                f"unknown chaos event kind {kind!r} in {part!r}: expected "
                f"one of {KINDS}")
        rnd = int(m.group("round"))
        if rnd < 1:
            raise ValueError(
                f"chaos event {part!r}: round must be >= 1 (round 0's "
                "membership is --num_workers; membership and wall faults "
                "are round-boundary events)")
        worker = m.group("worker")
        if kind in ("kill", "slow", "stall", "crash", "nan") \
                and worker is None:
            raise ValueError(
                f"chaos event {part!r}: {kind} needs a :w<ID> target")
        # reject inapplicable suffixes too — 'join@3:w5' (joiners take
        # the next free id, never a requested one) or 'kill@2:w1+30'
        # would otherwise parse cleanly and silently do something other
        # than what was written
        if kind == "join" and worker is not None:
            raise ValueError(
                f"chaos event {part!r}: join takes no :w<ID> — joiners "
                "are assigned the next free logical id")
        if kind != "slow" and m.group("factor") is not None:
            raise ValueError(
                f"chaos event {part!r}: x<factor> applies to slow only")
        if kind != "stall" and (m.group("seconds") is not None
                                or m.group("rounds") is not None):
            raise ValueError(
                f"chaos event {part!r}: +<seconds>/*<rounds> apply to "
                "stall only")
        factor = float(m.group("factor") or 1.0)
        seconds = float(m.group("seconds") or 0.0)
        if kind == "slow" and (m.group("factor") is None or factor <= 0):
            raise ValueError(
                f"chaos event {part!r}: slow needs a positive x<factor>")
        if kind == "stall" and seconds <= 0:
            raise ValueError(
                f"chaos event {part!r}: stall needs a positive +<seconds>")
        events.append(ChaosEvent(
            kind=kind, round=rnd,
            worker=int(worker) if worker is not None else None,
            factor=factor, seconds=seconds,
            rounds=int(m.group("rounds") or 1)))
    return sorted(events, key=lambda e: (e.round, e.kind))


def random_events(seed: int, count: int, epochs_global: int,
                  kinds: tuple[str, ...] = DEFAULT_RANDOM_KINDS
                  ) -> list[ChaosEvent]:
    """``--chaos random``: ``count`` seeded-random events drawn up front
    (never lazily — the whole schedule must be reconstructable from the
    seed alone for checkpoint-resume replay).  Kills carry a
    ``worker_frac`` resolved against the membership list at apply time;
    slow/stall (and the crash/nan kinds, when selected via
    ``--chaos_kinds``) target fractions pinned to round-0 logical ids by
    ``pin_wall_targets``."""
    if epochs_global < 2:
        return []
    kinds = tuple(kinds)
    for k in kinds:
        if k not in KINDS:
            raise ValueError(
                f"unknown chaos kind {k!r} in the random-mode selection: "
                f"expected a subset of {KINDS}")
    if not kinds:
        raise ValueError("--chaos random needs at least one event kind")
    rng = np.random.default_rng(seed)
    out: list[ChaosEvent] = []
    for _ in range(max(0, int(count))):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        rnd = int(rng.integers(1, epochs_global))
        frac = float(rng.random())
        out.append(ChaosEvent(
            kind=kind, round=rnd, worker=None, worker_frac=frac,
            factor=float(1.5 + 2.5 * rng.random()),
            seconds=float(10.0 + 90.0 * rng.random()),
            rounds=int(rng.integers(1, 3))))
    return sorted(out, key=lambda e: (e.round, e.kind))


class ChaosSchedule:
    """The driver's view of the fault plan: membership events per round
    boundary + the wall perturbation for each completed round.

    ``slow`` factors accumulate persistently per logical worker from
    their event round on; ``stall`` seconds apply to their event rounds
    only.  All queries key on LOGICAL worker ids so the perturbation
    follows a worker across membership reshuffles."""

    def __init__(self, events: list[ChaosEvent]):
        self.events = list(events)

    @classmethod
    def from_config(cls, cfg) -> "ChaosSchedule | None":
        """Build from the ``--chaos`` group; None when chaos is off."""
        if not cfg.chaos:
            return None
        if cfg.chaos.strip().lower() == "random":
            kinds = (cfg.parse_chaos_kinds()
                     if hasattr(cfg, "parse_chaos_kinds")
                     else DEFAULT_RANDOM_KINDS)
            sched = cls(random_events(cfg.chaos_seed, cfg.chaos_events,
                                      cfg.epochs_global, kinds=kinds))
            if cfg.num_workers:
                sched.pin_wall_targets(range(cfg.num_workers))
            # num_workers == 0 (mesh-derived): the driver pins against
            # the actual round-0 roster once the mesh exists
            return sched
        return cls(parse_chaos_spec(cfg.chaos))

    # random-mode kinds whose target pins at round 0: wall perturbations
    # (slow/stall) and the unplanned faults (crash/nan) — a crash whose
    # target silently migrated after a membership change would diverge
    # the fresh-twin's recovery from the continued run's.  Kills stay
    # frac-resolved at apply time (a kill must land on a live worker).
    PINNED_KINDS = ("slow", "stall", "crash", "nan")

    def pin_wall_targets(self, roster) -> None:
        """Pin random-mode slow/stall/crash/nan targets to concrete
        LOGICAL ids against the round-0 ``roster``, once.  Resolving the
        frac per query would silently migrate a persistent fault to a
        different worker after a membership change (and diverge a
        fresh-twin run, whose starting roster is the post-change one).
        Idempotent: already-pinned events are untouched."""
        roster = list(roster)
        if not roster:
            return
        self.events = [dataclasses.replace(
                           e, worker=self._resolve(e, roster))
                       if e.kind in self.PINNED_KINDS
                       and e.worker is None else e
                       for e in self.events]

    def has_kind(self, kind: str) -> bool:
        """Whether the schedule contains any event of ``kind`` — the
        driver arms the crash-rollback snapshot pool and the NaN
        integrity screen exactly when the schedule can exercise them."""
        return any(e.kind == kind for e in self.events)

    def nan_targets(self, rnd: int, worker_ids: list[int]) -> list[int]:
        """Logical ids whose round-``rnd`` sync contribution is poisoned
        (``nan@R:wI`` — single-round faults, resolved against the
        current membership)."""
        out: list[int] = []
        for e in self.events:
            if e.kind == "nan" and e.round == rnd:
                w = self._resolve(e, worker_ids)
                if w in worker_ids:
                    out.append(int(w))
        return out

    def membership_events(self, rnd: int) -> list[ChaosEvent]:
        """kill/join events taking effect at the boundary entering
        ``rnd``."""
        return [e for e in self.events
                if e.round == rnd and e.kind in ("kill", "join")]

    def perturb_walls(self, rnd: int, worker_ids: list[int],
                      walls: np.ndarray) -> np.ndarray:
        """Apply the slow/stall perturbation for round ``rnd`` to the
        per-worker measured-wall vector (ordered like ``worker_ids``).
        Pure: returns a new array, inputs untouched."""
        out = np.asarray(walls, np.float64).copy()
        for e in self.events:
            if e.kind == "slow" and e.round <= rnd:
                w = self._resolve(e, worker_ids)
                if w in worker_ids:
                    out[worker_ids.index(w)] *= e.factor
            elif (e.kind == "stall"
                  and e.round <= rnd < e.round + e.rounds):
                w = self._resolve(e, worker_ids)
                if w in worker_ids:
                    out[worker_ids.index(w)] += e.seconds
            elif e.kind == "crash" and e.round == rnd:
                # the worker vanished mid-round: it never reports a wall
                # at all — a MISSED round-fence deadline, simulated as a
                # non-finite wall (the straggler policy's distinct
                # "crashed" verdict keys off finiteness, not magnitude).
                # After the rollback recovery the worker is out of the
                # membership, so the re-run of this round (and every
                # later round) resolves no target here.
                w = self._resolve(e, worker_ids)
                if w in worker_ids:
                    out[worker_ids.index(w)] = np.inf
        return out

    @staticmethod
    def _resolve(e: ChaosEvent, worker_ids: list[int]) -> int | None:
        """A random event's fractional target -> a concrete logical id
        from the CURRENT membership (deterministic: the fraction was
        drawn up front, the list is replay-identical)."""
        if e.worker is not None:
            return e.worker
        if e.worker_frac is None or not worker_ids:
            return None
        return worker_ids[min(len(worker_ids) - 1,
                              int(e.worker_frac * len(worker_ids)))]

    def resolve_target(self, e: ChaosEvent, worker_ids: list[int]
                       ) -> int | None:
        return self._resolve(e, worker_ids)


class StragglerPolicy:
    """Retry/timeout/backoff around the round sync.

    A worker whose measured round wall exceeds
    ``time_limit + grace * (1 + backoff * attempts)`` has overrun its
    straggler budget.  The policy tolerates up to ``retries``
    CONSECUTIVE overruns (each one a logged "retry" with a
    backoff-extended deadline — the simulated twin of re-arming a sync
    timeout); one more and the worker is declared DEPARTED, which the
    driver turns into an implicit kill at the next round boundary so its
    shard is redistributed to the surviving quorum.  A worker that
    recovers resets its attempt counter."""

    def __init__(self, time_limit: float, grace: float, retries: int,
                 backoff: float):
        self.time_limit = float(time_limit)
        self.grace = float(grace)
        self.retries = max(0, int(retries))
        self.backoff = max(0.0, float(backoff))
        self._attempts: dict[int, int] = {}

    def deadline(self, worker: int) -> float:
        k = self._attempts.get(worker, 0)
        return self.time_limit + self.grace * (1.0 + self.backoff * k)

    def observe(self, worker_ids: list[int], walls: np.ndarray
                ) -> tuple[list[int], list[int], list[dict]]:
        """Feed one round's per-worker walls; returns
        ``(departed_ids, crashed_ids, retry_records)``.

        A NON-FINITE wall is the distinct CRASHED verdict:
        the worker missed the round fence entirely — it is gone, not
        slow, so no retry/backoff ladder applies and its attempt state
        is dropped.  Finite overruns keep the ladder: tolerated as
        logged retries up to the budget, then DEPARTED.
        ``retry_records`` are the tolerated overruns (for
        ``results["elastic"]["sync_retries"]`` accounting and logs)."""
        departed: list[int] = []
        crashed: list[int] = []
        retries: list[dict] = []
        for wid, wall in zip(worker_ids, np.asarray(walls, np.float64)):
            if not np.isfinite(wall):
                crashed.append(int(wid))
                self._attempts.pop(wid, None)
                continue
            dl = self.deadline(wid)
            if wall > dl:
                k = self._attempts.get(wid, 0) + 1
                self._attempts[wid] = k
                if k > self.retries:
                    departed.append(int(wid))
                    self._attempts.pop(wid, None)
                else:
                    retries.append({"worker": int(wid),
                                    "wall_s": round(float(wall), 3),
                                    "deadline_s": round(dl, 3),
                                    "attempt": k,
                                    "next_deadline_s": round(
                                        self.deadline(wid), 3)})
            else:
                self._attempts.pop(wid, None)
        return departed, crashed, retries

    def forget(self, worker: int) -> None:
        """Drop a departed/killed worker's attempt state."""
        self._attempts.pop(worker, None)

    def reset(self) -> None:
        """Clear ALL attempt state — called at a membership boundary.

        The boundary's snapshot does not carry retry counters, so a
        fresh-twin run starts with every deadline un-extended; clearing
        here keeps the continued run's straggler verdicts identical to
        the twin's by construction (the bitwise-trajectory gate), at the
        cost of re-granting a mid-retry surviving straggler its base
        deadline — a membership change re-arms everyone's budget."""
        self._attempts.clear()
