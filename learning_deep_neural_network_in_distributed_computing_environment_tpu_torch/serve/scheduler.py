"""Continuous-batching scheduler: the serving control loop (port of the JAX
package's ``serve/scheduler.py``, with its speculative tick).

Every loop iteration is one decode step of the whole engine batch:

1. **admit** — arrived requests claim free decode slots in order; each
   gets its WHOLE page span (``ceil((prompt + max_new) / page_size)``
   pages) up front.  With the prefix cache on, the prompt's page-aligned
   prefix is hashed first and every cached page maps straight into the
   new sequence's page table by reference (claimed, never copied) — only
   the cold tail is prefilled.  When the pool or the slots are exhausted
   the head request waits (``admission_blocked`` counts the
   backpressure) — a running decode can never die from page exhaustion.
2. **chunked prefill** (``engine.prefill_chunk > 0``) — every slot still
   filling its prompt advances ONE ``[1, C]`` chunk, so a long cold
   prompt costs the running decode streams at most one chunk of latency
   per step instead of its whole prefill wall.  The final chunk's sample
   is the slot's first token, drawn at the same absolute position the
   monolithic prefill samples at.  With chunking off, admission prefills
   the whole prompt inline exactly as before.
3. **decode** — ONE call of the fixed-shape decode program advances every
   decoding slot a token; free and still-prefilling slots ride along
   masked (their writes go to the trash page).
   With a draft paired to the engine, step 3 is a **speculation tick**
   (``_spec_step``) instead: the draft's decode runs k times, the
   target's verify scores the burst once, and each slot commits its
   accepted tokens plus the target's bonus token; admission takes the
   span in both pools at once (``paired_admit``) and the draft prefills
   (or chunks) the same prompt span.  Greedy output equals the plain
   run's: speculation changes when tokens appear, never which.
4. **evict** — slots whose new token is ``eos_id`` or whose budget is
   spent release their page references (an unshared page returns to the
   allocator head — the recycle the tests assert; a shared or cached
   page survives) and free the slot for the next admission.

Sampling keys derive from (seed, request id, position) only — slot and
batch-composition independent — so a request decodes the identical token
stream whether it ran alone or packed with others (the
batched-vs-single gate), and a prefix-cache hit decodes the identical
stream as its cold-cache twin.

Latency telemetry splits per request into TTFT (admission → first
token — covers prefill, however it is scheduled) and per-DECODE-token
gaps; both distributions zero-fill to 0.0 on empty runs, like
``sync_ms``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from .cache import page_prefix_keys, paired_admit
from .engine import ServeEngine


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrival_s: float = 0.0        # offset from scheduler start (0 = now)


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: list                  # generated ids (incl. the eos, if hit)
    reason: str                   # "eos" | "length" | "timeout"
    ttft_s: Optional[float]       # admission -> first token (None: none)
    decode_latencies_s: list      # inter-token gaps, first token excluded


@dataclasses.dataclass
class _Slot:
    rid: int
    pages: list
    row: np.ndarray               # page-table row [pages_per_seq]
    prompt: np.ndarray            # the full prompt (chunked refill source)
    plen: int
    filled: int                   # prompt tokens already in the cache
    length: int                   # decode-visible tokens in cache
    temperature: float
    max_new: int
    generated: list
    decode_lat: list
    keys: list                    # content keys of the full prompt pages
    registered: int               # prefix pages already published
    t_last: float
    t_admit: float = 0.0          # wall clock at admission (timeout base)
    ttft_s: Optional[float] = None
    draft_pages: Optional[list] = None   # the draft pool's twin span
    draft_row: Optional[np.ndarray] = None

    @property
    def prefilling(self) -> bool:
        return self.filled < self.plen


class ContinuousBatchingScheduler:
    """Drives one ``ServeEngine``.  ``max_active`` caps concurrently
    decoding slots below ``engine.max_batch`` — ``max_active=1`` is the
    naive sequential-request baseline the bench A/Bs against."""

    def __init__(self, engine: ServeEngine, *, eos_id: int = -1,
                 max_active: Optional[int] = None,
                 request_timeout: float = 0.0):
        self.engine = engine
        self.eos_id = int(eos_id)
        self.max_active = min(int(max_active or engine.max_batch),
                              engine.max_batch)
        # per-request wall-clock budget: an admitted sequence still
        # decoding past this many seconds is evicted
        # (reason "timeout") so a stuck request frees its slot and pages
        # instead of pinning them forever; 0 disables
        self.request_timeout = float(request_timeout)
        if self.request_timeout < 0:
            raise ValueError(
                f"request_timeout must be >= 0, got {request_timeout}")
        self.stats = {"admitted": 0, "evicted": 0, "admission_blocked": 0,
                      "decode_steps": 0, "tokens_generated": 0,
                      "timed_out": 0, "prefill_chunks": 0,
                      "prefix_hit_pages": 0, "prefix_prompt_pages": 0,
                      "prefill_tokens_saved": 0,
                      # speculation (0 without a draft): drafted = k per
                      # active slot per tick; accepted = committed draft
                      # tokens (the bonus is the target's); emitted = all
                      # tokens committed by ticks
                      "draft_steps": 0, "verify_steps": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "spec_emitted": 0}
        self._occupancy: list[int] = []

    # -- request validation (fail at submit, not mid-run) ---------------
    def _validate(self, r: Request) -> None:
        eng = self.engine
        plen = len(r.prompt)
        if plen < 1 or r.max_new_tokens < 1:
            raise ValueError(f"request {r.rid}: prompt and max_new_tokens "
                             "must be non-empty/positive")
        ids = np.asarray(r.prompt)
        if ids.min() < 0 or ids.max() >= eng.spec.vocab:
            # jnp gather would silently clamp/wrap out-of-range ids into
            # a confidently-wrong decode — fail at submit instead
            raise ValueError(
                f"request {r.rid}: prompt ids must lie in "
                f"[0, {eng.spec.vocab}); got range "
                f"[{int(ids.min())}, {int(ids.max())}]")
        if not eng.prefill_chunk and plen > eng.prompt_buckets[-1]:
            # the chunk program covers any length; the bucket bound only
            # applies to the monolithic per-bucket prefill (a prefix-hit
            # tail always fits a bucket the full prompt fits)
            raise ValueError(
                f"request {r.rid}: prompt length {plen} exceeds the "
                f"largest prefill bucket {eng.prompt_buckets[-1]}")
        if eng.draft is not None and r.temperature > 0.0:
            raise ValueError(
                f"request {r.rid}: temperature {r.temperature} under "
                "speculative decoding — acceptance is greedy argmax "
                "equality against the verify logits; temperature sampling "
                "needs the stochastic rejection-sampling rule, which is "
                "not implemented.  Serve it at temperature 0 or without "
                "--serve_draft_ckpt")
        # a speculating sequence's verify writes up to position C + k, so
        # its span (in both pools) covers k more tokens
        total = plen + r.max_new_tokens + eng.spec_tokens
        if total > eng.max_seq:
            raise ValueError(
                f"request {r.rid}: prompt + max_new"
                + (f" + spec_tokens ({total})" if eng.spec_tokens
                   else f" ({total})")
                + f" exceeds max_seq {eng.max_seq}")
        if eng.pages_for(total) > eng.allocator.max_pages - 1:
            raise ValueError(
                f"request {r.rid}: needs {eng.pages_for(total)} pages but "
                f"the pool holds {eng.allocator.max_pages - 1} — raise "
                "--serve_max_pages or lower max_new_tokens")

    # -- one admission attempt ------------------------------------------
    def _admit(self, r: Request, slots: list, t0: float) -> bool:
        eng = self.engine
        free_slot = next((i for i, s in enumerate(slots) if s is None),
                         None)
        if (free_slot is None
                or sum(s is not None for s in slots) >= self.max_active):
            return False
        plen = len(r.prompt)
        dra = eng.draft
        keys: list = []
        hits: list = []
        d_hits: list = []
        if eng.prefix_cache:
            keys = page_prefix_keys(r.prompt, eng.page_size)
            # never reuse past (plen - 1): the tail prefill must keep at
            # least one real token so it produces the first-token logits
            lim = keys[:(plen - 1) // eng.page_size]
            hits = eng.allocator.lookup(lim)
            if dra is not None:
                # both pools prefill from one filled offset: the usable
                # hit run is the shorter of the two pools'
                d_hits = dra.allocator.lookup(lim)
                nj = min(len(hits), len(d_hits))
                hits, d_hits = hits[:nj], d_hits[:nj]
        count = eng.pages_for(plen + r.max_new_tokens + eng.spec_tokens)
        d_pages: Optional[list] = None
        if dra is None:
            # claim the hits BEFORE the fresh alloc: alloc may evict
            # refcount-0 cached pages to cover a shortfall, and a claimed
            # page can never be on that LRU
            for p in hits:
                eng.allocator.claim(p)
            fresh = eng.allocator.alloc(count - len(hits))
            if fresh is None:
                if hits:
                    eng.allocator.free(hits)
                self.stats["admission_blocked"] += 1
                return False
            pages = hits + fresh
        else:
            # speculative pair: the whole span in BOTH pools or nothing
            got = paired_admit(eng.allocator, dra.allocator, hits, d_hits,
                               count)
            if got is None:
                self.stats["admission_blocked"] += 1
                return False
            pages, d_pages = got
        row = eng.table_row(pages)
        hit_tok = len(hits) * eng.page_size
        if eng.prefix_cache:
            self.stats["prefix_hit_pages"] += len(hits)
            self.stats["prefix_prompt_pages"] += eng.pages_for(plen)
            self.stats["prefill_tokens_saved"] += hit_tok
        t_adm = time.perf_counter()
        slot = _Slot(rid=r.rid, pages=pages, row=row,
                     prompt=np.asarray(r.prompt, np.int32), plen=plen,
                     filled=hit_tok, length=plen,
                     temperature=r.temperature, max_new=r.max_new_tokens,
                     generated=[], decode_lat=[], keys=keys,
                     registered=len(hits), t_last=t_adm, t_admit=t_adm,
                     draft_pages=d_pages,
                     draft_row=(eng.table_row(d_pages)
                                if d_pages is not None else None))
        if not eng.prefill_chunk:
            first, _ = eng.prefill(slot.prompt[hit_tok:], row,
                                   r.temperature, r.rid, offset=hit_tok)
            if dra is not None:
                # the draft prefills the same span so both caches sit at
                # one filled offset; its token is dropped (the pending
                # token is always the target's)
                dra.prefill(slot.prompt[hit_tok:], slot.draft_row, 0.0,
                            r.rid, offset=hit_tok)
            now = time.perf_counter()
            slot.generated = [first]
            slot.filled = plen
            slot.ttft_s = now - t_adm
            slot.t_last = now
            self.stats["tokens_generated"] += 1
            self._register_prefix(slot)
        slots[free_slot] = slot
        self.stats["admitted"] += 1
        self._occupancy.append(eng.allocator.in_use)
        return True

    def _register_prefix(self, slot: _Slot) -> None:
        """Publish the content keys of every FULL prompt page the slot
        has finished writing (hit pages arrive pre-registered); the
        partial last page and all decode pages stay private — this
        sequence keeps writing into them."""
        if not self.engine.prefix_cache or not slot.keys:
            return
        nfull = min(slot.filled // self.engine.page_size, len(slot.keys))
        for i in range(slot.registered, nfull):
            self.engine.allocator.register(slot.keys[i], slot.pages[i])
            if slot.draft_pages is not None:
                # content keys are pool-agnostic: the draft's twin page
                # publishes under the same key, so both pools hit together
                self.engine.draft.allocator.register(slot.keys[i],
                                                     slot.draft_pages[i])
        slot.registered = max(slot.registered, nfull)

    def _advance_chunk(self, slot: _Slot) -> None:
        """One ``[1, C]`` chunk of this slot's prompt into the cache; the
        final chunk's sample becomes the slot's first generated token."""
        eng = self.engine
        start = slot.filled
        end = min(start + eng.prefill_chunk, slot.plen)
        tok, _ = eng.prefill_chunk_step(slot.prompt[start:end], start,
                                        slot.row, slot.temperature,
                                        slot.rid)
        if eng.draft is not None:
            # the same chunk through the draft pool (token dropped): the
            # two caches advance through the prompt in lockstep
            eng.draft.prefill_chunk_step(slot.prompt[start:end], start,
                                         slot.draft_row, 0.0, slot.rid)
        slot.filled = end
        self.stats["prefill_chunks"] += 1
        self._register_prefix(slot)
        if end >= slot.plen:
            now = time.perf_counter()
            slot.generated = [tok]
            slot.ttft_s = now - slot.t_admit
            slot.t_last = now
            self.stats["tokens_generated"] += 1

    def _spec_step(self, slots: list, active_idx: list, done: dict
                   ) -> None:
        """One speculation tick for every decoding slot (JAX
        ``scheduler.py:319-390``).

        At entry both pools hold positions ``0 .. C-1`` (C =
        ``slot.length``) and the pending token ``g = generated[-1]``
        belongs at C.  Draft step j feeds ``y_{j-1}`` at ``C+j-1`` (``y_0
        = g``), writing its keys and proposing ``d_j``; after k steps the
        draft pool holds ``0 .. C+k-1``.  The verify scores ``[g, d_1 ..
        d_k]`` at C, writes the target's ``C .. C+k`` and returns the
        accepted prefix (capped at k-1) plus the bonus: committing
        ``acc+1`` tokens leaves both pools filled exactly to the new C,
        and the rejected tail lies at positions the next burst overwrites
        before the causal mask can read them (rollback is page-table
        arithmetic only)."""
        eng = self.engine
        dra = eng.draft
        k = eng.spec_tokens
        b = eng.max_batch
        tokens = np.zeros(b, np.int32)
        lengths = np.zeros(b, np.int32)
        table = np.zeros((b, eng.pages_per_seq), np.int32)
        d_table = np.zeros((b, eng.pages_per_seq), np.int32)
        temps = np.zeros(b, np.float32)     # greedy: speculation is temp 0
        rids = np.zeros(b, np.int32)
        active = np.zeros(b, bool)
        for i in active_idx:
            s = slots[i]
            tokens[i] = s.generated[-1]
            lengths[i] = s.length
            table[i] = s.row
            d_table[i] = s.draft_row
            rids[i] = s.rid
            active[i] = True
        burst = np.empty((b, k + 1), np.int32)
        burst[:, 0] = tokens
        y = tokens
        for j in range(k):
            y, _ = dra.decode(y, lengths + j, d_table, temps, rids, active)
            burst[:, j + 1] = y
        emitted, acc = eng.verify(burst, lengths, table, active)
        self.stats["decode_steps"] += 1     # one target dispatch per tick
        self.stats["verify_steps"] += 1
        self.stats["draft_steps"] += k
        t_now = time.perf_counter()
        for i in active_idx:
            s = slots[i]
            e = int(acc[i]) + 1
            self.stats["spec_drafted"] += k
            self.stats["spec_accepted"] += int(acc[i])
            # commit one token at a time, so an eos or the budget cuts the
            # burst exactly where the plain run stops; the tick's gap is
            # split evenly over its tokens
            gap = (t_now - s.t_last) / e
            reason = None
            for tok in emitted[i, :e]:
                s.generated.append(int(tok))
                s.decode_lat.append(gap)
                self.stats["tokens_generated"] += 1
                self.stats["spec_emitted"] += 1
                reason = self._stop_reason(s)
                if reason:
                    break
            s.t_last = t_now
            if reason:
                done[s.rid] = self._finish(s, reason)
                slots[i] = None
            else:
                s.length += e

    def _finish(self, slot: _Slot, reason: str) -> Completion:
        self.engine.allocator.free(slot.pages)
        if slot.draft_pages is not None:
            self.engine.draft.allocator.free(slot.draft_pages)
        self.stats["evicted"] += 1
        return Completion(rid=slot.rid, prompt_len=slot.plen,
                          tokens=slot.generated, reason=reason,
                          ttft_s=slot.ttft_s,
                          decode_latencies_s=slot.decode_lat)

    def _stop_reason(self, slot: _Slot) -> Optional[str]:
        if not slot.generated:
            return None
        if self.eos_id >= 0 and slot.generated[-1] == self.eos_id:
            return "eos"
        if len(slot.generated) >= slot.max_new:
            return "length"
        return None

    # -- the loop --------------------------------------------------------
    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` to completion; returns the telemetry dict
        (the ``results["serve"]`` payload) with ``completions`` attached
        in request order."""
        eng = self.engine
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            # rids key slot lookup, eviction, and the completions dict —
            # a duplicate would silently cross-wire two requests
            raise ValueError(
                f"request ids must be unique, got duplicates in {rids}")
        for r in requests:
            self._validate(r)
        queue = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        slots: list[Optional[_Slot]] = [None] * eng.max_batch
        done: dict[int, Completion] = {}
        t0 = time.perf_counter()
        while queue or any(s is not None for s in slots):
            now = time.perf_counter() - t0
            if self.request_timeout > 0:
                # evict sequences over their wall-clock budget BEFORE this
                # iteration's admissions and decode dispatch: the freed
                # slot + pages are immediately available to the queue
                # behind them, so one stuck request cannot starve it
                t_now = time.perf_counter()
                for i, s in enumerate(slots):
                    if (s is not None
                            and t_now - s.t_admit > self.request_timeout):
                        self.stats["timed_out"] += 1
                        done[s.rid] = self._finish(s, "timeout")
                        slots[i] = None
            # admit every due request a slot + pages can take, in order
            while queue and queue[0].arrival_s <= now:
                if not self._admit(queue[0], slots, t0):
                    break
                r = queue.popleft()
                slot = next(s for s in slots if s is not None
                            and s.rid == r.rid)
                reason = self._stop_reason(slot)
                if reason:   # eos on the very first token / max_new == 1
                    done[slot.rid] = self._finish(slot, reason)
                    slots[slots.index(slot)] = None
            # chunked prefill: every filling slot advances one chunk per
            # iteration, interleaved with the decode step below
            for i, s in enumerate(slots):
                if s is None or not s.prefilling:
                    continue
                self._advance_chunk(s)
                reason = self._stop_reason(s)
                if reason:   # first token was eos / max_new == 1
                    done[s.rid] = self._finish(s, reason)
                    slots[i] = None
            active_idx = [i for i, s in enumerate(slots)
                          if s is not None and not s.prefilling]
            if not active_idx:
                if queue and not any(s is not None for s in slots):
                    # waiting on a future arrival (pages/slots cannot be
                    # the blocker with nothing active — the pool is empty)
                    time.sleep(max(0.0, min(
                        0.001, queue[0].arrival_s - now)))
                continue
            if eng.draft is not None:
                self._spec_step(slots, active_idx, done)
                self._occupancy.append(eng.allocator.in_use)
                continue
            b = eng.max_batch
            tokens = np.zeros(b, np.int32)
            lengths = np.zeros(b, np.int32)
            table = np.zeros((b, eng.pages_per_seq), np.int32)
            temps = np.zeros(b, np.float32)
            rids = np.zeros(b, np.int32)
            active = np.zeros(b, bool)
            for i in active_idx:
                s = slots[i]
                tokens[i] = s.generated[-1]
                lengths[i] = s.length
                table[i] = s.row
                temps[i] = s.temperature
                rids[i] = s.rid
                active[i] = True
            nxt, _logits = eng.decode(tokens, lengths, table, temps,
                                      rids, active)
            self.stats["decode_steps"] += 1
            t_now = time.perf_counter()
            for i in active_idx:
                s = slots[i]
                s.length += 1
                s.generated.append(int(nxt[i]))
                s.decode_lat.append(t_now - s.t_last)
                s.t_last = t_now
                self.stats["tokens_generated"] += 1
                reason = self._stop_reason(s)
                if reason:
                    done[s.rid] = self._finish(s, reason)
                    slots[i] = None
            self._occupancy.append(eng.allocator.in_use)
        wall = time.perf_counter() - t0
        return self._telemetry(requests, done, wall)

    # -- telemetry -------------------------------------------------------
    def _telemetry(self, requests, done: dict, wall: float) -> dict:
        eng = self.engine
        dec_ms = sorted(1e3 * x for c in done.values()
                        for x in c.decode_latencies_s)
        ttft_ms = sorted(1e3 * c.ttft_s for c in done.values()
                         if c.ttft_s is not None)

        def dist(samples_ms):
            # zero-filled schema on empty runs (the sync_ms convention):
            # consumers always see the same keys with float values
            def pct(p):
                if not samples_ms:
                    return 0.0
                return round(samples_ms[min(len(samples_ms) - 1,
                                            int(p / 100.0
                                                * len(samples_ms)))], 3)
            return {"p50": pct(50), "p99": pct(99),
                    "mean": (round(float(np.mean(samples_ms)), 3)
                             if samples_ms else 0.0)}

        occ = self._occupancy or [0]
        page_bytes = eng.page_bytes()
        st = self.stats
        hit_pages = st["prefix_hit_pages"]
        prompt_pages = st["prefix_prompt_pages"]
        out = {
            "enabled": True,
            "requests": len(requests),
            "admitted": self.stats["admitted"],
            "evicted": self.stats["evicted"],
            "admission_blocked": self.stats["admission_blocked"],
            "timed_out": self.stats["timed_out"],
            "decode_steps": self.stats["decode_steps"],
            "tokens_generated": self.stats["tokens_generated"],
            "wall_s": round(wall, 4),
            "tokens_per_s": round(
                self.stats["tokens_generated"] / max(wall, 1e-9), 2),
            "prefill_buckets": sorted(eng.compiled_buckets),
            "prefill_chunks": self.stats["prefill_chunks"],
            "max_batch": eng.max_batch,
            # per-DECODE-token gaps only; the first token's wall (which
            # includes prefill) lives in ttft_ms — inline prefill no
            # longer pollutes the per-token percentiles
            "latency_ms": dist(dec_ms),
            "ttft_ms": dist(ttft_ms),
            "page_reuse_ratio": (round(hit_pages / prompt_pages, 4)
                                 if prompt_pages else 0.0),
            "prefill_tokens_saved": self.stats["prefill_tokens_saved"],
            # speculation, zero-filled without a draft (the JAX keys):
            # acceptance_rate = committed draft tokens over drafted ones;
            # target_steps_per_token = verify ticks a sequence sat through
            # per token it emitted (spec_drafted / k sums active slots over
            # ticks, so it does not depend on the batch width): 1.0 means
            # speculation bought nothing, 1/k is the floor
            "spec": {
                "acceptance_rate": (
                    round(st["spec_accepted"] / st["spec_drafted"], 4)
                    if st["spec_drafted"] else 0.0),
                "draft_steps": st["draft_steps"],
                "verify_steps": st["verify_steps"],
                "target_steps_per_token": (
                    round(st["spec_drafted"] / eng.spec_tokens
                          / st["spec_emitted"], 4)
                    if st["spec_emitted"] else 0.0)},
            # byte-exact page accounting: in_use sampled after every
            # admission/step x the per-page pin across both pools
            "pages": {"page_size": eng.page_size,
                      "max_pages": eng.allocator.max_pages,
                      "page_bytes": page_bytes,
                      "peak_in_use": max(occ),
                      "mean_in_use": round(float(np.mean(occ)), 2),
                      "peak_bytes": max(occ) * page_bytes,
                      "cached_pages": eng.allocator.cached_pages,
                      "cache_evictions": eng.allocator.cache_evictions,
                      "leaked": eng.allocator.in_use,
                      # the draft pool (0 without a draft): joint admission
                      # mirrors the target's in_use, and leaked ends 0
                      "draft_peak_in_use": (
                          eng.draft.allocator.peak_in_use
                          if eng.draft is not None else 0),
                      "draft_leaked": (eng.draft.allocator.in_use
                                       if eng.draft is not None else 0)},
        }
        out["completions"] = [done[r.rid] for r in requests
                              if r.rid in done]
        return out
