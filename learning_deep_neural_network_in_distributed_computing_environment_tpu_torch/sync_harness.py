"""Spawn targets that check the bucketed sync engines and the gloo
collectives in N processes, and the wire quanta their compressed results
are held to.  ``tests/test_torch_sync_engine.py`` and ``chip_smoke.py``
use them; nothing on the training path imports this module."""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from . import comms, mesh


def bucket_map(shapes, n: int, bucket_bytes: int = comms.DEFAULT_BUCKET_BYTES
               ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Where each element of fp32 leaves of ``shapes`` lands in the
    engines' bucket plan at ``n`` workers: per leaf, an array of its
    elements' bucket index and one of the rank that owns the element's
    shard of its bucket (the reduce-scatter's slice)."""
    plan = comms.bucket_plan([(tuple(s), torch.float32) for s in shapes], n,
                             bucket_bytes)
    bucket = [None] * len(shapes)
    owner = [None] * len(shapes)
    for bi, b in enumerate(plan):
        row = b.padded // n
        for i, off, size in b.items:
            bucket[i] = np.full(tuple(shapes[i]), bi)
            owner[i] = ((off + np.arange(size)) // row).reshape(shapes[i])
    return bucket, owner


def wire_quanta(values, wire: str, bucket: list, owner: list | None = None
                ) -> list[np.ndarray]:
    """Per element of ``values`` (per leaf ``[m, ...]``, one row per
    worker that encodes it), one quantum of the wire's encoding of that
    row: bf16 ``2**-7 * |v|`` (no bf16 spacing is larger); int8
    ``max|v| / 127`` over the row's bucket, or over the element's shard of
    the bucket when ``owner`` is given (an encode of the owned shard), as
    ``bucket_map`` lays them out."""
    if wire == "bfloat16":
        return [2.0 ** -7 * np.abs(v).astype(np.float64) for v in values]
    if wire != "int8":
        raise ValueError(f"no quantum for the {wire!r} wire")
    # one key per (bucket) or per (bucket, owned shard)
    keys = (bucket if owner is None
            else [b * (int(max(o.max() for o in owner)) + 1) + o
                  for b, o in zip(bucket, owner)])
    top: dict = {}
    for v, k in zip(values, keys):
        a = np.abs(v).reshape(v.shape[0], -1).astype(np.float64)
        for key in np.unique(k):
            m = a[:, k.reshape(-1) == key].max(1)
            top[key] = np.maximum(top.get(key, 0.0), m)
    out = []
    for v, k in zip(values, keys):
        q = np.empty(v.shape, np.float64).reshape(v.shape[0], -1)
        for key in np.unique(k):
            q[:, k.reshape(-1) == key] = (top[key] / 127.0)[:, None]
        out.append(q.reshape(v.shape))
    return out


def compressed_bounds(leaves, n: int, *, mode: str, how: str, wire: str,
                      bucket_bytes: int = comms.DEFAULT_BUCKET_BYTES,
                      local_weight: float = 0.5, slack: float = 1e-6
                      ) -> tuple[list, list, list]:
    """Per leaf (``[n, ...]`` like the engine's outputs over the
    worker-stacked ``leaves``), how far one compressed sync (zero residual
    in) may land from the JAX package's, from the fp32 blend of the same
    leaves, and how far its EF residual may land from JAX's.

    Stage one encodes each worker's bucket (quantum ``q1``; a decoded
    value sits within half of its sender's).  The sharded engine's stage
    two encodes the owned shard of the mean (``equal``) or of the sum
    (``weighted``, which reaches the output scaled by (1-w)/(n-1)):
    quantum ``q2``.  The two frameworks run the same codec on the same
    stage-one values, so they part by at most one stage-two quantum where
    their fp32 sums round apart; the gossip blends and the stage-one
    residual part by fp32 rounding only.  Under EF the owner of a shard
    carries n x its stage-two rounding.  ``slack`` is the fp32 rounding
    allowed, relative to the largest input (and as an absolute floor)."""
    xs = [np.asarray(x, np.float64) for x in leaves]
    bucket, owner = bucket_map([x.shape[1:] for x in xs], n, bucket_bytes)
    q1 = [np.broadcast_to(q.max(0), q.shape)
          for q in wire_quanta(xs, wire, bucket)]
    tol = [slack * (1.0 + np.abs(x).max(0)) for x in xs]
    if mode == "gossip":
        return tol, [a + t for a, t in zip(q1, tol)], tol
    total = [x.sum(0, keepdims=True) for x in xs]
    if how == "equal":
        q2 = wire_quanta([t / n for t in total], wire, bucket, owner)
    else:
        q2 = [(1.0 - local_weight) / (n - 1) * q
              for q in wire_quanta(total, wire, bucket, owner)]
    ranks = np.arange(n)
    own = [o[None] == ranks.reshape(n, *[1] * o.ndim) for o in owner]
    to_jax = [q + t for q, t in zip(q2, tol)]
    to_fp32 = [a + q + t for a, q, t in zip(q1, q2, tol)]
    res = [t + (n * q * m if how == "equal" else 0.0)
           for q, t, m in zip(q2, tol, own)]
    return to_jax, to_fp32, res


def hier_reference(x, n_slices: int, *, topology: str, how: str,
                   local_weight: float = 0.5) -> np.ndarray:
    """The hierarchical sync's gossip of slice means in float64 on
    worker-stacked ``x`` [S*W, ...] (slice-major): each slice's mean
    blended with its predecessors' over the slices, then for ``weighted``
    the flat self-exclusive form with the blended slice total."""
    x = np.asarray(x, np.float64)
    nw = x.shape[0] // n_slices
    m = x.reshape(n_slices, nw, *x.shape[1:]).mean(1)
    r1 = np.roll(m, 1, axis=0)
    w = local_weight
    if topology == "ring":
        g = (m + r1) / 2 if how == "equal" else w * m + (1 - w) * r1
    else:
        r2 = np.roll(m, 2, axis=0)
        g = ((m + r1 + r2) / 3 if how == "equal"
             else w * m + (1 - w) / 2 * (r1 + r2))
    g = np.repeat(g, nw, axis=0)
    if how == "equal":
        return g
    return w * x + (1 - w) * (nw * g - x) / (nw - 1)


def hier_bounds(leaves, n_slices: int, *, topology: str, how: str,
                wire: str, outer_wire: str,
                bucket_bytes: int = comms.DEFAULT_BUCKET_BYTES,
                local_weight: float = 0.5, slack: float = 1e-6
                ) -> list[np.ndarray]:
    """Per leaf ([S*W, ...] like the outputs over the worker-stacked
    ``leaves``), how far one compressed hierarchical sync (zero residuals
    in) may land from the fp32 one: one quantum of each wire stage per
    element.  The inner stage one encodes each worker's bucket (``q1``,
    the largest sender's; it reaches the slice mean averaged); the outer
    stage encodes each worker's shard of its slice's mean (``qo``, per
    owned shard); the inner stage two encodes the owned shard of the blend
    for the gather (``q2``).  The weighted form reaches the output through
    ``(1-w) W / (W-1)`` times the blend, plus the own term's stage one;
    ``slack`` is the fp32 rounding allowed, relative to the largest
    input."""
    xs = [np.asarray(x, np.float64) for x in leaves]
    nw = xs[0].shape[0] // n_slices
    bucket, owner = bucket_map([x.shape[1:] for x in xs], nw, bucket_bytes)
    w = local_weight

    def quantum(values, wire_name, own=None):
        # one row: the largest quantum over the rows that encode
        if wire_name == "float32":
            return [np.zeros_like(v[:1]) for v in values]
        return [q.max(0, keepdims=True)
                for q in wire_quanta(values, wire_name, bucket, own)]

    means = [x.reshape(n_slices, nw, *x.shape[1:]).mean(1) for x in xs]
    blends = []
    for m in means:
        r1 = np.roll(m, 1, axis=0)
        if topology == "ring":
            g = (m + r1) / 2 if how == "equal" else w * m + (1 - w) * r1
        else:
            r2 = np.roll(m, 2, axis=0)
            g = ((m + r1 + r2) / 3 if how == "equal"
                 else w * m + (1 - w) / 2 * (r1 + r2))
        blends.append(g)
    q1 = quantum(xs, wire)
    qo = quantum(means, outer_wire, owner)
    q2 = quantum(blends, wire, owner)
    f = 1.0 if how == "equal" else (1.0 - w) * nw / (nw - 1)
    own = 0.0 if how == "equal" else 1.0
    return [np.broadcast_to(own * a + f * (a + b + c)
                            + slack * (1.0 + np.abs(x).max(0)), x.shape)
            for a, b, c, x in zip(q1, qo, q2, xs)]


def engines_worker(rank: int, world_size: int, store_path: str,
                   device: str, in_path: str, cases: list, out_dir: str,
                   timeout_s: float = mesh.GROUP_TIMEOUT_S) -> None:
    """One rank of an engines check (a spawn target): joins the group and
    runs each case of ``cases`` on its own row of the worker-stacked
    leaves in ``in_path`` (npz ``leaf{j}`` [world_size, ...], optional
    ``step{j}``), writing ``{out_dir}/rank{rank}.npz``.

    A case is a dict: ``mode`` (dense | gossip | sharded | hier), ``how``,
    ``topology``, ``wire`` (a ``WIRE_DTYPES`` name), ``ef`` (carry a
    residual), ``placement``, ``track`` (thread a round optimizer),
    ``bucket_bytes``, ``local_weight``, ``leaves`` (the indices of the
    leaves it syncs; default all), ``rounds`` (each round syncs the
    leaves again, carrying residual and tracker; with ``chain`` the next
    round syncs this round's output, plus ``step{j}`` with ``step``),
    ``tail`` (how many last rounds ``sum`` adds up; default all),
    ``residency`` (``resident``: the sync ends at the scatter), ``buddy``
    (arm the buddy hop) and ``poison`` (one flag per rank: arm the chaos
    screen).  A ``hier`` case also takes ``slices`` (S: the world is S
    slices of world_size / S workers, slice-major, on the grid
    ``{"slice": S, "data": W}`` made once per S), ``outer_wire`` (the outer
    hops' wire; ``ef`` then arms both levels' residuals) and ``twin``
    (also run ``comms.aggregate_hier`` on the first round's inputs: saved
    as ``c/twin{j}``); its bytes handed to gloo are saved by level,
    ``c/wire_ici`` and ``c/wire_dcn``, and its outer residual as
    ``c/outer_res/<bucket>``.  Saved per case ``c``: ``c/first{j}``,
    ``c/out{j}`` (last round; under ``resident`` ``c/resident/<bucket>``
    instead),
    ``c/sum{j}`` (the outputs of the tail rounds summed, float64),
    ``c/res{j}``, ``c/mu|nu/<bucket>``, ``c/buddy/<bucket>/<comp>``,
    ``c/ok`` (the screen's flag), ``c/wire_payload``, ``c/wire_scale`` and
    ``c/wire_buddy`` (bytes handed to gloo per round), ``c/ms`` and
    ``c/ms_min`` (this rank's wall of the first round and of its quickest
    round)."""
    with np.load(in_path) as f:
        leaves = [f[f"leaf{j}"][rank] for j in range(len(
            [k for k in f.files if k.startswith("leaf")]))]
        steps = {j: f[f"step{j}"][rank] for j in range(len(leaves))
                 if f"step{j}" in f.files}
    dev = mesh.worker_device(rank, device)
    out = {}
    with mesh.init_group(rank, world_size, dev, store_path,
                         timeout_s) as group:
        # the slice grids of the hier cases, made in the cases' order on
        # every rank (a collective)
        grids = {}
        for case in cases:
            sl = case.get("slices")
            if case["mode"] == "hier" and sl not in grids:
                grids[sl] = mesh.make_grid(
                    group, {"slice": sl, "data": world_size // sl})
        every = [torch.from_numpy(a).to(dev) for a in leaves]
        steps = {j: torch.from_numpy(a).to(dev) for j, a in steps.items()}
        for c, case in enumerate(cases):
            pick = case.get("leaves", range(len(every)))
            base = [every[j] for j in pick]
            step = [steps[j] for j in pick] if case.get("step") else []
            wdt = comms.WIRE_DTYPES[case.get("wire", "float32")]
            wdt = None if wdt == torch.float32 else wdt
            bucket_bytes = case.get("bucket_bytes",
                                    comms.DEFAULT_BUCKET_BYTES)
            res = ([torch.zeros_like(t) for t in base] if case.get("ef")
                   else None)
            placement = case.get("placement", "sharded")
            tracker = (comms.round_opt_init(base, world_size, rank,
                                      placement=placement,
                                      bucket_bytes=bucket_bytes, device=dev)
                       if case.get("track") else None)
            hier = case["mode"] == "hier"
            lines = ()
            if hier:
                grid = grids[case["slices"]]
                inner, outer = grid.groups["data"], grid.groups["slice"]
                lines = (inner, outer)
                owdt = comms.WIRE_DTYPES[case.get("outer_wire", "float32")]
                owdt = None if owdt == torch.float32 else owdt
                ores = (comms.hier_outer_residual_init(
                    base, inner.world_size, bucket_bytes=bucket_bytes,
                    device=dev) if case.get("ef") else None)
                if case.get("twin"):
                    twin = comms.aggregate_hier(
                        base, inner_group=inner, outer_group=outer,
                        topology=case["topology"],
                        how=case.get("how", "equal"),
                        local_weight=case.get("local_weight", 0.5))
                    for j, a in enumerate(twin):
                        out[f"{c}/twin{j}"] = a.cpu().numpy()
            xs, total = base, None
            group.wire.clear()
            for line in lines:
                line.wire.clear()
            rounds = int(case.get("rounds", 1))
            tail = int(case.get("tail", rounds))
            for k in range(rounds):
                t0 = time.perf_counter()
                extra = {}
                if case.get("residency"):
                    extra["residency"] = case["residency"]
                if case.get("buddy"):
                    extra["buddy"] = True
                if "poison" in case:
                    extra["poison"] = bool(case["poison"][rank])
                if hier:
                    extra.update(outer_group=outer, outer_wire_dtype=owdt,
                                 outer_residual=ores)
                rets = comms.fast_sync(
                    xs, group=inner if hier else group, mode=case["mode"],
                    how=case.get("how", "equal"),
                    topology=case.get("topology", "allreduce"),
                    local_weight=case.get("local_weight", 0.5),
                    wire_dtype=wdt, residual=res, bucket_bytes=bucket_bytes,
                    opt_placement=placement, tracker=tracker, **extra)
                synced, res, tracker = rets[:3]
                rest = list(rets[3:])
                if hier:
                    ores = rest.pop(0)
                if case.get("buddy"):
                    for name, parts in rest.pop(0).items():
                        for key, t in parts.items():
                            out[f"{c}/buddy/{name}/{key}"] = t.cpu().numpy()
                if "poison" in case:
                    out[f"{c}/ok"] = np.array(rest.pop(0))
                if isinstance(synced, dict):
                    for name, t in synced.items():
                        out[f"{c}/resident/{name}"] = t.cpu().numpy()
                    synced = []
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
                out[f"{c}/ms_min"] = np.array(
                    min(ms, out.get(f"{c}/ms_min", ms)))
                if k == 0:
                    out[f"{c}/ms"] = np.array(ms)
                    for j, a in enumerate(synced):
                        out[f"{c}/first{j}"] = a.cpu().numpy()
                host = [a.cpu().numpy() for a in synced]
                if k >= rounds - tail:
                    total = ([h.astype(np.float64) for h in host]
                             if total is None
                             else [t + h for t, h in zip(total, host)])
                if not case.get("chain"):
                    xs = base
                else:
                    xs = ([a + s for a, s in zip(synced, step)] if step
                          else synced)
            for j, a in enumerate(host):
                out[f"{c}/out{j}"] = a
                out[f"{c}/sum{j}"] = total[j]
            for j, a in enumerate(res or []):
                out[f"{c}/res{j}"] = a.cpu().numpy()
            for name, m in (tracker or {}).items():
                for key in ("mu", "nu"):
                    out[f"{c}/{key}/{name}"] = m[key].cpu().numpy()
            if hier:
                for name, t in (ores or {}).items():
                    out[f"{c}/outer_res/{name}"] = t.cpu().numpy()
                for level, line in (("ici", inner), ("dcn", outer)):
                    out[f"{c}/wire_{level}"] = np.array(
                        line.wire.get("payload", 0) // rounds)
                    out[f"{c}/wire_{level}_scale"] = np.array(
                        line.wire.get("scale", 0) // rounds)
            for kind in ("payload", "scale", "buddy"):
                out[f"{c}/wire_{kind}"] = np.array(
                    sum(g.wire.get(kind, 0) for g in (group, *lines))
                    // rounds)
        for grid in grids.values():
            grid.close()
    comms.save_npz(os.path.join(out_dir, f"rank{rank}.npz"), out)


def gloo_probe_worker(rank: int, world_size: int, store_path: str,
                      out_dir: str, timeout_s: float = 60.0) -> None:
    """One rank of a probe of the gloo collectives under this torch (a
    spawn target; CPU tensors): for ``all_to_all_single`` on fp32, bf16,
    int8 and uint8 (the bytes the fast engines hand gloo), ``all_gather``
    into a list of views (the engines' gather), ``all_gather_into_tensor``
    and ``all_gather_single``: whether the name exists, and whether the
    result is the expected one (or the error it raised).  Writes
    ``{out_dir}/gloo{rank}.json``."""
    n, out = world_size, {}

    def check(name, fn):
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ok = bool(fn())
            note = "; ".join(sorted({type(w.message).__name__
                                     for w in caught}))
            out[name] = "ok" if ok else "wrong result"
            if note:
                out[name] += f" ({note})"
        except Exception as e:   # noqa: BLE001 — the probe reports it
            out[name] = f"error: {type(e).__name__}: {e}"[:200]

    with mesh.init_group(rank, world_size, torch.device("cpu"), store_path,
                         timeout_s):
        base = (torch.arange(4 * n, dtype=torch.float32) + 100 * rank)
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                         ("int8", torch.int8), ("uint8", torch.uint8)):
            x = (base % 100).to(dt)

            def a2a(x=x):
                got = torch.empty_like(x)
                dist.all_to_all_single(got, x)
                want = torch.cat([((torch.arange(4 * n) + 100 * j) % 100)
                                  .to(x.dtype)[4 * rank:4 * rank + 4]
                                  for j in range(n)])
                return torch.equal(got, want)
            check(f"all_to_all_single/{name}", a2a)
        want = torch.cat([torch.full((3,), float(j)) for j in range(n)])
        mine = torch.full((3,), float(rank))

        def gather_views():
            buf = torch.empty(3 * n)
            dist.all_gather(list(buf.view(n, 3).unbind(0)), mine)
            return torch.equal(buf, want)
        check("all_gather/views", gather_views)
        for name in ("all_gather_into_tensor", "all_gather_single"):
            fn = getattr(dist, name, None)
            if fn is None:
                out[name] = "missing"
                continue

            def call(fn=fn):
                buf = torch.empty(3 * n)
                fn(buf, mine)
                return torch.equal(buf, want)
            check(name, call)
    path = os.path.join(out_dir, f"gloo{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
