"""The port's bucketed sync engines (``comms.sharded_opt_sync``,
``comms.gossip_sync``) on N gloo processes against the JAX package's
``comms.make_host_sync`` on an N-device CPU mesh, and against the port's
own dense ``aggregate``: the bucket plan and wire bytes as JAX's exact
integers; the fp32 engines bitwise the dense path where the sum order
allows (N = 2; the gossip blends at every N), bitwise equal on every rank
and to a float32 sum in rank order, within 1e-6 of JAX; the bf16/int8
wire and its error feedback within one wire quantum of JAX; the round
optimizer's rows; and a 2-worker ``driver.round_worker`` round of the mlp
under each engine against JAX's engine.

One spawn of N ranks per N (``sync_harness.engines_worker``) runs every
case; the children write under ``tmp_path`` and the parent holds them
against JAX and numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
    train as j_train,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    comms,
    driver as t_driver,
    mesh,
    sync_harness,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config as TConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

W = 0.7                       # local_weight of the weighted blends
TINY = 64                     # bytes: 16 fp32 elements a bucket
SIZES = ((7,), (3, 5), (1,), (129,))
SMALL = list(range(len(SIZES)))
STALL, SPREAD = len(SIZES), len(SIZES) + 1     # the two 512-leaves
RTOL = ATOL = 1e-6
JDT = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}


def _case(mode, how="equal", topology="allreduce", **kw):
    return dict(mode=mode, how=how, topology=topology, local_weight=W,
                leaves=SMALL, bucket_bytes=TINY, **kw)


CASES = {}
for _how in ("equal", "weighted"):
    for _top in ("allreduce", "ring", "double_ring"):
        CASES[f"dense/{_how}/{_top}"] = _case("dense", _how, _top)
        CASES[f"fast/{_how}/{_top}"] = (
            _case("sharded", _how, _top, track=True, placement="sharded")
            if _top == "allreduce" else _case("gossip", _how, _top))
    CASES[f"replicated/{_how}"] = _case("sharded", _how, track=True,
                                        placement="replicated")
# the compressed wire: (engine topology, how, wire, error feedback)
WIRE = [("allreduce", "equal", "int8", True),
        ("allreduce", "equal", "bfloat16", False),
        ("allreduce", "weighted", "int8", False),
        ("allreduce", "weighted", "bfloat16", True),
        ("ring", "equal", "int8", True),
        ("double_ring", "weighted", "bfloat16", False),
        ("double_ring", "equal", "int8", True)]
for _top, _how, _wire, _ef in WIRE:
    CASES[f"wire/{_top}/{_how}/{_wire}/{_ef}"] = _case(
        "sharded" if _top == "allreduce" else "gossip", _how, _top,
        wire=_wire, ef=_ef)
# error feedback over rounds (JAX tests/test_sync.py:135-170, :395-422,
# tests/test_gossip_engine.py:113-158), at N=4 only
CASES["avg/int8/ef"] = _case("sharded", wire="int8", ef=True, rounds=24)
for _name, _kw in (("ref", dict(mode="dense")),
                   ("ef", dict(mode="sharded", wire="bfloat16", ef=True)),
                   ("raw", dict(mode="sharded", wire="bfloat16"))):
    CASES[f"stall/{_name}"] = dict(
        how="equal", topology="allreduce", leaves=[STALL], chain=True,
        step=True, rounds=150, **_kw)
for _top in ("ring", "double_ring"):
    for _ef in (True, False):
        CASES[f"contract/{_top}/{_ef}"] = dict(
            mode="gossip", how="equal", topology=_top, leaves=[SPREAD],
            wire="bfloat16", ef=_ef, chain=True, rounds=60, tail=20)
N4_ONLY = ("avg/", "stall/", "contract/")


def _inputs(n: int):
    """Per-worker leaves [n, ...]: the small normal leaves, worker r's
    scaled by 1 + r (each sender's int8 scale is its own), a 512-leaf in
    the bf16 stall regime (values ~100, steps far below the quantum) and a
    512-leaf of workers ~0.2 apart around ~100; steps of the stall leaf."""
    rng = np.random.default_rng(n)
    scale = (1.0 + np.arange(n)).astype(np.float32)
    leaves = [(rng.normal(size=(n, *s)).astype(np.float32)
               * scale.reshape(n, *[1] * len(s))) for s in SIZES]
    row = rng.uniform(64, 128, 512) * rng.choice([-1.0, 1.0], 512)
    leaves.append(np.broadcast_to(row, (n, 512)).astype(np.float32))
    leaves.append((row[None] + 0.2 * rng.normal(size=(n, 512)))
                  .astype(np.float32))
    steps = {STALL: rng.uniform(0.02, 0.08, (n, 512)).astype(np.float32)}
    return leaves, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """n -> (leaves, names, [rank results]) of one spawn of n ranks."""
    cache = {}

    def get(n):
        if n not in cache:
            d = tmp_path_factory.mktemp(f"engines{n}")
            leaves, steps = _inputs(n)
            names = [k for k in CASES
                     if n == 4 or not k.startswith(N4_ONLY)]
            np.savez(d / "in.npz",
                     **{f"leaf{j}": a for j, a in enumerate(leaves)},
                     **{f"step{j}": a for j, a in steps.items()})
            store = mesh.new_store_path()
            try:
                mesh.join_workers(mesh.spawn_workers(
                    sync_harness.engines_worker, n,
                    (store, "cpu", str(d / "in.npz"),
                     [CASES[k] for k in names], str(d), 60.0),
                    ranks=range(n)), timeout_s=180.0)
            finally:
                mesh.remove_store(store)
            outs = []
            for r in range(n):
                with np.load(d / f"rank{r}.npz") as f:
                    outs.append({k: f[k] for k in f.files})
            cache[n] = leaves, names, outs
        return cache[n]
    return get


def _get(run, name, key):
    """[rank results] of case ``name``'s ``key`` (e.g. ``out0``)."""
    _leaves, names, outs = run
    c = names.index(name)
    return [o[f"{c}/{key}"] for o in outs]


def _outs(run, name, first=False):
    """Per leaf j of the case, the [n, ...] stack of every rank's result."""
    k = "first" if first else "out"
    pick = CASES[name]["leaves"]
    return [np.stack(_get(run, name, f"{k}{j}")) for j in range(len(pick))]


def _jax_sync(devices, n, case, leaves, residual=False, tracker=False):
    """JAX ``make_host_sync`` of ``case`` on an n-device mesh:
    (outputs, residual, tracker) as numpy."""
    mode = {"sharded": "sharded", "gossip": "gossip"}[case["mode"]]
    wire = JDT.get(case.get("wire", "float32"))
    sync = j_comms.make_host_sync(
        build_mesh({"data": n}, devices[:n]), mode=mode, how=case["how"],
        local_weight=W, wire_dtype=wire, bucket_bytes=case["bucket_bytes"],
        topology=case["topology"],
        opt_placement=case.get("placement", "sharded"), track_opt=tracker)
    tree = [jnp.asarray(leaves[j]) for j in case["leaves"]]
    res = ([jnp.zeros_like(t) for t in tree] if residual else None)
    if tracker:
        shapes = [jax.ShapeDtypeStruct(t.shape[1:], t.dtype) for t in tree]
        trk = j_comms.round_opt_init(shapes, n, placement=case["placement"],
                                     bucket_bytes=case["bucket_bytes"])
        out, new_res, new_trk = sync(tree, res, trk)
    else:
        (out, new_res), new_trk = sync(tree, res), None
    get = lambda t: None if t is None else jax.device_get(t)
    return get(out), get(new_res), get(new_trk)


# ----------------------------------------------------------------------
# the bucket plan and the wire accounting: JAX's exact integers
# ----------------------------------------------------------------------

PLAN_SHAPES = [(7,), (3, 5), (1,), (129,), (64, 3), (2, 2, 2), (1000,)]


@pytest.mark.parametrize("bucket_bytes", [4, 64, 1000, 4 << 20])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_bucket_plan_is_jaxs(n, bucket_bytes):
    dts = [jnp.float32, jnp.bfloat16] * 4
    j_leaves = [jax.ShapeDtypeStruct(s, dt) for s, dt in zip(PLAN_SHAPES, dts)]
    t_leaves = [(s, getattr(torch, jnp.dtype(dt).name))
                for s, dt in zip(PLAN_SHAPES, dts)]
    want = j_comms.bucket_plan(j_leaves, n, bucket_bytes)
    got = comms.bucket_plan(t_leaves, n, bucket_bytes)
    assert [(b.padded, b.items) for b in got] == \
        [(b.padded, b.items) for b in want]
    assert [str(b.dtype).removeprefix("torch.") for b in got] == \
        [jnp.dtype(b.dtype).name for b in want]
    if bucket_bytes == 4:       # a tiny target: one leaf a bucket
        assert len(got) == len(PLAN_SHAPES)
    assert all(b.padded % n == 0 for b in got)


@pytest.mark.parametrize("bucket_bytes", [64, 4 << 20])
@pytest.mark.parametrize("topology", ["allreduce", "ring", "double_ring"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_wire_bytes_are_jaxs_and_halve_and_quarter(n, topology,
                                                   bucket_bytes):
    j_leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in PLAN_SHAPES]
    t_leaves = [(s, torch.float32) for s in PLAN_SHAPES]
    for mode in ("dense", "sharded" if topology == "allreduce"
                 else "gossip"):
        got = {}
        for name, jdt, tdt in (("f32", None, None),
                               ("bf16", jnp.bfloat16, torch.bfloat16),
                               ("int8", jnp.int8, torch.int8)):
            got[name] = comms.sync_wire_bytes(
                t_leaves, n, mode=mode, wire_dtype=tdt,
                bucket_bytes=bucket_bytes, topology=topology)
            assert got[name] == j_comms.sync_wire_bytes(
                j_leaves, n, mode=mode, wire_dtype=jdt,
                bucket_bytes=bucket_bytes, topology=topology)
        if mode != "dense":
            assert got["bf16"] * 2 == got["f32"] == got["int8"] * 4
    assert comms.sync_wire_bytes(t_leaves, 1) == 0


@pytest.mark.parametrize("n", [2, 3, 4])
def test_engines_hand_gloo_the_accounted_bytes(runs, n):
    """What each engine handed to gloo for other ranks equals
    ``sync_wire_bytes`` (JAX's accounting counts double_ring's second hop
    at n = 2, a hop to the worker itself, which sends nothing); an int8
    bucket's scale rides apart (4 bytes per bucket per peer and phase)."""
    run = runs(n)
    leaves = [(s, torch.float32) for s in SIZES]
    for name, case in CASES.items():
        if name.startswith(N4_ONLY) or case["mode"] == "dense":
            continue
        wdt = comms.WIRE_DTYPES[case.get("wire", "float32")]
        want = comms.sync_wire_bytes(
            leaves, n, mode=case["mode"], wire_dtype=wdt,
            bucket_bytes=TINY, topology=case["topology"])
        if case["mode"] == "gossip":
            hops = comms._SHIFTS[case["topology"]]
            want = want * sum(1 for s in hops if s % n) // len(hops)
        for r, got in enumerate(_get(run, name, "wire_payload")):
            assert int(got) == want, (name, r)
        scale = {int(s) for s in _get(run, name, "wire_scale")}
        assert (scale == {0}) == (case.get("wire") != "int8"), name


# ----------------------------------------------------------------------
# fp32: the dense path's results, JAX's within 1e-6
# ----------------------------------------------------------------------

@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_fp32_sharded_against_dense_and_rank_order_sum(runs, n, how):
    """N = 2: bitwise the dense all-reduce.  Every N: an equal blend is
    bitwise the same on every rank and bitwise the float32 sum in rank
    order over n; the weighted blend is the dense one at 1e-6 (gloo's
    all-reduce sums in an order of its own)."""
    run = runs(n)
    fast = _outs(run, f"fast/{how}/allreduce")
    dense = _outs(run, f"dense/{how}/allreduce")
    for j, (f, d) in enumerate(zip(fast, dense)):
        if n == 2:
            np.testing.assert_array_equal(f, d, err_msg=f"leaf{j}")
        np.testing.assert_allclose(f, d, rtol=RTOL, atol=ATOL)
    if how == "equal":
        leaves = run[0]
        for j, f in enumerate(fast):
            acc = leaves[j][0]
            for i in range(1, n):
                acc = acc + leaves[j][i]
            want = acc / np.float32(n)
            for r in range(n):
                np.testing.assert_array_equal(f[r], want,
                                              err_msg=f"leaf{j} rank {r}")


@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("n", [2, 4])
def test_fp32_sharded_matches_jax_both_placements(runs, devices, n, how):
    """Against JAX ``make_host_sync(mode="sharded")`` at 1e-6 under both
    placements; the two placements bitwise equal; the round optimizer's
    sharded rows the exact row partition of the replicated vector, and
    each row JAX's at 1e-6."""
    run = runs(n)
    leaves = run[0]
    sharded = _outs(run, f"fast/{how}/allreduce")
    replicated = _outs(run, f"replicated/{how}")
    for a, b in zip(sharded, replicated):
        np.testing.assert_array_equal(a, b)
    for name, placement in ((f"fast/{how}/allreduce", "sharded"),
                            (f"replicated/{how}", "replicated")):
        case = CASES[name]
        j_out, _r, j_trk = _jax_sync(devices, n, case, leaves, tracker=True)
        for j, got in enumerate(_outs(run, name)):
            np.testing.assert_allclose(got, j_out[j], rtol=RTOL, atol=ATOL)
        for b in j_trk:
            for m in ("mu", "nu"):
                rows = np.stack(_get(run, name, f"{m}/{b}"))
                np.testing.assert_allclose(rows, j_trk[b][m], rtol=RTOL,
                                           atol=1e-12)
    for b in j_trk:
        for m in ("mu", "nu"):
            rows = _get(run, f"fast/{how}/allreduce", f"{m}/{b}")
            full = _get(run, f"replicated/{how}", f"{m}/{b}")
            for r in range(n):
                np.testing.assert_array_equal(full[r], full[0])
            np.testing.assert_array_equal(np.concatenate(rows), full[0])


@pytest.mark.parametrize("topology", ["ring", "double_ring"])
@pytest.mark.parametrize("how", ["equal", "weighted"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_fp32_gossip_bitwise_dense_and_jax(runs, devices, n, how, topology):
    run = runs(n)
    fast = _outs(run, f"fast/{how}/{topology}")
    for f, d in zip(fast, _outs(run, f"dense/{how}/{topology}")):
        np.testing.assert_array_equal(f, d)
    if n != 3:
        j_out, _r, _t = _jax_sync(devices, n,
                                  CASES[f"fast/{how}/{topology}"], run[0])
        for f, w in zip(fast, j_out):
            np.testing.assert_allclose(f, w, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# the compressed wire: one quantum of JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", WIRE, ids=["/".join(map(str, w))
                                            for w in WIRE])
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_single_sync_within_a_quantum_of_jax(runs, devices, n,
                                                        spec):
    """Each rank's output within one stage-two quantum of JAX's and within
    one quantum of each stage of the fp32 blend; with EF the residual
    JAX's but for the owner's n x stage-two rounding.  The workers' leaves
    differ in scale, so a payload decoded with another sender's scale
    lands outside."""
    topology, how, wire, ef = spec
    name = f"wire/{topology}/{how}/{wire}/{ef}"
    run = runs(n)
    leaves = run[0]
    case = CASES[name]
    to_jax, to_fp32, to_res = sync_harness.compressed_bounds(
        [leaves[j] for j in case["leaves"]], n, mode=case["mode"], how=how,
        wire=wire, bucket_bytes=TINY, local_weight=W, slack=RTOL)
    j_out, j_res, _t = _jax_sync(devices, n, CASES[name], leaves,
                                 residual=ef)
    got = _outs(run, name)
    dense = _outs(run, f"dense/{how}/{topology}")
    for j, (g, w, d) in enumerate(zip(got, j_out, dense)):
        assert (np.abs(g - w) <= to_jax[j]).all(), (name, j)
        assert (np.abs(g - d) <= to_fp32[j]).all(), (name, j)
        assert not np.array_equal(g, d), (name, j)    # the wire rounded
    if ef:
        res = [np.stack(_get(run, name, f"res{j}")) for j in SMALL]
        assert any(np.abs(r).max() > 0 for r in res)
        for j, (r, w) in enumerate(zip(res, j_res)):
            assert (np.abs(r - w) <= to_res[j]).all(), (name, j)


def test_error_feedback_time_average_converges(runs):
    """JAX ``test_error_feedback_time_average_converges``: re-syncing the
    same leaves with int8 + EF, the time-average of the outputs lands far
    closer to the exact mean than one sync does."""
    run = runs(4)
    dense = _outs(run, "dense/equal/allreduce")
    first = _outs(run, "avg/int8/ef", first=True)
    total = [np.stack(_get(run, "avg/int8/ef", f"sum{j}")) for j in SMALL]
    err_one = max(np.abs(f - d).max() for f, d in zip(first, dense))
    err_avg = max(np.abs(t / 24 - d).max() for t, d in zip(total, dense))
    assert err_avg < 0.25 * err_one, (err_avg, err_one)


def test_error_feedback_tracks_fp32_where_plain_bf16_stalls(runs):
    """JAX ``test_error_feedback_tracks_fp32_where_plain_bf16_stalls``: 150
    rounds of sub-quantum steps; the EF run follows the fp32 run, the
    plain bf16 run freezes."""
    run = runs(4)
    base = run[0][STALL]
    (ref,), (ef,), (raw,) = (_outs(run, f"stall/{k}")
                             for k in ("ref", "ef", "raw"))
    move = float(np.abs(ref - base).mean())
    err_ef = float(np.abs(ef - ref).mean())
    err_raw = float(np.abs(raw - ref).mean())
    assert move > 5.0
    assert err_ef < 0.15 * move, (err_ef, move)
    assert err_raw > 3 * err_ef, (err_raw, err_ef)


@pytest.mark.parametrize("topology", ["ring", "double_ring"])
def test_gossip_ef_consensus_contracts_to_dense_fixed_point(runs, topology):
    """JAX ``test_ef_consensus_contracts_to_dense_fixed_point``: 60 bf16
    gossip rounds of workers ~0.2 apart around ~100 (a quantum ~0.5);
    both runs contract the spread, and the EF run's time-average over the
    last 20 rounds lands at least 2x closer to the true mean."""
    run = runs(4)
    x0 = run[0][SPREAD]
    true = x0.mean(0)
    var0 = float(((x0 - true) ** 2).mean())
    dist = {}
    for ef in (True, False):
        name = f"contract/{topology}/{ef}"
        (last,) = _outs(run, name)
        assert float(((last - last.mean(0)) ** 2).mean()) < 0.5 * var0
        avg = np.stack(_get(run, name, "sum0")) / 20
        dist[ef] = float(np.abs(avg - true[None]).mean())
    assert dist[True] < 0.5 * dist[False], dist


def test_validation_and_one_worker_identity():
    xs = [torch.randn(3), torch.randn(2, 2)]
    assert comms.sharded_opt_sync(xs, group=None)[0] == xs
    assert comms.gossip_sync(xs, group=None, topology="ring")[0] == xs
    with pytest.raises(ValueError, match="how must be"):
        comms.sharded_opt_sync(xs, group=None, how="median")
    with pytest.raises(ValueError, match="opt_placement must be 'sharded'"):
        comms.sharded_opt_sync(xs, group=None, wire_dtype=torch.int8,
                               opt_placement="replicated")
    with pytest.raises(ValueError, match="allreduce rides sharded_opt_sync"):
        comms.gossip_sync(xs, group=None, topology="allreduce")
    with pytest.raises(ValueError, match="residual must mirror"):
        comms.sharded_opt_sync(xs, group=None, residual=xs[:1])


def test_wire_codec_is_jaxs():
    """The one codec (the real wire and the lab's simulated wire): int8
    payload and scale, bf16 downcast, against JAX ``_wire_codec``."""
    x = np.random.default_rng(3).normal(size=257).astype(np.float32) * 3
    for name in ("int8", "bfloat16"):
        _q, encode = j_comms._wire_codec(jnp.dtype(JDT[name]))
        jp, jd, js = (None if a is None else np.asarray(
            jnp.asarray(a, jnp.float32)) for a in encode(jnp.asarray(x)))
        tp, td, ts = comms.wire_encode(torch.from_numpy(x),
                                       comms.WIRE_DTYPES[name])
        np.testing.assert_array_equal(tp.float().numpy(), jp)
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-7)
        if name == "int8":
            np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


@pytest.mark.parametrize("model,kw", [
    ("enhanced_cnn", dict(width=8)), ("gpt_tiny", {}),
    ("llama_tiny", dict(num_kv_heads=2)), ("vit_tiny", {})])
def test_wire_layout_packs_in_jax_flatten_order(model, kw):
    """``weights.wire_layout``: the packed vector is the model's flax
    params in ``tree_flatten`` order, the leaves its JAX shapes, and the
    unpack restores every parameter bitwise."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
        get_model,
    )
    m = get_model(model, num_classes=10, **kw)
    m.init_parameters(torch.Generator().manual_seed(0))
    layout = comms.WireLayout(*weights.wire_layout(m))
    ps = list(m.parameters())
    flat = layout.pack(ps)
    tree = weights._flax_collections(
        {n: p.detach() for n, p in m.named_parameters()},
        weights.state_layout(m))["params"]
    keyed = weights._keyed("", tree)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([a.reshape(-1) for _k, a in keyed]))
    assert [s for s, _d in layout.leaves] == [a.shape for _k, a in keyed]
    for a, b in zip(layout.unpack(flat, ps), ps):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# 2-worker rounds under each engine against JAX's engine
# ----------------------------------------------------------------------

N, STEPS, BATCH, LR = 2, 3, 4, 1e-4
BUCKET_BYTES = 1 << 18      # --sync_bucket_mb 0.25: the mlp in two buckets
METRICS = ("train_loss", "train_acc", "val_loss", "val_acc", "batch_losses",
           "batch_mask", "avg_acc", "global_train_loss", "global_train_acc",
           "global_val_loss", "global_val_acc")
# (name, aggregation_by, aggregation_type, topology, extra config, rounds):
# the compressed wires run two rounds (round 1 sends through round 0's
# residual), K = 1 three (round 0's delta lands at round 2's entry)
ROUNDS = [
    ("dense", "weights", "equal", "allreduce", dict(sync_mode="dense"), 1),
    ("sharded", "weights", "equal", "allreduce", dict(sync_mode="sharded"),
     1),
    ("int8_ef", "weights", "equal", "allreduce",
     dict(sync_dtype="int8", sync_compression="ef"), 2),
    ("gossip_bf16_ef", "weights", "weighted", "double_ring",
     dict(sync_mode="sharded", sync_dtype="bfloat16",
          sync_compression="ef"), 2),
    ("gradients", "gradients", "equal", "allreduce",
     dict(sync_mode="sharded"), 1),
    ("stale1", "weights", "equal", "allreduce",
     dict(sync_mode="sharded", sync_staleness=1), 3),
]
JAX_TWIN = {"dense": "sharded"}     # JAX's engine run a port run is held to


def _kw(by, how, topology, extra):
    return dict(model="mlp", dataset="mnist", epochs_local=2,
                batch_size=BATCH, compute_dtype="float32", augment=False,
                aggregation_by=by, aggregation_type=how, topology=topology,
                local_weight=W, lr=LR, sync_bucket_mb=BUCKET_BYTES / 2 ** 20,
                **extra)


def _packs():
    train, _ = load_dataset("mnist", seed=0,
                            limit_train=2 * N * STEPS * BATCH, limit_test=1)
    x = train.images.reshape(2, N, STEPS, BATCH, *train.images.shape[1:])
    y = train.labels.reshape(2, N, STEPS, BATCH)
    m = np.ones((N, STEPS, BATCH), np.float32)
    return (x[0], y[0], m), (x[1], y[1], m)


@pytest.fixture(scope="module")
def rounds(devices, tmp_path_factory):
    """name -> (jax state, [jax metrics per round], [per-rank port
    result]), every run from one init."""
    d = tmp_path_factory.mktemp("engine_round")
    train_pack, val_pack = _packs()
    j_mesh = build_mesh({"data": N}, devices[:N])
    j_runs = {}
    variables0 = None
    for name, by, how, top, extra, n_rounds in ROUNDS:
        if name in JAX_TWIN:
            continue
        # JAX resolves weights x equal on its sharded engine to the
        # scatter-resident layout; the port keeps it replicated
        j_kw = dict(_kw(by, how, top, extra), param_residency="replicated")
        engine = j_train.LocalSGDEngine(
            j_get_model("mlp", num_classes=10), j_mesh, JConfig(**j_kw))
        state = engine.init_state(jax.random.key(0), train_pack[0][0, 0])
        if variables0 is None:
            variables0 = jax.device_get(engine.rank0_variables(state))
        mxs = []
        for _ in range(n_rounds):
            state, mx = engine.round(state, train_pack, val_pack)
            mxs.append(jax.device_get(mx))
        state = engine.drain_pending(state)
        j_runs[name] = (jax.device_get(state), mxs)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                weights.cnn_flax_to_torch(variables0).items()},
               d / "state.pt")
    np.savez(d / "packs.npz", x=train_pack[0], y=train_pack[1],
             m=train_pack[2], xv=val_pack[0], yv=val_pack[1], mv=val_pack[2])
    cfgs = [TConfig(device="cpu", **_kw(by, how, top, extra))
            for _n, by, how, top, extra, _r in ROUNDS]
    store = mesh.new_store_path()
    procs = mesh.spawn_workers(
        t_driver.round_worker, N,
        (store, cfgs, 10, str(d / "state.pt"), str(d / "packs.npz"), str(d),
         60.0, [r for *_rest, r in ROUNDS]), ranks=range(N))
    try:
        mesh.join_workers(procs, timeout_s=180.0)
    finally:
        mesh.stop_workers(procs)
        mesh.remove_store(store)
    out = {}
    for i, (name, *_rest) in enumerate(ROUNDS):
        port = [torch.load(d / f"rank{r}-{i}.pt", weights_only=False)
                for r in range(N)]
        out[name] = (*j_runs[JAX_TWIN.get(name, name)], port)
    return out


def _row(tree, r):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[r], tree)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _quanta(tree, wire, owned=False) -> dict:
    """Per element of the flax tree ``tree`` (one worker's, wire order),
    one quantum of the wire's encoding of it in the round's bucket plan
    (``owned``: of the owned shard's encoding)."""
    keys, leaves = zip(*_flat(tree).items())
    bucket, owner = sync_harness.bucket_map([a.shape for a in leaves], N,
                                            BUCKET_BYTES)
    q = sync_harness.wire_quanta([a[None] for a in leaves], wire, bucket,
                                 owner if owned else None)
    return {k: a[0] for k, a in zip(keys, q)}


def _owned(tree, r) -> dict:
    """True where worker ``r`` owns the element's shard of its bucket."""
    keys, leaves = zip(*_flat(tree).items())
    _b, owner = sync_harness.bucket_map([a.shape for a in leaves], N,
                                        BUCKET_BYTES)
    return {k: o == r for k, o in zip(keys, owner)}


def _check_metrics(j_mxs, port):
    """Every round's metrics at test_torch_dist's rtol 1e-4."""
    assert len(port["mxs"]) == len(j_mxs)
    for mx, j_mx in zip(port["mxs"], j_mxs):
        for key in METRICS:
            np.testing.assert_allclose(mx[key], np.asarray(j_mx[key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


def _check_close(got: dict, want: dict, bound: float, quantum=None,
                 where=""):
    """test_torch_dist's bar on flat trees: every element within
    ``bound`` (on a compressed wire plus one ``quantum`` of its encoding,
    per element, where the two frameworks' roundings of a near-tie may
    part), and at most one element in 1e4 beyond 1e-4."""
    assert set(got) == set(want), where
    beyond, total = 0, 0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        q = 0.0 if quantum is None else quantum[k]
        assert (err <= bound + q).all(), (where, k, float(err.max()))
        beyond += int((err > 1e-4).sum())
        total += err.size
    assert beyond <= total * 1e-4, (where, beyond, total)


def _check_worker_state(j_state, port, r, wire=None):
    want = _flat(_row(j_state.params, r))
    got = _flat(weights.cnn_torch_to_flax(port["state_dict"])["params"])
    quantum = None
    if wire is not None:
        quantum = _quanta(_row(j_state.params, r), wire,
                          owned=wire == "int8")
    _check_close(got, want, 2 * LR * port["opt_count"], quantum,
                 f"params r{r}")


@pytest.mark.parametrize("name", ["sharded", "int8_ef", "gossip_bf16_ef",
                                  "stale1"])
def test_two_worker_engine_round_matches_jax_engine(rounds, name):
    """Every round's metrics at rtol 1e-4 and each rank's parameters at
    test_torch_dist's bounds against JAX's engine; a compressed wire may
    put an element one quantum of its output off.  The fp32 sharded round
    is bitwise the dense round; after an equal all-reduce the ranks hold
    the same bits."""
    j_state, j_mxs, port = rounds[name]
    wire = {"int8_ef": "int8", "gossip_bf16_ef": "bfloat16"}.get(name)
    for r in range(N):
        _check_metrics(j_mxs, port[r])
        _check_worker_state(j_state, port[r], r, wire)
    a, b = (_params(p["state_dict"]) for p in port)
    if name in ("sharded", "int8_ef"):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if name == "sharded":
        dense = rounds["dense"][2]
        for r in range(N):
            a, b = port[r]["state_dict"], dense[r]["state_dict"]
            for k in _params(a):
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["int8_ef", "gossip_bf16_ef"])
def test_two_worker_ef_residual_matches_jax_engine(rounds, name):
    """After two rounds the EF residual each rank carries (round 1 sent
    through round 0's) against JAX's ``TrainState.sync_residual``: within
    one quantum of the stage-one encoding, plus, for the reduce-scatter,
    n x a stage-two quantum on the shard the rank owns."""
    j_state, _mxs, port = rounds[name]
    wire = "int8" if name == "int8_ef" else "bfloat16"
    for r in range(N):
        res = dict(zip(_params(port[r]["state_dict"]),
                       port[r]["sync_residual"]))
        got = _flat(weights.cnn_torch_to_flax(res)["params"])
        want = _flat(_row(j_state.sync_residual, r))
        assert any(np.abs(v).max() > 0 for v in got.values())
        params = _row(j_state.params, r)
        quantum = _quanta(params, wire)
        if wire == "int8":
            owned = _owned(params, r)
            q2 = _quanta(params, wire, owned=True)
            quantum = {k: q + N * q2[k] * owned[k]
                       for k, q in quantum.items()}
        _check_close(got, want, 1e-6, quantum, f"residual r{r}")


def test_two_worker_stale_rounds_deliver_on_jaxs_schedule(rounds):
    """K = 1 over three rounds: round 0's delta folds in at round 2's
    entry (one delivery in the rounds), rounds 1 and 2 at the drain.  The
    metrics of the three rounds and the drained parameters are held
    against JAX's staleness engine by
    ``test_two_worker_engine_round_matches_jax_engine[stale1]``."""
    _j_state, _mxs, port = rounds["stale1"]
    assert [(p["stale_in_rounds"], p["stale_log_len"]) for p in port] == \
        [(1, 3)] * N


def _params(state_dict):
    return {k: v for k, v in state_dict.items() if ".running_" not in k}


def test_two_worker_round_optimizer_matches_jax(rounds):
    """Gradients mode under the sharded engine: each rank's round-optimizer
    rows (the bucket plan over the mlp's flax leaves) against JAX's
    ``TrainState.round_opt`` row at 1e-4 relative; the metrics and the
    parameters (left as the local phase left them) at test_torch_dist's
    bounds."""
    j_state, j_mxs, port = rounds["gradients"]
    j_trk = j_state.round_opt
    for r in range(N):
        trk = port[r]["round_opt"]
        assert set(trk) == set(j_trk)
        for b in trk:
            for m in ("mu", "nu"):
                want = np.asarray(j_trk[b][m])[r]
                got = trk[b][m].numpy()
                assert got.shape == want.shape
                np.testing.assert_allclose(
                    got, want, rtol=1e-4,
                    atol=1e-4 * float(np.abs(want).max()))
        _check_metrics(j_mxs, port[r])
        _check_worker_state(j_state, port[r], r)
