"""The port's hierarchical two-level sync (``comms.hierarchical_sync``,
``--num_slices``) against the JAX package's (``comms.make_hier_host_sync``,
``make_hier_host_aggregator`` on the 8-device CPU mesh; JAX
``tests/test_hier_sync.py``).

S slices of W workers, slice-major, at JAX's layouts 2x2, 2x4 and 4x2, on
JAX's uneven leaves in JAX's tiny buckets.  The port's fp32 engine is held
bitwise against its own dense twin ``comms.aggregate_hier`` and, at
rtol=atol 1e-6, against JAX's engine and JAX's twin; the wire bytes per
level are JAX's exact integers, and the bytes handed to gloo match them;
each level's error feedback drifts and accumulates as JAX's; an engine
round in weights mode is the dense twin applied to the pre-sync parameters
(a gradients round's) and JAX's engine round; the checkpoint re-layouts
across slice counts restore, or refuse, as JAX's do; the config resolves
and refuses with JAX's messages.

One spawn of gloo ranks per world size (``sync_harness.engines_worker``)
runs every comms case in turn; the children write under ``tmp_path``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    checkpoint as j_ckpt,
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
    checkpoint as t_ckpt,
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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
    LocalSGDEngine,
)

# JAX's uneven leaves (nothing divisible by the worker counts: every bucket
# pads) and tiny buckets (tests/test_hier_sync.py:38-40)
SHAPES = {"a": (13, 7), "b": (257,), "c": (31, 5), "d": (3,)}
TINY_BUCKET = 1024
LAYOUTS = [(2, 2), (2, 4), (4, 2)]   # (slices, workers per slice)
W = 0.3                              # JAX's local_weight in these tests
RTOL = ATOL = 1e-6
EF_LEAF = len(SHAPES)                # the drifting leaf of the EF cases
EF_ROUNDS = 30


def _case(s, topology, how="equal", **kw):
    return dict(mode="hier", slices=s, how=how, topology=topology,
                local_weight=W, bucket_bytes=TINY_BUCKET,
                leaves=list(range(len(SHAPES))), **kw)


CASES: dict[int, dict] = {4: {}, 8: {}}
for _s, _w in LAYOUTS:
    for _top in ("ring", "double_ring"):
        for _how in ("equal", "weighted"):
            CASES[_s * _w][f"fp32/{_s}x{_w}/{_top}/{_how}"] = _case(
                _s, _top, _how, twin=True)
CASES[8]["resident/2x4"] = _case(2, "ring", residency="resident")
CASES[8]["ef_bf16/2x4"] = _case(2, "ring", outer_wire="bfloat16", ef=True)
for _how in ("equal", "weighted"):
    CASES[4][f"int8x2/2x2/{_how}"] = _case(2, "double_ring", _how,
                                           wire="int8", outer_wire="int8")
# JAX's drifting-consensus regime (tests/test_hier_sync.py:334-366): the
# int8 outer wire with and without error feedback against fp32, 30 rounds
# of (sync, then a step) from one base
for _name, _kw in (("ref", {}), ("ef", dict(outer_wire="int8", ef=True)),
                   ("raw", dict(outer_wire="int8"))):
    CASES[4][f"drift/{_name}"] = dict(
        _case(2, "ring", **_kw), leaves=[EF_LEAF], chain=True, step=True,
        rounds=EF_ROUNDS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n: int):
    """JAX's ``stacked_tree(n)`` leaves (seed 0, keys in order) plus the
    drifting leaf: a [n, 256] base ~50 wide and its per-round steps."""
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=(n, *s)).astype(np.float32)
              for s in SHAPES.values()]
    drift = np.random.default_rng(1)
    leaves.append((drift.normal(size=(n, 256)) * 50).astype(np.float32))
    step = drift.uniform(0.01, 0.03, (n, 256)).astype(np.float32)
    return leaves, {EF_LEAF: step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """n -> (leaves, names, [rank results]) of one spawn of n ranks."""
    cache = {}

    def get(n):
        if n not in cache:
            d = tmp_path_factory.mktemp(f"hier{n}")
            leaves, steps = _inputs(n)
            names = list(CASES[n])
            np.savez(d / "in.npz",
                     **{f"leaf{j}": a for j, a in enumerate(leaves)},
                     **{f"step{j}": a for j, a in steps.items()})
            store = mesh.new_store_path()
            try:
                mesh.join_workers(mesh.spawn_workers(
                    sync_harness.engines_worker, n,
                    (store, "cpu", str(d / "in.npz"),
                     [CASES[n][k] for k in names], str(d), 60.0),
                    ranks=range(n), threads=1), timeout_s=180.0)
            finally:
                mesh.remove_store(store)
            outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
            cache[n] = leaves, names, outs
        return cache[n]
    return get


def _get(run, name, key):
    _leaves, names, outs = run
    c = names.index(name)
    return [o[f"{c}/{key}"] for o in outs]


def _stack(run, name, key="first"):
    """Per leaf of case ``name``, the [n, ...] stack of every rank's
    ``key{j}``."""
    n = len(run[2])
    return [np.stack(_get(run, name, f"{key}{j}"))
            for j in range(len(CASES[n][name]["leaves"]))]


def _slice_mesh(devices, s, w):
    return build_mesh({"slice": s, "data": w}, devices=devices[:s * w])


def _jax_tree(leaves):
    return {k: jnp.asarray(a) for k, a in zip(SHAPES, leaves)}


def _per_worker(leaves):
    return {k: jax.ShapeDtypeStruct(a.shape[1:], jnp.float32)
            for k, a in zip(SHAPES, leaves)}


def _t_shapes():
    return [(s, torch.float32) for s in SHAPES.values()]


# ----------------------------------------------------------------------
# the config: JAX's resolutions, and every refusal with JAX's message
# ----------------------------------------------------------------------

def _hier_cfg(cls, **kw):
    base = dict(model="mlp", dataset="mnist", epochs_local=1,
                epochs_global=2, batch_size=8, compute_dtype="float32",
                augment=False, aggregation_by="weights", topology="ring",
                num_slices=2, sync_bucket_mb=0.001)
    base.update(kw)
    return cls(**base)


def test_config_resolutions_are_jaxs():
    """``hier`` per topology, the per-level engines and wires, the
    shard-side apply, the resident default of weights x equal, the slice
    axis leading the mesh; one slice resolves the flat engine."""
    for topology in ("ring", "double_ring"):
        j, t = (_hier_cfg(c, topology=topology) for c in (JConfig, TConfig))
        assert t.resolve_sync_mode() == j.resolve_sync_mode("cpu") == "hier"
        assert (t.resolve_sync_levels() == j.resolve_sync_levels("cpu")
                == {"inner": "sharded", "outer": "gossip"})
        assert (t.resolve_opt_placement() == j.resolve_opt_placement("cpu")
                == "sharded")
        assert list(t.mesh_axes()) == list(j.mesh_axes())[:2] == [
            "slice", "data"]
    for kw, want in ((dict(sync_dtype="bfloat16"), ("bfloat16", "bfloat16")),
                     (dict(sync_dtype_outer="int8"), ("float32", "int8"))):
        for cls in (JConfig, TConfig):
            assert _hier_cfg(cls, **kw).resolve_sync_wire_dtypes() == want
    for kw, want in (({}, "resident"),
                     (dict(aggregation_type="weighted"), "replicated"),
                     (dict(aggregation_by="gradients"), "replicated")):
        assert (_hier_cfg(TConfig, **kw).resolve_param_residency(2)
                == _hier_cfg(JConfig, **kw).resolve_param_residency("cpu")
                == want)
    flat = _hier_cfg(TConfig, num_slices=1, topology="allreduce",
                     sync_mode="sharded")
    assert flat.resolve_sync_mode() == "sharded"
    assert _hier_cfg(TConfig).resolve_shard_redundancy(4) == "off"


@pytest.mark.parametrize("kw,match", [
    (dict(topology="allreduce"), "flat sharded allreduce"),
    (dict(sync_mode="dense"), "dense inner level has no"),
    (dict(chaos="kill@1:w0"), "chaos cannot combine"),
    (dict(chaos="random"), "chaos cannot combine"),
    (dict(shard_redundancy="buddy"), "buddy cannot combine"),
    (dict(opt_placement="replicated"), "opt_placement replicated"),
    (dict(num_slices=1, sync_dtype_outer="int8"), "requires --num_slices"),
    (dict(num_slices=0), "num_slices must be >= 1"),
    (dict(sync_staleness=1), "cannot pipeline"),
    (dict(mesh_shape="data=2,model=2"), "inner mesh axes"),
    (dict(mesh_shape="slice=2,data=2"), "driven by --num_slices"),
    (dict(sync_compression="ef"), "requires a compressed --sync_dtype"),
])
def test_config_refuses_what_jax_refuses(kw, match):
    """Each refusal of JAX's ``TestEagerValidation`` (and its checks of
    the slice count and staleness), with JAX's message, in both configs;
    the mesh checks run where JAX runs them (``mesh_axes``)."""
    for cls in (JConfig, TConfig):
        with pytest.raises(ValueError, match=match):
            _hier_cfg(cls, **kw).mesh_axes()


def test_ef_allowed_when_only_the_outer_wire_is_compressed():
    for cls in (JConfig, TConfig):
        cfg = _hier_cfg(cls, sync_dtype_outer="int8", sync_compression="ef")
        assert cfg.sync_compression == "ef"


def test_engine_refuses_one_worker_a_slice_and_arms_ef_per_level():
    """JAX's engine-time refusal of W = 1 (``train.py:581-587``) and its
    per-level EF arming (``TestHierEF.test_engine_arms_ef_per_level``),
    on an engine that never syncs (its lines are not used)."""
    group = mesh.Group(0, 4, torch.device("cpu"))

    def engine(s, **kw):
        grid = mesh.Grid({"slice": s, "data": 4 // s}, group,
                         {"slice": group, "data": group}, {})
        model = get_model("mlp", num_classes=10, hidden=8,
                          input_shape=(28, 28, 1))
        return LocalSGDEngine(model, _hier_cfg(TConfig, num_slices=s, **kw),
                              torch.device("cpu"), group, slices=grid)

    with pytest.raises(ValueError, match="workers per"):
        engine(4)
    for kw, want in ((dict(sync_dtype_outer="int8"), (False, True)),
                     (dict(sync_dtype="bfloat16"), (True, True)),
                     (dict(sync_dtype="bfloat16", sync_dtype_outer="float32"),
                      (True, False))):
        e = engine(2, sync_compression="ef", **kw)
        assert (e.sync_ef, e.sync_ef_outer) == want, kw
        assert not e.buddy_on and e.resident_on


def test_driver_refuses_an_elastic_snapshot_under_slices():
    with pytest.raises(ValueError, match="elastic_snapshot cannot"):
        t_driver.train_global(_hier_cfg(TConfig), elastic_snapshot=object(),
                              progress=False)


def test_hierarchical_sync_refuses_an_allreduce_outer_level():
    with pytest.raises(ValueError, match="outer topology"):
        comms.hierarchical_sync([torch.zeros(4)], inner_group=None,
                                outer_group=None, topology="allreduce")


# ----------------------------------------------------------------------
# the wire bytes: JAX's exact integers, and what the engine hands gloo
# ----------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["ring", "double_ring"])
@pytest.mark.parametrize("w", [2, 4])
def test_wire_bytes_are_jaxs_and_halve_and_quarter(topology, w):
    """``hier_wire_bytes`` equals JAX's for every wire pair; the DCN bytes
    are hops x padded/W per bucket; the bf16 and int8 outer wires send
    exactly 1/2 and 1/4 of fp32's DCN bytes and leave ICI as it was."""
    j_leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in SHAPES.values()]
    got = {}
    for name, jdt, tdt in (("f32", None, None),
                           ("bf16", jnp.bfloat16, torch.bfloat16),
                           ("int8", jnp.int8, torch.int8)):
        for inner_j, inner_t in ((None, None), (jnp.int8, torch.int8)):
            want = j_comms.hier_wire_bytes(
                j_leaves, w, topology=topology, wire_dtype=inner_j,
                outer_wire_dtype=jdt, bucket_bytes=TINY_BUCKET)
            have = comms.hier_wire_bytes(
                _t_shapes(), w, topology=topology, wire_dtype=inner_t,
                outer_wire_dtype=tdt, bucket_bytes=TINY_BUCKET)
            assert have == want, (name, inner_t)
            if inner_t is None:
                got[name] = have
    plan = comms.bucket_plan(_t_shapes(), w, TINY_BUCKET)
    hops = comms.GOSSIP_HOPS[topology]
    assert got["f32"]["dcn"] == hops * sum(b.padded // w * 4 for b in plan)
    assert got["bf16"]["dcn"] * 2 == got["f32"]["dcn"] == \
        got["int8"]["dcn"] * 4
    assert got["f32"]["ici"] == comms.sync_wire_bytes(
        _t_shapes(), w, mode="sharded", bucket_bytes=TINY_BUCKET)


@pytest.mark.parametrize("n", [4, 8])
def test_engine_hands_gloo_the_accounted_bytes_per_level(runs, n):
    """The inner line carries hier_wire_bytes' ICI (the reduce-scatter and
    the gather, 2(W-1)/W of each padded bucket), the outer line its DCN;
    the double ring's shift-2 hop over 2 slices is the slice's own payload,
    taken locally and so not handed to gloo."""
    run = runs(n)
    for name, case in CASES[n].items():
        if name.startswith("drift/") or case.get("residency"):
            continue
        s = case["slices"]
        wires = [comms.WIRE_DTYPES[case.get(k, "float32")]
                 for k in ("wire", "outer_wire")]
        want = comms.hier_wire_bytes(
            _t_shapes(), n // s, topology=case["topology"],
            wire_dtype=wires[0], outer_wire_dtype=wires[1],
            bucket_bytes=TINY_BUCKET)
        hops = comms._SHIFTS[case["topology"]]
        dcn = want["dcn"] * sum(1 for h in hops if h % s) // len(hops)
        for r, (ici, got) in enumerate(zip(_get(run, name, "wire_ici"),
                                           _get(run, name, "wire_dcn"))):
            assert (int(ici), int(got)) == (want["ici"], dcn), (name, r)


# ----------------------------------------------------------------------
# fp32: bitwise the dense twin, JAX's within 1e-6
# ----------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lo: f"{lo[0]}x{lo[1]}")
@pytest.mark.parametrize("topology", ["ring", "double_ring"])
@pytest.mark.parametrize("how", ["equal", "weighted"])
def test_fp32_bitwise_the_dense_twin_and_jaxs(runs, devices, layout,
                                              topology, how):
    """JAX's ``TestHierBitwise`` gate on the port: the bucketed engine
    bitwise its dense twin ``aggregate_hier`` on every rank; both within
    rtol=atol 1e-6 of JAX's bucketed engine and of JAX's twin (the two
    frameworks sum the slice in another order); the workers of a slice
    bitwise equal under the equal blend."""
    s, w = layout
    n = s * w
    run = runs(n)
    name = f"fp32/{s}x{w}/{topology}/{how}"
    got, twin = _stack(run, name), _stack(run, name, "twin")
    for j, (a, b) in enumerate(zip(got, twin)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf{j}")
    tree = _jax_tree(run[0][:len(SHAPES)])
    j_mesh = _slice_mesh(devices, s, w)
    j_ref = j_comms.make_hier_host_aggregator(
        j_mesh, topology=topology, how=how, local_weight=W)(tree)
    j_out = j_comms.make_hier_host_sync(
        j_mesh, topology=topology, how=how, local_weight=W,
        bucket_bytes=TINY_BUCKET)(tree)[0]
    for j, key in enumerate(SHAPES):
        np.testing.assert_allclose(got[j], np.asarray(j_out[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(twin[j], np.asarray(j_ref[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
        want = sync_harness.hier_reference(run[0][j], s, topology=topology,
                                           how=how, local_weight=W)
        np.testing.assert_allclose(got[j], want, rtol=RTOL, atol=ATOL)
        if how == "equal":
            rows = got[j].reshape(s, w, -1)
            assert (rows == rows[:, :1]).all(), key


def test_resident_rows_gather_to_the_replicated_output(runs):
    """The resident engine ends at the inner scatter: each slice's rows,
    gathered (``resident_to_tree``), are the replicated engine's output of
    that slice bit for bit, and each row is padded/W of its bucket."""
    s, w = 2, 4
    run = runs(s * w)
    rep = _stack(run, "fp32/2x4/ring/equal")
    template = comms.ParamsTemplate.of(
        list(SHAPES), [torch.zeros(sh) for sh in SHAPES.values()])
    plan = comms.bucket_plan(_t_shapes(), w, TINY_BUCKET)
    for g in range(s):
        rows = {comms.bucket_name(i): np.stack(
            _get(run, "resident/2x4", f"resident/{comms.bucket_name(i)}")
            [g * w:(g + 1) * w]) for i in range(len(plan))}
        for i, b in enumerate(plan):
            assert rows[comms.bucket_name(i)].shape == (w, b.padded // w)
        back = comms.resident_to_tree(rows, template=template,
                                      bucket_bytes=TINY_BUCKET)
        for j, a in enumerate(back):
            np.testing.assert_array_equal(a, rep[j][g * w], err_msg=str(j))


# ----------------------------------------------------------------------
# compressed wires and per-level error feedback
# ----------------------------------------------------------------------

def test_outer_ef_single_sync_drift_and_residual(runs, devices):
    """JAX's ``test_outer_ef_single_sync_drift_and_residual``: one bf16
    outer sync with its residual armed lands within (0, 0.05) of the fp32
    twin, and the new outer residual is not zero; against JAX's engine on
    the same inputs the output and the residual lie within one quantum of
    the outer stage (the frameworks' fp32 means may round a near-tie of
    the bf16 grid apart)."""
    s, w = 2, 4
    run = runs(s * w)
    got = _stack(run, "ef_bf16/2x4")
    twin = _stack(run, "fp32/2x4/ring/equal", "twin")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, twin))
    assert 0 < err < 0.05
    leaves = run[0][:len(SHAPES)]
    j_mesh = _slice_mesh(devices, s, w)
    ores = j_comms.hier_outer_residual_init(
        _per_worker(leaves), w, s * w, bucket_bytes=TINY_BUCKET)
    j_out, _res, j_ores = j_comms.make_hier_host_sync(
        j_mesh, topology="ring", outer_wire_dtype=jnp.bfloat16,
        bucket_bytes=TINY_BUCKET)(_jax_tree(leaves), None, ores)
    bounds = sync_harness.hier_bounds(
        leaves, s, topology="ring", how="equal", wire="float32",
        outer_wire="bfloat16", bucket_bytes=TINY_BUCKET)
    for j, key in enumerate(SHAPES):
        assert (np.abs(got[j] - np.asarray(j_out[key])) <= bounds[j]).all()
    nonzero = False
    for b, rows in jax.device_get(j_ores).items():
        mine = np.stack(_get(run, "ef_bf16/2x4", f"outer_res/{b}"))
        q = 2.0 ** -7 * np.abs(np.asarray(rows)).max() + 2.0 ** -8 * 60
        assert mine.shape == np.shape(rows)
        assert (np.abs(mine - np.asarray(rows)) <= q).all(), b
        nonzero |= bool(np.abs(mine).max() > 0)
    assert nonzero


@pytest.mark.parametrize("how", ["equal", "weighted"])
def test_int8_both_levels_within_a_quantum_of_fp32_and_jax(runs, devices,
                                                           how):
    """The int8 inner and outer wires (zero residuals in): every element
    within one quantum of each wire stage of the port's fp32 result
    (``sync_harness.hier_bounds``) and of JAX's int8 engine."""
    s, w = 2, 2
    run = runs(s * w)
    leaves = run[0][:len(SHAPES)]
    got = _stack(run, f"int8x2/2x2/{how}")
    fp32 = _stack(run, f"fp32/2x2/double_ring/{how}")
    bounds = sync_harness.hier_bounds(
        leaves, s, topology="double_ring", how=how, wire="int8",
        outer_wire="int8", bucket_bytes=TINY_BUCKET, local_weight=W)
    j_out = j_comms.make_hier_host_sync(
        _slice_mesh(devices, s, w), topology="double_ring", how=how,
        local_weight=W, wire_dtype=jnp.int8, outer_wire_dtype=jnp.int8,
        bucket_bytes=TINY_BUCKET)(_jax_tree(leaves))[0]
    for j, key in enumerate(SHAPES):
        assert (np.abs(got[j] - fp32[j]) <= bounds[j]).all(), key
        assert (np.abs(got[j] - np.asarray(j_out[key])) <= bounds[j]).all()
        assert np.abs(got[j] - fp32[j]).max() > 0, key


def test_outer_ef_time_average_tracks_fp32(runs):
    """JAX's ``test_outer_ef_time_average_tracks_fp32``: over 30 rounds of
    a drifting consensus (base ~50, steps of 0.01-0.03) on the int8 outer
    wire, the iterate with error feedback stays nearer the fp32 one than
    the uncompensated wire, whose rounding bias accumulates."""
    run = runs(4)
    ref = _stack(run, "drift/ref", "sum")[0] / EF_ROUNDS
    ef = _stack(run, "drift/ef", "sum")[0] / EF_ROUNDS
    raw = _stack(run, "drift/raw", "sum")[0] / EF_ROUNDS
    err_ef = float(np.abs(ef - ref).mean())
    err_raw = float(np.abs(raw - ref).mean())
    assert err_ef < err_raw, (err_ef, err_raw)
    res = _get(run, "drift/ef", "outer_res/b0000")
    assert any(np.abs(r).max() > 0 for r in res)


# ----------------------------------------------------------------------
# an engine round (driver.round_worker) against the dense twin and JAX
# ----------------------------------------------------------------------

N, STEPS, BATCH, LR = 4, 3, 4, 1e-4
ROUND_BUCKET = 1 << 14
METRICS = ("train_loss", "train_acc", "val_loss", "val_acc", "batch_losses",
           "global_train_loss", "global_val_loss")


def _round_kw(by: str, **kw):
    return dict(model="mlp", dataset="mnist", epochs_local=2,
                batch_size=BATCH, compute_dtype="float32", augment=False,
                aggregation_by=by, topology="ring", num_slices=2, lr=LR,
                sync_bucket_mb=ROUND_BUCKET / 2 ** 20, **kw)


@pytest.fixture(scope="module")
def hier_rounds(devices, tmp_path_factory):
    """One round of the mlp at 2 slices x 2 workers from JAX's init: the
    port's gradients run (its parameters are the pre-sync ones, and its
    ranks' dense twin of them), its weights run (replicated and resident),
    and JAX's weights round."""
    d = tmp_path_factory.mktemp("hier_round")
    train, _ = load_dataset("mnist", seed=0,
                            limit_train=2 * N * STEPS * BATCH, limit_test=1)
    x = train.images.reshape(2, N, STEPS, BATCH, *train.images.shape[1:])
    y = train.labels.reshape(2, N, STEPS, BATCH)
    m = np.ones((N, STEPS, BATCH), np.float32)
    train_pack, val_pack = (x[0], y[0], m), (x[1], y[1], m)
    engine = j_train.LocalSGDEngine(
        j_get_model("mlp", num_classes=10), _slice_mesh(devices, 2, 2),
        JConfig(**_round_kw("weights", param_residency="replicated")))
    state = engine.init_state(jax.random.key(0), train_pack[0][0, 0])
    variables0 = jax.device_get(engine.rank0_variables(state))
    state, j_mx = engine.round(state, train_pack, val_pack)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                weights.cnn_flax_to_torch(variables0).items()},
               d / "state.pt")
    np.savez(d / "packs.npz", x=train_pack[0], y=train_pack[1],
             m=train_pack[2], xv=val_pack[0], yv=val_pack[1], mv=val_pack[2])
    cfgs = [TConfig(device="cpu", **_round_kw(by, param_residency=res))
            for by, res in (("gradients", "auto"), ("weights", "replicated"),
                            ("weights", "resident"))]
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            t_driver.round_worker, N,
            (store, cfgs, 10, str(d / "state.pt"), str(d / "packs.npz"),
             str(d), 60.0), ranks=range(N), threads=1), timeout_s=180.0)
    finally:
        mesh.remove_store(store)
    port = [[torch.load(d / f"rank{r}-{i}.pt", weights_only=False)
             for r in range(N)] for i in range(len(cfgs))]
    return jax.device_get(state), jax.device_get(j_mx), port


def _params(state_dict):
    return {k: v for k, v in state_dict.items() if ".running_" not in k}


def test_weights_round_is_the_dense_twin_of_the_presync_parameters(
        hier_rounds):
    """JAX's ``test_weights_round_is_gossip_of_means_of_presync_params``:
    a gradients round leaves the parameters as trained, so the dense twin
    of them is what the weights round's sync must give, bit for bit, on
    every rank (replicated and resident layouts alike); the gradients
    round's aggregate norm is positive."""
    _j_state, _j_mx, (grads, rep, res) = hier_rounds
    for r in range(N):
        twin = grads[r]["hier_twin"]
        assert float(np.asarray(grads[r]["mx"]["agg_grad_norm"])
                     .ravel()[0]) > 0
        for run in (rep, res):
            got = _params(run[r]["state_dict"])
            assert set(got) == set(twin)
            for k in twin:
                assert torch.equal(got[k], twin[k]), (r, k)


def test_round_telemetry_carries_the_per_level_split(hier_rounds):
    """JAX's ``test_round_telemetry_carries_per_level_split``: the round's
    sync mode, and its wall attributed to the levels in proportion to
    ``hier_wire_bytes``."""
    _j_state, _j_mx, (_grads, rep, _res) = hier_rounds
    for r in range(N):
        stats = rep[r]["last_sync_stats"]
        assert stats["sync_mode"] == "hier"
        assert stats["sync_ms_ici"] + stats["sync_ms_dcn"] == pytest.approx(
            stats["sync_ms"], abs=2e-3)
        assert stats["sync_ms_ici"] == pytest.approx(
            2 * stats["sync_ms_dcn"], rel=1e-2, abs=2e-3)


def test_weights_round_matches_jaxs_engine_round(hier_rounds):
    """Against JAX's engine round on the 2 x 2 slice mesh from the same
    init: every metric at rtol 1e-4, every rank's parameters within 2 x lr
    x steps (test_torch_dist's bar); the resident layout's parameters
    bitwise the replicated layout's."""
    j_state, j_mx, (_grads, rep, res) = hier_rounds
    for key in METRICS:
        for r in range(N):
            np.testing.assert_allclose(rep[r]["mx"][key], np.asarray(
                j_mx[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    for r in range(N):
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[r],
                                      j_state.params)
        got = weights.cnn_torch_to_flax(
            {k: v.numpy() for k, v in _params(rep[r]["state_dict"]).items()}
        )["params"]
        for (kp, a), (_kp, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert np.abs(a - b).max() <= 2 * LR * 2 * STEPS, kp
        for k, v in _params(res[r]["state_dict"]).items():
            assert torch.equal(v, rep[r]["state_dict"][k]), k


# ----------------------------------------------------------------------
# checkpoints across slice layouts (JAX's TestHierCheckpoint)
# ----------------------------------------------------------------------

def _j_engine(devices, s, w, **kw):
    cfg = JConfig(**{**dict(model="mlp", dataset="mnist", epochs_local=1,
                            epochs_global=2, batch_size=8,
                            compute_dtype="float32", augment=False,
                            aggregation_by="weights", topology="ring",
                            num_slices=s, sync_bucket_mb=0.001), **kw})
    mesh_ = (_slice_mesh(devices, s, w) if s > 1
             else build_mesh({"data": w}, devices=devices[:w]))
    eng = j_train.LocalSGDEngine(j_get_model("mlp", num_classes=10,
                                             hidden=8), mesh_, cfg)
    x = np.zeros((1, 28, 28, 1), np.float32)
    return eng, eng.init_state(jax.random.key(0), x)


def _j_save(path, eng, st, num_slices):
    e = j_ckpt.CheckpointEngine(
        str(path), async_write=False,
        metadata={"sync_bucket_mb": eng.cfg.sync_bucket_mb,
                  "num_slices": num_slices,
                  "param_residency": eng.param_residency})
    e.save(eng.checkpoint_fence(st), 1)
    e.close()
    return e.latest_checkpoint()


def _perturbed(eng, st):
    """JAX's per-slice state: slice 1's resident rows moved by +1."""
    pr = {k: np.asarray(v).copy()
          for k, v in jax.device_get(st.params_resident).items()}
    for k in pr:
        pr[k][2:] += 1.0
    return eng.stage_state(jax.device_get(st).replace(params_resident=pr))


def _t_template(worker, n, *, resident=None, outer=None):
    """The port's template of worker ``worker`` of an ``n``-worker mlp
    (hidden 8) state: resident rows shaped like ``resident`` ({bucket:
    row length}) or replicated parameters; outer residual rows likewise."""
    model = get_model("mlp", num_classes=10, hidden=8,
                      input_shape=(28, 28, 1))
    engine = LocalSGDEngine(model, TConfig(device="cpu", model="mlp"),
                            torch.device("cpu"))
    ws = dataclasses.replace(
        engine.checkpoint_state(engine.init_state()), worker=worker,
        n_workers=n)
    if resident is not None:
        ws = dataclasses.replace(ws, params={}, params_resident={
            b: torch.zeros(k) for b, k in resident.items()})
    if outer is not None:
        ws = dataclasses.replace(ws, residual_outer={
            b: torch.zeros(k) for b, k in outer.items()})
    template = comms.ParamsTemplate.of(
        engine.names, engine.params,
        comms.WireLayout(*weights.wire_layout(model)))
    return ws, template


def _rows(st):
    return {k: np.asarray(v) for k, v in
            jax.device_get(st.params_resident).items()}


def test_manifest_records_the_slice_count(tmp_path):
    from learning_deep_neural_network_in_distributed_computing_environment_tpu.driver import (
        checkpoint_metadata as j_meta,
    )
    model = get_model("mlp", num_classes=10, hidden=8,
                      input_shape=(28, 28, 1))
    meta = t_driver.checkpoint_metadata(_hier_cfg(TConfig), 10, model)
    assert meta["num_slices"] == j_meta(_hier_cfg(JConfig), 10,
                                        False)["num_slices"] == 2


def test_same_layout_roundtrip_bitwise(devices, tmp_path):
    """A 2 x 2 resident checkpoint (JAX-written) restores into the port's
    resident template of every worker bit for bit, as JAX restores it."""
    eng, st = _j_engine(devices, 2, 2)
    path = _j_save(tmp_path, eng, st, 2)
    rows = _rows(st)
    for w in range(4):
        ws, template = _t_template(w, 4, resident={
            b: v.shape[1] for b, v in rows.items()})
        restored, epoch = t_ckpt.restore_checkpoint(
            path, ws, params_template=template, num_slices=2)
        assert epoch == 1
        for b, v in rows.items():
            np.testing.assert_array_equal(restored.params_resident[b], v[w])


def test_flat_resident_restores_into_the_slices(devices, tmp_path):
    """JAX's ``test_flat_resident_restores_into_hier_layout``: a flat
    4-worker resident checkpoint is one global consensus, and every slice
    of a 2 x 2 layout adopts it: the port's rows are JAX's re-layout, and
    each slice's rows gather to the flat consensus."""
    eng_f, st_f = _j_engine(devices, 1, 4, topology="allreduce",
                            sync_mode="sharded")
    path = _j_save(tmp_path / "flat", eng_f, st_f, 1)
    eng_h, st_h = _j_engine(devices, 2, 2)
    j_back, _ = j_ckpt.restore_checkpoint(
        path, st_h, params_template=eng_h.params_template,
        bucket_bytes=eng_h.sync_bucket_bytes, num_slices=2)
    want = _rows(j_back)
    for w in range(4):
        ws, template = _t_template(w, 4, resident={
            b: v.shape[1] for b, v in want.items()})
        restored, _ = t_ckpt.restore_checkpoint(
            path, ws, params_template=template, num_slices=2)
        for b, v in want.items():
            np.testing.assert_array_equal(restored.params_resident[b], v[w])


def test_distinct_slice_consensuses_refuse_a_recount(devices, tmp_path):
    eng, st = _j_engine(devices, 2, 2)
    path = _j_save(tmp_path, eng, _perturbed(eng, st), 2)
    eng_f, st_f = _j_engine(devices, 1, 4, topology="allreduce",
                            sync_mode="sharded")
    flat_rows = _rows(st_f)
    ws, template = _t_template(0, 4, resident={
        b: v.shape[1] for b, v in flat_rows.items()})
    with pytest.raises(ValueError, match="cannot re-shard"):
        t_ckpt.restore_checkpoint(path, ws, params_template=template,
                                  num_slices=1)
    with pytest.raises(ValueError, match="cannot re-shard"):
        j_ckpt.restore_checkpoint(path, st_f,
                                  params_template=eng_f.params_template,
                                  bucket_bytes=eng_f.sync_bucket_bytes,
                                  num_slices=1)


def test_slice_resident_restores_replicated_per_slice(devices, tmp_path):
    """JAX's ``test_hier_resident_restores_into_replicated_per_slice``:
    into a replicated template each worker gets its own slice's consensus
    (equal within a slice, the +1 across), as JAX restores it."""
    eng, st = _j_engine(devices, 2, 2)
    path = _j_save(tmp_path, eng, _perturbed(eng, st), 2)
    eng_r, st_r = _j_engine(devices, 2, 2, param_residency="replicated")
    j_back, _ = j_ckpt.restore_checkpoint(
        path, st_r, params_template=eng_r.params_template,
        bucket_bytes=eng_r.sync_bucket_bytes, num_slices=2)
    got = []
    for w in range(4):
        ws, template = _t_template(w, 4)
        restored, _ = t_ckpt.restore_checkpoint(
            path, ws, params_template=template, num_slices=2)
        assert restored.params_resident is None
        j_params = weights.cnn_flax_to_torch({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a)[w], jax.device_get(j_back.params))})
        for k, v in restored.params.items():
            np.testing.assert_array_equal(v, j_params[k], err_msg=k)
        got.append(restored.params)
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k])
        assert np.array_equal(got[2][k], got[3][k])
        assert not np.array_equal(got[0][k], got[2][k])


def test_serve_loads_slice0s_consensus(devices, tmp_path):
    """``main serve``'s loader takes slice 0's consensus from a slice
    resident checkpoint (the rank-0 convention; JAX
    ``test_serve_loads_slice0_consensus_from_hier_resident``)."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve.engine import (
        load_params_row0,
    )
    eng, st = _j_engine(devices, 2, 2)
    st = _perturbed(eng, st)
    path = _j_save(tmp_path, eng, st, 2)
    model = get_model("mlp", num_classes=10, hidden=8,
                      input_shape=(28, 28, 1))
    load_params_row0(path, model)
    want = weights.cnn_flax_to_torch(
        {"params": jax.device_get(eng.rank0_variables(st)["params"])})
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)


def test_missing_outer_residual_restores_zeros(devices, tmp_path):
    """A checkpoint without outer residual rows into an outer-EF template:
    zero rows, as JAX restores them; saved rows restore as they are."""
    eng, st = _j_engine(devices, 2, 2)
    path = _j_save(tmp_path / "plain", eng, st, 2)
    eng_ef, st_ef = _j_engine(devices, 2, 2, sync_dtype_outer="int8",
                              sync_compression="ef")
    outer = {b: np.asarray(v) for b, v in
             jax.device_get(st_ef.sync_residual_outer).items()}
    rows = _rows(st)
    ws, template = _t_template(3, 4, resident={
        b: v.shape[1] for b, v in rows.items()}, outer={
        b: v.shape[1] for b, v in outer.items()})
    restored, _ = t_ckpt.restore_checkpoint(path, ws,
                                            params_template=template,
                                            num_slices=2)
    for b, v in restored.residual_outer.items():
        assert v.shape == outer[b].shape[1:] and not np.abs(v).any()
    marked = {b: np.arange(v.size, dtype=np.float32).reshape(v.shape)
              for b, v in outer.items()}
    path = _j_save(tmp_path / "ef", eng_ef,
                   st_ef.replace(sync_residual_outer=marked), 2)
    restored, _ = t_ckpt.restore_checkpoint(path, ws,
                                            params_template=template,
                                            num_slices=2)
    for b, v in restored.residual_outer.items():
        np.testing.assert_array_equal(v, marked[b][3])
