"""Semi-synchronous rounds (``--sync_staleness K``) on two gloo processes,
the provenance records (``results["sync_engine"]``,
``results["async_rounds"]``), the sync flags' configuration, the port's
parser against every flag of the JAX package's, and the scenario lab's
MoE and remat under ``torch.func``.

Staleness: round R's sync runs on the engine's sync thread under round
R+1's compute, on a process group of its own, and its consensus delta is
folded in at the entry of round R+K+1; ``PORT_STALENESS_SERIAL`` runs
each sync to its end at dispatch (the same schedule, nothing overlapped),
and the overlapped run must equal that serial twin bit for bit (the
straggler feedback pinned, as JAX's gate pins it)."""

import argparse
import functools
import operator

import jax
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
    build_argparser as j_build_argparser,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.driver import (
    train_global as j_train_global,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.mesh import (
    build_mesh,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.sim import (
    SimEngine as JSimEngine,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    comms,
    driver as t_driver,
    mesh,
    train as t_train,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
    config_from_args,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model as t_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    remat as t_remat,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.sim import (
    SimEngine,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

KW = dict(model="mlp", dataset="mnist", epochs_local=1, batch_size=16,
          limit_train_samples=256, limit_eval_samples=32, probe_batches=1,
          compute_dtype="float32", augment=False, aggregation_by="weights",
          proportionality="uniform", seed=0)
SIMS = [1.0, 1.0]
WALLS = [[0.5, 0.5]] * 6


def _group_run(cfg):
    """``train_global`` on two gloo processes (rank 0 here) with the
    probe and the round walls pinned; rank 0's results."""
    kw = dict(simulated_durations=SIMS, progress=False,
              simulated_round_durations=functools.partial(
                  operator.getitem, WALLS))
    store = mesh.new_store_path()
    procs = mesh.spawn_workers(t_driver.train_rank, 2, (store, 60.0, cfg, kw))
    try:
        res = t_driver.train_rank(0, 2, store, 60.0, cfg, kw)
        mesh.join_workers(procs, timeout_s=120.0)
    finally:
        mesh.stop_workers(procs)
        mesh.remove_store(store)
    return res


_RUNS: dict = {}


def _run(monkeypatch, serial=False, **over):
    key = (serial,) + tuple(sorted(over.items()))
    if key not in _RUNS:
        if serial:
            monkeypatch.setenv(t_train.STALENESS_SERIAL_ENV, "1")
        try:
            _RUNS[key] = _group_run(Config(device="cpu", **{**KW, **over}))
        finally:
            monkeypatch.delenv(t_train.STALENESS_SERIAL_ENV, raising=False)
    return _RUNS[key]


def _bitwise(a, b):
    return (a["all_workers_losses"] == b["all_workers_losses"]
            and a["global_val_losses"] == b["global_val_losses"]
            and a["param_checksums"] == b["param_checksums"])


# ----------------------------------------------------------------------
# the delivery helpers
# ----------------------------------------------------------------------

def _tree(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 5, 3)).astype(np.float32),
            rng.normal(size=(n, 7)).astype(np.float32)]


def test_stale_delta_and_deliver_are_exact():
    base, blend, later = _tree(0), _tree(1), _tree(2)
    d = comms.stale_delta([torch.from_numpy(a) for a in blend],
                          [torch.from_numpy(a) for a in base])
    j_d = j_comms.stale_delta(blend, base)
    for got, b, t, w in zip(d, blend, base, j_d):
        np.testing.assert_array_equal(got.numpy(), b - t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    out = comms.deliver_stale([torch.from_numpy(a) for a in later], d)
    for got, p, dd in zip(out, later, d):
        np.testing.assert_array_equal(got.numpy(), p + dd.numpy())


def test_two_worker_delayed_schedule_is_the_numpy_schedule():
    """JAX's K=1 schedule in numpy (round R's delta folds in at round
    R+2's entry, the rest at the drain), through the port's helpers."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(2, 4)).astype(np.float32)
    steps = [rng.normal(size=(2, 4)).astype(np.float32) for _ in range(3)]

    def schedule(delta_fn, deliver_fn):
        p, pending = p0.copy(), []
        for s in steps:
            if len(pending) > 1:
                p = deliver_fn(p, pending.pop(0))
            t = p + s
            blend = np.broadcast_to((t[0] + t[1]) / 2.0, t.shape)
            pending.append(delta_fn(blend, t))
            p = t
        while pending:
            p = deliver_fn(p, pending.pop(0))
        return p

    ref = schedule(lambda b, t: b - t, lambda p, d: p + d)
    got = schedule(
        lambda b, t: comms.stale_delta([torch.from_numpy(b.copy())],
                                       [torch.from_numpy(t)])[0].numpy(),
        lambda p, d: comms.deliver_stale([torch.from_numpy(p)],
                                         [torch.from_numpy(d)])[0].numpy())
    np.testing.assert_array_equal(ref, got)


# ----------------------------------------------------------------------
# K = 1 and K = 2 against the serial twin; K past the run's end
# ----------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(sync_staleness=1, epochs_global=3, sync_dtype="int8",
         sync_compression="ef"),
    dict(sync_staleness=2, epochs_global=4, topology="double_ring",
         aggregation_type="weighted", local_weight=0.7,
         sync_dtype="bfloat16", sync_compression="ef"),
], ids=["k1-sharded-int8-ef", "k2-gossip-bf16-ef"])
def test_overlapped_rounds_equal_the_serial_twin(monkeypatch, over):
    ovl = _run(monkeypatch, **over)
    ser = _run(monkeypatch, serial=True, **over)
    assert _bitwise(ovl, ser)
    k, rounds = over["sync_staleness"], over["epochs_global"]
    ar = ovl["async_rounds"]
    assert ar["enabled"] and ar["staleness"] == k
    assert ar["delivered"] == rounds           # in the loop and the drain
    assert ar["sync_ms_total"] >= ar["sync_hidden_ms_total"] >= 0.0
    assert ser["async_rounds"]["sync_hidden_ms_total"] == 0.0
    rows = ovl["round_timings"]
    # rows 0..K carry no delivery yet; row K+1 carries round 0's walls
    assert all(r["sync_hidden_ms"] == 0.0 and r["sync_ms"] == 0.0
               for r in rows[:k + 1])
    assert rows[k + 1]["sync_ms"] > 0.0
    assert {r["sync_mode"] for r in rows} == {ovl["sync_engine"]["mode"]}


def test_k_beyond_the_run_is_a_pure_drain(monkeypatch):
    over = dict(sync_staleness=5, epochs_global=2)
    res = _run(monkeypatch, **over)
    assert res["async_rounds"]["delivered"] == 2
    assert all(r["sync_ms"] == 0.0 for r in res["round_timings"])
    assert _bitwise(res, _run(monkeypatch, serial=True, **over))


# ----------------------------------------------------------------------
# the records: JAX's keys (one JAX run serves every comparison)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(devices):
    return j_train_global(
        JConfig(**{**KW, "epochs_global": 2, "sync_staleness": 1}),
        mesh=build_mesh({"data": 2}, devices[:2]), simulated_durations=SIMS,
        simulated_round_durations=functools.partial(operator.getitem,
                                                    WALLS),
        progress=False)


def test_records_have_jaxs_keys(monkeypatch, jax_run):
    """``results["sync_engine"]`` (and its state-bytes row) on a one-worker
    run, a 2-process run and a lab run; ``results["async_rounds"]`` with
    and without staleness."""
    j_keys = set(jax_run["sync_engine"])
    j_bytes = set(jax_run["sync_engine"]["per_worker_state_bytes"])
    one = t_driver.train_global(
        Config(device="cpu", **{**KW, "epochs_global": 1}),
        simulated_durations=[1.0], progress=False)
    two = _run(monkeypatch, sync_staleness=5, epochs_global=2)
    lab = t_driver.train_global(
        Config(device="cpu", **{**KW, "epochs_global": 1,
                                "sim_workers": 2}),
        simulated_durations=SIMS, progress=False)
    for res in (one, two, lab):
        assert set(res["sync_engine"]) == j_keys
        assert set(res["sync_engine"]["per_worker_state_bytes"]) == j_bytes
    assert set(two["async_rounds"]) == set(jax_run["async_rounds"])
    assert one["async_rounds"] == {"enabled": False}
    assert (one["sync_engine"]["mode"], one["sync_engine"]["levels"]) == (
        "dense", {"inner": "dense", "outer": None})
    assert two["sync_engine"]["sync_bytes_ici"] > 0
    assert two["sync_engine"]["param_residency"] == "replicated"


def test_sharded_engine_state_bytes(monkeypatch):
    """The round optimizer's per-worker bytes under the sharded placement
    are 1/N of the replicated placement's (the padded vector); the EF
    residual is the parameters' size."""
    eng = {}
    for placement in ("sharded", "replicated"):
        cfg = Config(device="cpu", **{**KW, "aggregation_by": "gradients",
                                      "sync_mode": "sharded",
                                      "opt_placement": placement})
        model = t_get_model("mlp", num_classes=10, input_shape=(28, 28, 1))
        group = mesh.Group(0, 2, torch.device("cpu"))
        engine = t_train.LocalSGDEngine(model, cfg, torch.device("cpu"),
                                        group)
        eng[placement] = engine.state_resident_bytes(engine.init_state())
    assert eng["sharded"]["round_opt"] * 2 == eng["replicated"]["round_opt"]
    cfg = Config(device="cpu", **{**KW, "sync_dtype": "int8",
                                  "sync_compression": "ef"})
    model = t_get_model("mlp", num_classes=10, input_shape=(28, 28, 1))
    engine = t_train.LocalSGDEngine(model, cfg, torch.device("cpu"))
    b = engine.state_resident_bytes(engine.init_state())
    assert b["ef_residual"] == b["params"] and b["round_opt"] == 0


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(sync_staleness=-1), "sync_staleness must be"),
    (dict(sync_staleness=1, aggregation_by="weights", sim_workers=8),
     "use --sim_staleness"),
    (dict(sync_staleness=1, aggregation_by="gradients"),
     "nothing to deliver late"),
    (dict(sync_staleness=1, aggregation_by="weights", chaos="random"),
     "NO consensus is\\s+in flight"),
    (dict(sync_staleness=1, aggregation_by="weights", num_slices=2,
          topology="ring"), "cannot pipeline"),
    (dict(sync_staleness=1, aggregation_by="weights",
          param_residency="resident"), "entry gather DEPEND"),
    (dict(sync_staleness=1, aggregation_by="weights",
          shard_redundancy="buddy"), "nothing is uniquely held"),
    (dict(sync_staleness=1, aggregation_by="weights",
          stream_chunk_steps=2), "already\\s+overlaps"),
    (dict(sync_staleness=1, aggregation_by="weights",
          checkpoint_dir="/tmp/x"), "in-flight\\s+consensus"),
    (dict(sync_dtype="bfloat16", sync_mode="dense"),
     "cannot combine with --sync_mode dense"),
    (dict(opt_placement="sharded", sync_mode="dense"),
     "bucketed-sync-engine"),
    (dict(opt_placement="replicated", sync_dtype="int8"),
     "scale-then-encode"),
    (dict(sync_compression="ef"), "requires a compressed --sync_dtype"),
    (dict(sync_bucket_mb=0.0), "sync_bucket_mb must be positive"),
])
def test_jaxs_rejections_hold(kw, match):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError, match=match):
            cfg_cls(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(sync_dtype="int8"), dict(opt_placement="sharded"),
    dict(sync_mode="sharded"), dict(sync_mode="sharded", topology="ring"),
    dict(sync_dtype="bfloat16", topology="double_ring"),
    dict(sync_mode="dense", opt_placement="replicated"),
    dict(opt_placement="sharded", topology="ring")])
def test_resolutions_are_jaxs_off_a_tpu(kw):
    """``auto`` keeps the dense path unless a compressed wire or the
    sharded placement asks for the fast engine, as JAX resolves it on a
    CPU; the port resolves residency to replicated."""
    j, t = JConfig(**kw), Config(**kw)
    assert t.resolve_sync_mode() == j.resolve_sync_mode("cpu")
    assert t.resolve_sync_levels() == j.resolve_sync_levels("cpu")
    assert t.resolve_opt_placement() == j.resolve_opt_placement("cpu")
    assert t.resolve_param_residency() == "replicated"


def _flag_argv(action) -> list[str]:
    flag = action.option_strings[0]
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction)):
        return [flag]
    if action.default is None:
        return [flag, action.choices[0]] if action.choices else []
    return [flag, str(action.default)]


def _jax_config(argv):
    """JAX's ``config_from_args`` without its side effects (platform pin,
    compile cache): the parse, then ``Config``."""
    args = j_build_argparser().parse_args(argv)
    fields = set(JConfig.__dataclass_fields__)
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw.update(augment=not args.no_augment,
              overlap_rounds=not args.no_overlap_rounds,
              ckpt_async=args.ckpt_async == "on")
    return JConfig(**kw)


@pytest.mark.parametrize("action", [
    a for a in j_build_argparser()._actions
    if a.option_strings and not isinstance(a, argparse._HelpAction)],
    ids=lambda a: a.option_strings[0])
def test_every_jax_flag_parses_in_the_port(action):
    """Each flag of the JAX parser, at its default (store_true flags
    given): the port takes it, or refuses it naming its ROADMAP queue, or
    refuses it as JAX's config does — never argparse's exit."""
    argv = [] if action.dest == "device" else _flag_argv(action)
    try:
        cfg = config_from_args(["--device", "cpu", *argv])
    except SystemExit as e:        # pragma: no cover - the failure shown
        pytest.fail(f"{argv}: argparse exited with {e.code}")
    except ValueError as e:
        if "ROADMAP" not in str(e):
            with pytest.raises(ValueError):
                _jax_config(argv)
    else:
        assert isinstance(cfg, Config)


def test_sync_flags_parse_and_the_dead_cache_flag_is_a_no_op(tmp_path,
                                                             monkeypatch):
    cfg = config_from_args([
        "--device", "cpu", "--sync_mode", "sharded", "--sync_dtype", "int8",
        "--sync_compression", "ef", "--sync_bucket_mb", "0.5",
        "--opt_placement", "sharded", "--sync_staleness", "1",
        "--aggregation_by", "weights", "--compile_cache_dir", "/tmp/c"])
    assert (cfg.sync_mode, cfg.sync_dtype, cfg.sync_compression,
            cfg.sync_bucket_mb, cfg.opt_placement, cfg.sync_staleness) == (
        "sharded", "int8", "ef", 0.5, "sharded", 1)
    # the round pipeline's flags are ported: they parse, and a run takes
    # the serial flow (no prep or metric thread), runs sanitized and
    # writes the trace
    cfg = config_from_args([
        "--device", "cpu", "--model", "mlp", "--dataset", "mnist",
        "--epochs_global", "2", "--epochs_local", "1", "--batch_size", "16",
        "--limit_train_samples", "96", "--limit_eval_samples", "16",
        "--probe_batches", "1", "--no_overlap_rounds", "--sanitize",
        "--profile_dir", str(tmp_path)])
    assert (cfg.overlap_rounds, cfg.sanitize, cfg.profile_dir) == (
        False, True, str(tmp_path))
    pools = []
    real_pool = t_driver.ThreadPoolExecutor

    def spy(*args, **kw):
        pools.append(kw.get("thread_name_prefix"))
        return real_pool(*args, **kw)

    monkeypatch.setattr(t_driver, "ThreadPoolExecutor", spy)
    res = t_driver.train_global(cfg, progress=False)
    assert pools == [] and len(res["round_timings"]) == 2
    assert res["sanitize"]["enabled"] is True
    assert res["sanitize"]["transfer_guard_violations"] == 0
    assert (tmp_path / "trace_rank0.json").is_file()
    t_driver.train_global(config_from_args([
        "--device", "cpu", "--model", "mlp", "--dataset", "mnist",
        "--epochs_global", "2", "--epochs_local", "1", "--batch_size", "16",
        "--limit_train_samples", "96", "--limit_eval_samples", "16",
        "--probe_batches", "1"]), progress=False)
    assert pools == ["round-prep", "round-metrics"]   # the default flow


# ----------------------------------------------------------------------
# the lab under torch.func: MoE and remat
# ----------------------------------------------------------------------

def _bert_packs(n, steps=2, b=4, length=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(5, 128, (n, steps, b, length)).astype(np.int32)
    y = np.where(rng.random((n, steps, b, length)) < 0.2, x, -100)
    m = np.ones((n, steps, b), np.float32)
    return x, y.astype(np.int32), m


def test_sim_moe_round_matches_jax_lab(devices):
    """``bert_tiny --num_experts 2`` under ``--sim_workers 2``: one round
    of the port's lab against JAX's from JAX's init, fp32: the metrics
    (the CE plus the Switch aux loss) at rtol 1e-4, the parameters within
    2 lr per Adam step."""
    kw = dict(model="bert_tiny", dataset="synthetic_mlm", epochs_local=1,
              batch_size=4, compute_dtype="float32", augment=False,
              aggregation_by="weights", num_experts=2, lr=1e-4,
              sim_workers=2, seed=0)
    j_model = j_get_model("bert_tiny", num_classes=128, num_experts=2)
    j_eng = JSimEngine(j_model, build_mesh({"data": 1}, devices[:1]),
                       JConfig(**kw))
    packs = (_bert_packs(2), _bert_packs(2, seed=1))
    j_state = j_eng.init_state(jax.random.key(0), packs[0][0][0, 0])
    params = jax.device_get(j_eng.rank0_variables(j_state))["params"]
    model = t_get_model("bert_tiny", num_classes=128, num_experts=2)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.flax_to_torch(params).items()})
    t_eng = SimEngine(model, Config(device="cpu", **kw),
                      torch.device("cpu"))
    t_state, t_mx = t_eng.round(t_eng.init_state(), *packs)
    j_state, j_mx = jax.device_get(j_eng.round(j_state, *packs))
    for key in ("train_loss", "batch_losses", "val_loss", "val_acc"):
        np.testing.assert_allclose(t_mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    for i in range(2):
        got = {k: p[i].numpy() for k, p in zip(t_eng.names,
                                               t_state.params)}
        want = weights.flax_to_torch(jax.tree_util.tree_map(
            lambda a: np.asarray(a)[i], j_state.params))
        for k, v in want.items():
            assert np.abs(got[k] - v).max() <= 2 * 1e-4 * 2, k


@pytest.mark.parametrize("policy", [
    "everything", "dots_saveable", "save_names:attn_out,block_out",
    "offload_names:mlp_out"])
def test_sim_remat_policies_are_bitwise_none(monkeypatch, policy):
    """Under the lab every remat policy recomputes each block through
    ``models.remat.recompute`` (``torch.utils.checkpoint``'s saved-tensor
    hooks are refused by ``torch.func``), and the round is bitwise the
    ``none`` round: losses, parameters and moments."""
    calls = []
    real = t_remat.recompute
    monkeypatch.setattr(t_remat, "recompute",
                        lambda *a: calls.append(1) or real(*a))
    packs = (_bert_packs(2), _bert_packs(2, seed=1))
    out = {}
    for pol in ("none", policy):
        cfg = Config(device="cpu", model="gpt_tiny", dataset="synthetic_lm",
                     epochs_local=1, batch_size=4, compute_dtype="float32",
                     augment=False, aggregation_by="weights", sim_workers=2,
                     remat_policy=pol)
        model = t_driver.build_model_for(cfg, 128, torch.device("cpu"))
        eng = SimEngine(model, cfg, torch.device("cpu"))
        state, mx = eng.round(eng.init_state(), *packs)
        out[pol] = (mx["batch_losses"], state.params, state.opt.mu)
    assert calls, "the recompute path never ran"
    (l0, p0, m0), (l1, p1, m1) = out["none"], out[policy]
    np.testing.assert_array_equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
