"""The port's scenario lab (``..._torch/sim.py``, ``--sim_workers N``) on
the CPU, held against the JAX package's ``sim.py`` and ``comms.py`` on
numpy inputs made from a seed, and against the port's own N-process run.

- comms: ``aggregate_sim`` in all 12 modes (6 blends x gradients|weights)
  at N = 2, 3, 8, with participation masks, the all-ones mask, and the
  bf16/int8 simulated wire with error feedback over 3 rounds;
  ``sim_fold``; ``sim_wire_bytes``; the staleness delta;
- the scenario draws and the lr jitter against JAX ``SimEngine``'s;
- one ``SimEngine`` round against JAX ``SimEngine``'s (mlp in weights and
  gradients mode; a BatchNorm model with its statistics);
- ``train_global`` against JAX's at ``--sim_workers 8`` (one topology per
  case, as JAX keeps in tier-1) and with ``--sim_staleness 1``; and at 2
  workers against the port's own 2-process gloo run;
- the JAX scenario semantics, the vmap rules of the flash ops (fused
  included) and of the loss, the stacked Adam, BatchNorm's statistics as
  outputs, the probe's tiling, and every refusal.

Each test states its tolerance.  Where the port and JAX differ in fp32
only by XLA's FMA contraction (``w*x + (1-w)*m`` fused) or by the order of
a sum, the tolerance is stated in units of the inputs' largest magnitude.
"""

import functools
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    comms as j_comms,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    train as j_train,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
    Config as JConfig,
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
    comms as t_comms,
    driver as t_driver,
    main as t_main,
    mesh,
    probe as t_probe,
    train as t_train,
    viz as t_viz,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model as t_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.norm import (
    BatchNorm,
    running_stats_out,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.ops import (
    flash as t_flash,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.sim import (
    SimEngine,
)

N = 8
TOPOS = ("allreduce", "ring", "double_ring")
HOWS = ("equal", "weighted")
MODES = [(h, t) for h in HOWS for t in TOPOS]
CPU = torch.device("cpu")
KEYS = ("a", "b", "c")


@pytest.fixture(autouse=True, scope="module")
def _fixed_threads():
    """Two intra-op threads: the suite runs beside other test processes,
    and a fixed count fixes the CPU kernels' reduction order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _stacked(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (13, 7), "b": (257,), "c": (3,)}
    return {k: (rng.normal(size=(n, *shapes[k])) * scale).astype(np.float32)
            for k in KEYS}


def _jax_agg(tree, **kw):
    res = kw.pop("residual", None)
    ok = kw.pop("ok", None)
    out, new_res = jax.jit(functools.partial(
        j_comms.aggregate_sim, **kw,
        ok=None if ok is None else jnp.asarray(ok)))(
            {k: jnp.asarray(v) for k, v in tree.items()},
            residual=(None if res is None
                      else {k: jnp.asarray(v) for k, v in res.items()}))
    return ({k: np.asarray(out[k]) for k in KEYS},
            None if new_res is None
            else {k: np.asarray(new_res[k]) for k in KEYS})


def _port_agg(tree, **kw):
    res = kw.pop("residual", None)
    ok = kw.pop("ok", None)
    wire = kw.pop("wire_dtype", None)
    out, new_res = t_comms.aggregate_sim(
        [torch.from_numpy(tree[k]) for k in KEYS], **kw,
        ok=None if ok is None else torch.from_numpy(ok),
        wire_dtype=None if wire is None else getattr(torch, wire),
        residual=(None if res is None
                  else [torch.from_numpy(res[k]) for k in KEYS]))
    return ({k: o.numpy() for k, o in zip(KEYS, out)},
            None if new_res is None
            else {k: r.numpy() for k, r in zip(KEYS, new_res)})


def _ulps(tree, k=2):
    """k fp32 ulps of the largest input magnitude: the most one rounding
    step (an FMA XLA contracts, a reciprocal it multiplies by) moves an
    output built from these inputs."""
    return k * 2.0 ** -23 * max(float(np.abs(v).max()) for v in tree.values())


# ----------------------------------------------------------------------
# comms: the stacked sync against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("by", ["gradients", "weights"])
@pytest.mark.parametrize("how,topology", MODES)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_aggregate_sim_matches_jax_in_all_12_modes(n, how, topology, by):
    """The 12 modes: one blend serves gradients (small values) and weights
    (large).  Equal blends bitwise; weighted blends at rtol 1e-6 plus 2
    ulps of the largest input, since XLA contracts ``w*x + (1-w)*m`` into
    an FMA (JAX ``comms.py:204-212``) where torch rounds each product."""
    tree = _stacked(n, seed=n, scale=1e-3 if by == "gradients" else 100.0)
    kw = dict(how=how, topology=topology, local_weight=0.3)
    want, res_j = _jax_agg(tree, **kw)
    got, res_t = _port_agg(tree, **kw)
    assert res_j is None and res_t is None
    for k in KEYS:
        assert got[k].shape == tree[k].shape and got[k].dtype == np.float32
        if how == "equal":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=_ulps(tree), err_msg=k)


@pytest.mark.parametrize("how,topology", MODES)
@pytest.mark.parametrize("mask", ["partial", "all_ones"])
@pytest.mark.parametrize("n", [3, 8])
def test_aggregate_sim_masks_match_jax(n, mask, how, topology):
    """Participation masks renormalize the blends over the survivors as
    JAX's do: rtol 2e-6 plus 2 ulps of the largest input (JAX's own
    tolerance for its masked twin, ``test_sim.py:161-179``).  In the port
    an all-ones mask selects the unmasked values bitwise."""
    tree = _stacked(n, seed=10 + n)
    ok = (np.ones(n, np.float32) if mask == "all_ones"
          else (np.arange(n) % 3 != 1).astype(np.float32))
    kw = dict(how=how, topology=topology, local_weight=0.3)
    want, _ = _jax_agg(tree, ok=ok, **kw)
    got, _ = _port_agg(tree, ok=ok, **kw)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6,
                                   atol=_ulps(tree), err_msg=k)
    if mask == "all_ones":
        plain, _ = _port_agg(tree, **kw)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


@pytest.mark.parametrize("how,topology", MODES)
@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_compressed_wire_with_ef_over_three_rounds_matches_jax(
        wire, how, topology):
    """The simulated wire at N=8: three syncs, each fed the last one's
    output and EF residual, with a partial mask on the third.  bf16 at
    rtol 1e-5 plus 4 ulps of the largest input; int8 at one quantization
    step (max |x| / 127) plus the same, since a 1-ulp difference from an
    XLA contraction can move a value across a rounding boundary of the
    int8 grid, and the residual carries it on."""
    tree = _stacked(N, seed=21)
    res_j = res_t = {k: np.zeros_like(v) for k, v in tree.items()}
    xj = xt = tree
    ok = (np.arange(N) % 4 != 2).astype(np.float32)
    for r in range(3):
        kw = dict(how=how, topology=topology, local_weight=0.3,
                  ok=ok if r == 2 else None)
        xj, res_j = _jax_agg(xj, wire_dtype=jnp.dtype(wire),
                             residual=res_j, **dict(kw))
        xt, res_t = _port_agg(xt, wire_dtype=wire, residual=res_t,
                              **dict(kw))
    step = (max(float(np.abs(v).max()) for v in tree.values()) / 127.0
            if wire == "int8" else 0.0)
    for k in KEYS:
        np.testing.assert_allclose(xt[k], xj[k], rtol=1e-5,
                                   atol=step + _ulps(tree, 4), err_msg=k)
        np.testing.assert_allclose(res_t[k], res_j[k], rtol=1e-5,
                                   atol=step + _ulps(tree, 4), err_msg=k)
    assert any(np.abs(res_t[k]).max() > 0 for k in KEYS)


def test_sim_fold_is_the_row_ordered_sum():
    """``sim_fold`` and ``sim_fold_rows`` are ((x0 + x1) + x2) + ...,
    bitwise (``functools.reduce``), and equal JAX's ``sim_fold`` bitwise;
    a reassociating sum would not be."""
    tree = _stacked(N, seed=3, scale=1e3)
    rows = [torch.from_numpy(tree[k]) for k in KEYS]
    folded = t_comms.sim_fold_rows(rows)
    for k, x, f in zip(KEYS, rows, folded):
        want = functools.reduce(operator.add, list(x))
        assert torch.equal(t_comms.sim_fold(x), want)
        assert torch.equal(f, want)
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(jax.jit(j_comms.sim_fold)(tree[k])))


@pytest.mark.parametrize("topology", TOPOS)
def test_sim_wire_bytes_equal_jax(topology):
    """The per-worker bytes of the simulated fabric, exactly JAX's."""
    tree = _stacked(N)
    shapes = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
              for k, v in tree.items()}
    port = [(v.shape[1:], torch.float32) for v in tree.values()]
    for n in (1, 2, N):
        for jw, tw in ((None, None), (jnp.bfloat16, torch.bfloat16),
                       (jnp.int8, torch.int8)):
            assert t_comms.sim_wire_bytes(
                port, n, topology=topology, wire_dtype=tw) == \
                j_comms.sim_wire_bytes(shapes, n, topology=topology,
                                       wire_dtype=jw)


def test_stale_delta_and_delivery_equal_jax():
    """``stale_delta`` / ``deliver_stale``: elementwise, bitwise JAX's."""
    a, b = _stacked(N, seed=4), _stacked(N, seed=5)
    d_j = j_comms.stale_delta(a, b)
    d_t = t_comms.stale_delta([torch.from_numpy(a[k]) for k in KEYS],
                              [torch.from_numpy(b[k]) for k in KEYS])
    p_t = t_comms.deliver_stale([torch.from_numpy(b[k]) for k in KEYS], d_t)
    p_j = j_comms.deliver_stale(b, d_j)
    for i, k in enumerate(KEYS):
        np.testing.assert_array_equal(d_t[i].numpy(), np.asarray(d_j[k]))
        np.testing.assert_array_equal(p_t[i].numpy(), np.asarray(p_j[k]))


# ----------------------------------------------------------------------
# engines: the scenario draws, one round against JAX SimEngine
# ----------------------------------------------------------------------

def _kw(**over):
    """JAX ``tests/test_sim.py:73-80``'s ``base_kw`` (without its JAX-only
    keys)."""
    base = dict(model="mlp", dataset="mnist", epochs_global=2,
                epochs_local=1, batch_size=16, limit_train_samples=400,
                limit_eval_samples=100, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=1)
    base.update(over)
    return base


def _mlp(hidden=16):
    model = t_get_model("mlp", num_classes=10, hidden=hidden,
                        input_shape=(28, 28, 1))
    model.init_parameters(torch.Generator().manual_seed(0))
    return model


def _mesh1(devices):
    return build_mesh({"data": 1}, devices[:1])


@pytest.mark.parametrize("scenario", [
    dict(sim_sample_frac=0.5, sim_dropout=0.2, sim_byzantine="noise:2:0.5",
         sim_lr_jitter=0.3),
    dict(sim_dropout=0.45, sim_byzantine="signflip:1"),
    dict(sim_sample_frac=0.3)], ids=["all", "dropout", "sampling"])
def test_scenario_draws_and_lr_scale_equal_jax(devices, scenario):
    """Five rounds of draws (participants, drop-outs, noise keys) and the
    lr scale, exactly JAX ``SimEngine``'s: the same numpy streams in the
    same order."""
    kw = _kw(epochs_global=5, sim_workers=N, **scenario)
    j_eng = JSimEngine(j_get_model("mlp", num_classes=10, hidden=16),
                       _mesh1(devices), JConfig(**kw))
    t_eng = SimEngine(_mlp(), Config(device="cpu", **kw), CPU)
    assert t_eng.scenario_on and j_eng.scenario_on
    for _ in range(5):
        a_j, d_j, k_j = j_eng._draw_scenario()
        a_t, d_t, k_t = t_eng._draw_scenario()
        np.testing.assert_array_equal(a_t, a_j > 0)
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_array_equal(k_t, k_j)
    if "sim_lr_jitter" in scenario:
        np.testing.assert_array_equal(t_eng.lr_scale, j_eng.lr_scale)
    np.testing.assert_array_equal(t_eng.byzantine_rows(), j_eng._byz_mask())


def _packs(n, steps=4, b=8, seed=0, shape=(28, 28, 1)):
    """JAX ``test_sim.py:315-320``'s packs; the last worker's last step is
    half padding and its first step all padding (a gated row)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, steps, b, *shape)).astype(np.float32)
    y = rng.integers(0, 10, (n, steps, b)).astype(np.int32)
    m = np.ones((n, steps, b), np.float32)
    m[-1, -1, b // 2:] = 0.0
    m[-1, 0] = 0.0
    return x, y, m


METRICS = ("train_loss", "train_acc", "val_loss", "val_acc", "batch_losses",
           "batch_mask", "avg_acc", "global_train_loss", "global_train_acc",
           "global_val_loss", "global_val_acc", "agg_grad_norm")


def _round_pair(devices, model, j_model, kw, n, packs, rounds=2):
    """JAX SimEngine and the port's SimEngine from JAX's init on the same
    packs for ``rounds`` rounds: (jax state, jax metrics, port engine,
    port state, port metrics)."""
    cfg = dict(kw, sim_workers=n)
    j_eng = JSimEngine(j_model, _mesh1(devices), JConfig(**cfg))
    sample = packs[0][0][0, 0]
    j_state = j_eng.init_state(jax.random.key(0), sample)
    variables = jax.device_get(j_eng.rank0_variables(j_state))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.cnn_flax_to_torch(variables).items()})
    t_eng = SimEngine(model, Config(device="cpu", **cfg), CPU)
    t_state = t_eng.init_state()
    for _ in range(rounds):
        j_state, j_mx = j_eng.round(j_state, *packs)
        t_state, t_mx = t_eng.round(t_state, *packs)
    return jax.device_get(j_state), jax.device_get(j_mx), t_eng, t_state, t_mx


def _check_rows(j_state, t_eng, t_state, lr, steps, stats_atol=1e-4):
    """Each worker's parameters within 2 lr per Adam step of JAX's (with
    at most one element in 1e4 past 1e-4: where the frameworks' rounding
    flips the sign of a near-zero gradient Adam moves it by ~lr), its
    BatchNorm statistics at ``stats_atol``, its moments' count equal."""
    j_rows = j_state.params
    flipped = total = 0
    for i in range(t_eng.n_workers):
        sd = {k: p[i] for k, p in zip(t_eng.names, t_state.params)}
        sd.update({k: b[i] for k, b in zip(t_eng.buffer_names,
                                           t_state.buffers)})
        got = dict(jax.tree_util.tree_flatten_with_path(
            weights.cnn_torch_to_flax(sd))[0])
        want = {"params": jax.tree_util.tree_map(lambda a: np.asarray(a)[i],
                                                 j_rows)}
        if j_state.batch_stats:
            want["batch_stats"] = jax.tree_util.tree_map(
                lambda a: np.asarray(a)[i], j_state.batch_stats)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            err = np.abs(got[path] - leaf)
            if "batch_stats" in jax.tree_util.keystr(path):
                assert err.max() <= stats_atol, (i, path)
            else:
                assert err.max() <= 2 * lr * steps, (i, path)
                flipped += int((err > 1e-4).sum())
                total += err.size
    assert flipped <= total * 1e-4, (flipped, total)
    np.testing.assert_array_equal(
        t_state.opt.count, np.asarray(j_state.opt_state.count))
    np.testing.assert_array_equal(t_state.lr_epoch,
                                  np.asarray(j_state.lr_epoch))


@pytest.mark.parametrize("by,topology,how", [
    ("weights", "double_ring", "weighted"), ("gradients", "allreduce",
                                             "equal")])
def test_sim_round_matches_jax_sim_round_mlp(devices, by, topology, how):
    """mlp fp32 N=8, 2 rounds x 2 local epochs, at lr 1e-4 (as
    ``test_torch_dist.py`` explains): every metric at rtol 1e-4, params
    per worker within 2 lr per step, Adam counts and clocks equal (a
    padding step leaves a worker's count where it was)."""
    kw = _kw(aggregation_by=by, topology=topology, aggregation_type=how,
             lr=1e-4, epochs_local=2, local_weight=0.7)
    packs = (_packs(N), _packs(N, seed=1))
    j_state, j_mx, t_eng, t_state, t_mx = _round_pair(
        devices, _mlp(), j_get_model("mlp", num_classes=10, hidden=16), kw,
        N, packs)
    for key in METRICS:
        np.testing.assert_allclose(t_mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    # the last worker's first step is all padding in each local epoch
    assert t_state.opt.count.tolist() == [16] * (N - 1) + [12]
    _check_rows(j_state, t_eng, t_state, 1e-4, 16)
    if by == "gradients":
        assert (t_mx["agg_grad_norm"] > 0).all()


def test_sim_round_matches_jax_sim_round_batchnorm(devices):
    """enhanced_cnn at width 4, N=3, fp32, augmentation off, one round of
    2 local epochs in weights mode: metrics at rtol 1e-4, BatchNorm
    statistics per worker at atol 1e-4 (``test_torch_dist.py``'s bounds),
    params within 2 lr per step."""
    n = 3
    kw = _kw(model="enhanced_cnn", dataset="cifar10", model_width=4,
             lr=1e-4, epochs_local=2, topology="ring",
             aggregation_type="weighted", local_weight=0.7)
    model = t_get_model("enhanced_cnn", num_classes=10, width=4)
    packs = (_packs(n, steps=2, b=4, shape=(32, 32, 3)),
             _packs(n, steps=1, b=4, seed=1, shape=(32, 32, 3)))
    j_state, j_mx, t_eng, t_state, t_mx = _round_pair(
        devices, model, j_get_model("enhanced_cnn", num_classes=10, width=4),
        kw, n, packs, rounds=1)
    for key in METRICS:
        np.testing.assert_allclose(t_mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    _check_rows(j_state, t_eng, t_state, 1e-4, 4)


# ----------------------------------------------------------------------
# the driver: against JAX's sim and the port's own worker processes
# ----------------------------------------------------------------------

def _walls(n, rounds=4):
    """Pinned probe durations and round walls (picklable, for spawned
    ranks)."""
    return dict(simulated_durations=np.full(n, 1.0),
                simulated_round_durations=functools.partial(
                    operator.getitem, [np.full(n, 0.1)] * rounds))


def _jax_and_port(monkeypatch, kw, n):
    """JAX ``train_global`` at ``--sim_workers n`` and the port's from
    JAX's initial parameters, probe and walls pinned."""
    init = {}
    j_init = j_train.LocalSGDEngine.init_state

    def capture(self, key, sample):
        state = j_init(self, key, sample)
        init["variables"] = self.rank0_variables(state)
        return state

    monkeypatch.setattr(j_train.LocalSGDEngine, "init_state", capture)
    j_res = j_train_global(JConfig(**kw, sim_workers=n), progress=False,
                           **_walls(n))
    build = t_driver.build_model_for

    def transplanted(cfg, num_classes, device, input_shape=None):
        model = build(cfg, num_classes, device, input_shape)
        model.load_state_dict({
            k: torch.from_numpy(np.array(v)) for k, v in
            weights.cnn_flax_to_torch(init["variables"]).items()})
        return model

    monkeypatch.setattr(t_driver, "build_model_for", transplanted)
    res = t_driver.train_global(Config(device="cpu", sim_workers=n, **kw),
                                progress=False, **_walls(n))
    return j_res, res


def _check_global(res, j_res, rtol=1e-4):
    assert res["shard_sizes"] == j_res["shard_sizes"]
    assert res["step_caps"] == j_res["step_caps"]
    for key in ("global_train_losses", "global_val_losses",
                "global_train_accuracies", "global_val_accuracies",
                "worker_specific_train_losses", "all_epochs_losses"):
        got = np.asarray(res[key], np.float64)
        want = np.asarray(j_res[key], np.float64)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("topology,how", [("allreduce", "equal"),
                                          ("ring", "weighted"),
                                          ("double_ring", "equal")])
def test_train_global_sim_matches_jax_sim(devices, monkeypatch, topology,
                                          how):
    """``--sim_workers 8``, 2 rounds of mlp in weights mode at lr 1e-4
    from JAX's init: the partitions and caps equal, the reference metrics
    at rtol 1e-4, worker 0's final parameters within 2 lr per step (at
    most one element in 1e4 past 1e-4)."""
    kw = _kw(topology=topology, aggregation_type=how, lr=1e-4)
    j_res, res = _jax_and_port(monkeypatch, kw, N)
    _check_global(res, j_res)
    want = weights.cnn_flax_to_torch(jax.device_get(j_res["variables"]))
    steps = int(res["state"].opt.count[0])
    for k, v in res["variables"].items():
        err = np.abs(v.numpy() - want[k])
        assert err.max() <= 2 * 1e-4 * steps, k
        assert (err > 1e-4).sum() <= max(1, err.size // 10_000), k
    assert res["sim"]["workers"] == j_res["sim"]["workers"] == N
    assert res["sim"]["per_worker_sync_bytes"] == \
        j_res["sim"]["per_worker_sync_bytes"]


def test_sim_staleness_matches_jax(devices, monkeypatch):
    """``--sim_staleness 1`` over 3 rounds (round R's consensus lands at
    round R+2, the rest drained at exit): the reference metrics at rtol
    1e-4, ``results["sim"]["staleness"]`` 1 on both sides."""
    kw = _kw(epochs_global=3, sim_staleness=1, lr=1e-4,
             topology="double_ring")
    j_res, res = _jax_and_port(monkeypatch, kw, N)
    _check_global(res, j_res)
    assert res["sim"]["staleness"] == j_res["sim"]["staleness"] == 1
    want = weights.cnn_flax_to_torch(jax.device_get(j_res["variables"]))
    steps = int(res["state"].opt.count[0])
    for k, v in res["variables"].items():
        assert np.abs(v.numpy() - want[k]).max() <= 2 * 1e-4 * steps, k


def test_sim_two_workers_matches_two_processes():
    """``--sim_workers 2`` against the port's own 2-process gloo run of the
    same config (``test_torch_dist_driver.py``'s harness), fp32, 2 rounds:
    the same partitions, every worker's batch losses at rtol 1e-5 and the
    final parameters at atol 1e-6 (the stacked step computes each
    worker's products as a batched matmul, which rounds as the worker's
    own matmul up to summation order)."""
    kw = _kw(lr=1e-3, limit_train_samples=200, limit_eval_samples=32,
             probe_batches=1)
    walls = _walls(2)
    sim = t_driver.train_global(Config(device="cpu", sim_workers=2, **kw),
                                progress=False, **walls)
    cfg = Config(device="cpu", **kw)
    store = mesh.new_store_path()
    procs = mesh.spawn_workers(t_driver.train_rank, 2,
                               (store, 60.0, cfg, walls))
    try:
        real = t_driver.train_rank(0, 2, store, 60.0, cfg, walls)
        mesh.join_workers(procs, timeout_s=60.0)
    finally:
        mesh.stop_workers(procs)
        mesh.remove_store(store)
    assert sim["shard_sizes"] == real["shard_sizes"]
    for w in range(2):
        np.testing.assert_allclose(sim["all_workers_losses"][w],
                                   real["all_workers_losses"][w], rtol=1e-5)
    for k, v in real["variables"].items():
        np.testing.assert_allclose(sim["variables"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------------
# the scenario semantics (JAX TestScenarios), on the port alone
# ----------------------------------------------------------------------

def sim_run(n=8, rounds=3, **kw):
    return t_driver.train_global(
        Config(device="cpu", sim_workers=n, **_kw(epochs_global=rounds,
                                                   **kw)),
        progress=False, **_walls(n))


def test_results_schema_telemetry_and_more_workers_than_processes():
    """``results["sim"]`` has JAX's keys and provenance, the sync engine
    row and every round's sync row; 32 workers run in one process, each
    with its own losses, and the loss falls."""
    res = sim_run(n=32, rounds=2)
    s = res["sim"]
    assert set(s) == {"workers", "rounds", "rounds_per_s", "round_ms",
                      "per_worker_state_bytes", "per_worker_sync_bytes",
                      "staleness", "scenario"}
    assert s["workers"] == 32 and s["rounds"] == 2 and s["staleness"] == 0
    assert s["rounds_per_s"] > 0
    assert s["scenario"] == {"sample_frac": 1.0, "dropout": 0.0,
                             "byzantine": None, "lr_jitter": 0.0}
    assert set(s["per_worker_state_bytes"]) == {
        "params", "params_gathered_peak", "opt_state", "ef_residual",
        "ef_residual_outer", "round_opt", "buddy", "batch_stats",
        "bookkeeping"}
    assert s["per_worker_sync_bytes"] == \
        s["per_worker_state_bytes"]["params"]
    assert res["sync_engine"]["mode"] == "sim"
    assert res["sync_engine"]["levels"] == {"inner": "sim", "outer": None}
    for t in res["round_timings"]:
        assert t["sync_mode"] == "sim"
        assert t["sync_bytes"] == s["per_worker_sync_bytes"]
        assert t["sync_ms"] >= 0.0 and t["sync_hidden_ms"] == 0.0
        assert len(t["workers_train_steps"]) == 32
    assert len(res["all_workers_losses"]) == 32
    assert all(len(w) > 0 for w in res["all_workers_losses"])
    losses = res["global_train_losses"]
    assert losses[-1] < losses[0]


def test_sampling_draws_are_seeded_and_telemetered():
    a = sim_run(sim_sample_frac=0.5)
    b = sim_run(sim_sample_frac=0.5)
    draws = a["sim"]["rounds_scenario"]
    assert len(draws) == 3 and all(d["active"] == 4 for d in draws)
    assert a["global_train_losses"] == b["global_train_losses"]
    assert draws == b["sim"]["rounds_scenario"]


def test_dropout_freezes_the_dropped_worker():
    """A dropped worker's round is a no-op: its parameters, moments,
    statistics, count and clock are bitwise what they were at the round's
    entry (n=4, the seed's draw drops worker rows in this config)."""
    cfg = Config(device="cpu", sim_workers=4, sim_dropout=0.45,
                 **_kw(model="enhanced_cnn", dataset="cifar10",
                       model_width=4))
    model = t_get_model("enhanced_cnn", num_classes=10, width=4)
    model.init_parameters(torch.Generator().manual_seed(0))
    eng = SimEngine(model, cfg, CPU)
    state = eng.init_state()
    packs = (_packs(4, steps=2, b=4, shape=(32, 32, 3)),
             _packs(4, steps=1, b=4, seed=1, shape=(32, 32, 3)))
    frozen_rounds = 0
    for _ in range(4):
        before = [t.clone() for t in (*state.params, *state.buffers,
                                      *state.opt.mu, *state.opt.nu)]
        count, clock = state.opt.count.copy(), state.lr_epoch.copy()
        state, _ = eng.round(state, *packs)
        dropped = np.array([False] * 4)
        # the round's draw: the engine logs counts; recompute the mask
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed,
                                                            0x51AB]))
        for _ in range(len(eng.rounds_scenario)):
            dropped = rng.random(4) < cfg.sim_dropout
        after = (*state.params, *state.buffers, *state.opt.mu,
                 *state.opt.nu)
        for i in np.flatnonzero(dropped):
            frozen_rounds += 1
            assert all(torch.equal(a[i], b[i])
                       for a, b in zip(after, before)), i
            assert state.opt.count[i] == count[i]
            assert state.lr_epoch[i] == clock[i]
        for i in np.flatnonzero(~dropped):
            assert state.lr_epoch[i] == clock[i] + 1
    assert frozen_rounds > 0
    assert sum(d["dropped"] for d in eng.rounds_scenario) == frozen_rounds


def test_sampled_out_worker_adopts_the_consensus():
    """allreduce x equal with sampling: every row adopts the survivors'
    mean, so all parameter rows are identical after each round."""
    res = sim_run(sim_sample_frac=0.5)
    assert res["sim"]["rounds_scenario"][0]["active"] == 4
    state = res["state"]
    assert state.lr_epoch.min() < 3      # sampled-out rows' clocks lag
    for leaf in state.params:
        assert torch.equal(leaf, leaf[:1].expand_as(leaf)), "rows diverged"


def test_byzantine_signflip_changes_consensus_and_hurts():
    clean = sim_run()
    byz = sim_run(sim_byzantine="signflip:3")
    assert clean["global_train_losses"] != byz["global_train_losses"]
    assert byz["global_train_losses"][-1] > clean["global_train_losses"][-1]
    assert byz["sim"]["scenario"]["byzantine"] == "signflip:3"


def test_byzantine_noise_is_seeded_and_bounded():
    a = sim_run(sim_byzantine="noise:2:0.01")
    b = sim_run(sim_byzantine="noise:2:0.01")
    assert a["global_train_losses"] == b["global_train_losses"]
    assert np.isfinite(a["global_train_losses"]).all()


def test_lr_jitter_spreads_worker_trajectories():
    """Gradients mode keeps params per worker, so a per-worker lr spread
    leaves different rows (and different losses)."""
    flat = sim_run(n=4, aggregation_by="gradients")
    jit_ = sim_run(n=4, aggregation_by="gradients", sim_lr_jitter=0.5)
    assert flat["global_train_losses"] != jit_["global_train_losses"]
    w = jit_["all_workers_losses"]
    assert w[0] != w[1]


def test_defaults_arm_no_scenario_machinery():
    """At the defaults no draw is taken, no entry state is kept and no
    lr scale exists; any scenario knob arms it."""
    eng = SimEngine(_mlp(), Config(device="cpu", sim_workers=N, **_kw()),
                    CPU)
    assert eng.scenario_on is False and eng.lr_scale is None
    state, _ = eng.round(eng.init_state(), _packs(N), _packs(N, seed=1))
    assert eng.rounds_scenario == []
    armed = SimEngine(_mlp(), Config(device="cpu", sim_workers=N,
                                     sim_dropout=0.3, **_kw()), CPU)
    assert armed.scenario_on is True


def test_compressed_wire_runs_with_ef_state():
    res = sim_run(sync_dtype="bfloat16", sync_compression="ef",
                  topology="ring")
    s = res["sim"]
    assert s["per_worker_state_bytes"]["ef_residual"] > 0
    assert s["per_worker_sync_bytes"] == \
        s["per_worker_state_bytes"]["params"] // 2
    assert np.isfinite(res["global_train_losses"]).all()


def test_main_runs_the_lab_in_one_process(tmp_path, monkeypatch):
    """``main --sim_workers 8`` runs in the calling process (no worker is
    spawned), evaluates worker 0 and writes the plots."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)

    def no_spawn(*a, **k):
        raise AssertionError("the lab spawned a worker process")

    monkeypatch.setattr(mesh, "spawn_workers", no_spawn)
    res = t_main.run(["--device", "cpu", "--sim_workers", "8", "--model",
                      "mlp", "--dataset", "mnist", "--epochs_global", "2",
                      "--epochs_local", "1", "--batch_size", "16",
                      "--limit_train_samples", "400",
                      "--limit_eval_samples", "64", "--probe_batches", "1",
                      "--aggregation_by", "weights", "--log_level",
                      "warning", "--out_dir", str(tmp_path)])
    assert res["sim"]["workers"] == 8
    assert len(res["all_workers_losses"]) == 8
    assert np.isfinite(res["test_eval"]["loss"])
    assert (tmp_path / "training_metrics.json").exists()


# ----------------------------------------------------------------------
# the vmap rules: flash ops, the loss, BatchNorm, Adam, the probe
# ----------------------------------------------------------------------

def _qkv(n=3, b=2, l=16, h=4, kv=2, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    return mk(n, b, l, h, d), mk(n, b, l, kv, d), mk(n, b, l, kv, d), \
        mk(n, b, l, h, d)


@pytest.mark.parametrize("op", ["forward", "two_pass", "fused"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_op_vmap_rules_match_a_loop(monkeypatch, op, causal):
    """Each flash op under ``vmap`` (the backward ones under
    ``vmap(grad(...))``) equals a loop over the workers, bitwise: the rule
    folds [N, B, ...] into [N*B, ...] and the plain versions compute each
    batch row alone.  The wrapper is called once per vmapped call (a
    launch on the card)."""
    monkeypatch.setattr(t_flash, "_FUSED_BWD", op == "fused")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = t_flash.flash_forward, t_flash.flash_backward

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(t_flash, "flash_forward", count_fwd)
    monkeypatch.setattr(t_flash, "flash_backward", count_bwd)
    q, k, v, w = _qkv()
    attn = lambda q, k, v: t_flash.flash_attention(q, k, v, causal=causal)
    if op == "forward":
        with torch.no_grad():
            got = vmap(attn)(q, k, v)
        want = torch.stack([attn(q[i], k[i], v[i]) for i in range(3)])
        assert torch.equal(got, want)
        assert calls == {"fwd": 4, "bwd": 0}
        return
    loss = lambda q, k, v, w: (attn(q, k, v) * w).sum()
    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    assert calls == {"fwd": 1, "bwd": 1}
    for i in range(3):
        qi, ki, vi = (t[i].clone().requires_grad_() for t in (q, k, v))
        want = torch.autograd.grad(loss(qi, ki, vi, w[i]), (qi, ki, vi))
        for g, r in zip(got, want):
            assert torch.equal(g[i], r)


def test_flash_sends_func_grad_inputs_to_the_differentiable_op():
    """Under ``torch.func.grad`` the inputs report ``requires_grad``, so the
    wrapper takes ``FlashAttention`` (a gradient exists and matches the
    dense attention's at fp32 atol 1e-5)."""
    q, k, v, w = (t[0] for t in _qkv())
    f = lambda q: (t_flash.flash_attention(q, k, v, causal=True) * w).sum()
    dense = lambda q: (t_flash.dot_product_attention(
        q, k, v, None, causal=True) * w).sum()
    np.testing.assert_allclose(grad(f)(q).numpy(), grad(dense)(q).numpy(),
                               atol=1e-5)


def test_gpt_tiny_flash_sim_matches_a_loop_and_jax_dense(devices,
                                                         monkeypatch):
    """gpt_tiny with ``--attention_impl flash`` (the plain branch under
    vmap) at N=2, fp32: one SimEngine round equals two one-worker engine
    rounds from the same init in gradients mode (params untouched by the
    sync): batch losses at atol 1e-6, params at atol 1e-6 but for at most
    one element in 1e4, which stays within 2 lr per Adam step (the
    vmapped products are batched matmuls that round apart from the
    worker's own by an ulp, and Adam moves a near-zero gradient's element
    by ~lr whatever its size); and JAX's SimEngine with dense attention
    at the metrics' rtol 1e-4."""
    n = 2
    kw = _kw(model="gpt_tiny", dataset="synthetic_lm", batch_size=4,
             attention_impl="flash", aggregation_by="gradients", lr=1e-4,
             epochs_local=1)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1000, (n, 2, 4, 16)).astype(np.int32)
    y = rng.integers(0, 1000, (n, 2, 4, 16)).astype(np.int32)
    m = np.ones((n, 2, 4), np.float32)
    packs = ((x, y, m), (x[:, :1], y[:, :1], m[:, :1]))
    model = t_get_model("gpt_tiny", num_classes=1000,
                        attention_impl="flash")
    model.init_parameters(torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    eng = SimEngine(model, Config(device="cpu", sim_workers=n, **kw), CPU)
    state, mx = eng.round(eng.init_state(), *packs)
    for i in range(n):
        one = t_get_model("gpt_tiny", num_classes=1000,
                          attention_impl="flash")
        one.load_state_dict(init)
        e1 = t_train.LocalSGDEngine(one, Config(device="cpu", **kw), CPU)
        s1 = e1.init_state()
        s1.rng = state.rng[i]
        _, mx1 = e1.round(s1, tuple(a[i:i + 1] for a in packs[0]),
                          tuple(a[i:i + 1] for a in packs[1]))
        np.testing.assert_allclose(mx["batch_losses"][i],
                                   mx1["batch_losses"][0], rtol=0,
                                   atol=1e-6)
        for name, p in zip(eng.names, state.params):
            err = np.abs(p[i].numpy() - dict(one.named_parameters())[name]
                         .detach().numpy())
            assert err.max() <= 2 * 1e-4 * 2, name
            assert (err > 1e-6).sum() <= max(1, err.size // 10_000), name
    # JAX SimEngine with dense attention from the same init
    j_kw = dict(kw, attention_impl="dense", sim_workers=n)
    j_eng = JSimEngine(j_get_model("gpt_tiny", num_classes=1000),
                       _mesh1(devices), JConfig(**j_kw))
    j_state = j_eng.init_state(jax.random.key(0), x[0, 0])
    variables = jax.device_get(j_eng.rank0_variables(j_state))
    port = t_get_model("gpt_tiny", num_classes=1000, attention_impl="flash")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          weights.flax_to_torch(variables["params"]).items()})
    eng2 = SimEngine(port, Config(device="cpu", sim_workers=n, **kw), CPU)
    _, t_mx = eng2.round(eng2.init_state(), *packs)
    _, j_mx = j_eng.round(j_state, *packs)
    for key in ("batch_losses", "train_loss", "val_loss", "agg_grad_norm"):
        np.testing.assert_allclose(t_mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, err_msg=key)


def test_softmax_cross_entropy_under_vmap_grad_matches_a_loop():
    """The loss's generated vmap rule: per-row values and gradients equal
    the row's own (fp32 atol 1e-7)."""
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 5, 11, generator=g)
    labels = torch.randint(0, 11, (3, 5), generator=g)
    f = lambda z, y: t_train.softmax_cross_entropy(z, y).sum()
    got = vmap(grad(f))(logits, labels)
    for i in range(3):
        z = logits[i].clone().requires_grad_()
        want, = torch.autograd.grad(f(z, labels[i]), z)
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-7)


def test_batchnorm_statistics_out_equal_the_in_place_update():
    """Inside ``running_stats_out`` a train-mode BatchNorm leaves its
    buffers and returns the statistics its in-place update writes,
    bitwise."""
    bn = BatchNorm(6)
    x = torch.randn(4, 6, 5, 5, generator=torch.Generator().manual_seed(2))
    with running_stats_out() as stats:
        out = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(6))
    mean, var = stats[bn]
    assert torch.equal(out, bn(x))
    assert torch.equal(bn.running_mean, mean)
    assert torch.equal(bn.running_var, var)


def test_stacked_adam_matches_per_worker_adam_and_gates_rows():
    """Rows stepping with different counts and lrs equal per-worker
    ``Adam`` (fp32 atol 1e-7: the per-row coefficients are tensors, not
    scalars), and a gated row's params, moments and count stay
    bitwise."""
    g = torch.Generator().manual_seed(4)
    n = 3
    params = [torch.randn(n, 4, 5, generator=g), torch.randn(n, 7,
                                                             generator=g)]
    ref = [[p[i].clone() for p in params] for i in range(n)]
    opt = t_train.StackedAdam(params, n)
    ref_opt = [t_train.Adam(r) for r in ref]
    schedule = [([1, 1, 1], [1e-3] * 3), ([1, 0, 1], [1e-3, 1e-3, 2e-3]),
                ([1, 1, 0], [1e-3, 5e-4, 2e-3])]
    for do, lr in schedule:
        grads = [torch.randn(p.shape, generator=g) for p in params]
        before = [(p.clone(), m.clone(), v.clone()) for p, m, v
                  in zip(params, opt.mu, opt.nu)]
        opt.step(params, grads, np.array(lr, np.float32), np.array(do, bool))
        for i in range(n):
            if do[i]:
                ref_opt[i].step(ref[i], [gr[i] for gr in grads], lr[i])
            else:
                for (p0, m0, v0), p, m, v in zip(before, params, opt.mu,
                                                 opt.nu):
                    assert torch.equal(p[i], p0[i])
                    assert torch.equal(m[i], m0[i])
                    assert torch.equal(v[i], v0[i])
    assert opt.count.tolist() == [o.count for o in ref_opt] == [3, 2, 2]
    for i in range(n):
        for p, r in zip(params, ref[i]):
            torch.testing.assert_close(p[i], r, rtol=0, atol=1e-7)


def test_gather_durations_tiles_without_a_group():
    """No group: the one measurement is every worker's (JAX
    ``probe.py:251``), for one worker and for N simulated ones."""
    assert t_probe.gather_durations(0.5, 1).tolist() == [0.5]
    assert t_probe.gather_durations(0.5, 8).tolist() == [0.5] * 8


# ----------------------------------------------------------------------
# configuration: every refusal of JAX's TestSimConfigValidation, and the
# port's own
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw,frag", [
    (dict(chaos="kill@1:w0"), "--chaos"),
    (dict(num_slices=2, topology="ring"), "--num_slices"),
    (dict(shard_redundancy="buddy"), "buddy"),
    (dict(opt_placement="sharded"), "--opt_placement"),
    (dict(param_residency="resident"), "resident"),
    (dict(sync_mode="sharded"), "--sync_mode"),
    (dict(stream_chunk_steps=4), "--stream_chunk_steps"),
    (dict(checkpoint_dir="/tmp/ck"), "--checkpoint_dir"),
    (dict(num_workers=4), "--num_workers"),
    (dict(mesh_shape="data=4,model=2"), "inner mesh axes"),
    (dict(sequence_parallel="ring"), "--sequence_parallel"),
    (dict(sync_staleness=1), "--sync_staleness"),
])
def test_real_engine_features_refused_as_jax_refuses_them(kw, frag):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError, match="sim_workers") as e:
            cfg_cls(**_kw(), sim_workers=8, **kw)
        assert frag in str(e.value), (cfg_cls, kw, str(e.value))


@pytest.mark.parametrize("kw", [
    dict(sim_sample_frac=0.0), dict(sim_sample_frac=1.5),
    dict(sim_dropout=-0.1), dict(sim_dropout=1.0),
    dict(sim_lr_jitter=1.0), dict(sim_lr_jitter=-0.5),
    dict(sim_staleness=-1)])
def test_scenario_ranges_checked(kw):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError):
            cfg_cls(**_kw(), sim_workers=8, **kw)


@pytest.mark.parametrize("spec", [
    "evil:2", "signflip", "signflip:0", "signflip:8", "signflip:2:0.5",
    "noise:2:-1", "noise:x"])
def test_byzantine_spec_validated(spec):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError):
            cfg_cls(**_kw(), sim_workers=8, sim_byzantine=spec)


@pytest.mark.parametrize("kw", [
    dict(sim_dropout=0.5), dict(sim_sample_frac=0.5),
    dict(sim_byzantine="signflip:2"), dict(sim_lr_jitter=0.5),
    dict(sim_staleness=1)])
def test_scenario_knobs_need_sim_workers(kw):
    for cfg_cls in (JConfig, Config):
        with pytest.raises(ValueError, match="sim_workers"):
            cfg_cls(**_kw(), **kw)


def test_valid_sim_config_accepted():
    for cfg_cls in (JConfig, Config):
        cfg = cfg_cls(**_kw(), sim_workers=256, sim_sample_frac=0.1,
                      sim_dropout=0.05, sim_byzantine="noise:8:0.5",
                      sim_lr_jitter=0.2)
        assert cfg.parse_sim_byzantine() == ("noise", 8, 0.5)


@pytest.mark.parametrize("kw,frag", [
    (dict(sim_workers=2, sim_staleness=1, aggregation_by="gradients"),
     "--aggregation_by weights"),
    (dict(sim_workers=2, sync_compression="ef"), "compressed --sync_dtype"),
    (dict(sim_workers=2, sync_dtype="int8", sync_mode="dense"),
     "--sync_mode dense"),
    (dict(sync_dtype="bfloat16", sync_mode="dense"), "--sync_mode dense"),
    (dict(sync_compression="ef"), "compressed --sync_dtype"),
    # the chaos flags are ported; with the lab JAX refuses them
    (dict(sim_workers=2, chaos="random", chaos_seed=3),
     "cannot combine with --sim_workers"),
    # --pp_microbatches without a pipe axis is inert, as in JAX: accepted
    (dict(sim_workers=2, pp_microbatches=2), None),
], ids=["kw0---aggregation_by weights", "kw1-compressed --sync_dtype",
        "kw2---sync_mode dense", "bf16-wire-on-dense", "ef-without-wire",
        "sim-chaos_seed-A.11", "sim-pp_microbatches-A.11"])
def test_the_ports_own_refusals(kw, frag):
    """The wire flags' checks hold with and without ``--sim_workers`` (the
    real engines take the compressed wire too); what the port has not
    ported yet names A.11; the lab takes --pp_microbatches as JAX does,
    inert without a pipe axis (frag None)."""
    if frag is None:
        assert Config(**{**_kw(), **kw}).sim_workers == 2
        return
    with pytest.raises(ValueError, match=frag):
        Config(**{**_kw(), **kw})


def test_sim_wire_flags_parse_on_the_cli():
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
        config_from_args,
    )
    cfg = config_from_args(["--sim_workers", "4", "--sync_dtype", "int8",
                            "--sync_compression", "ef", "--aggregation_by",
                            "weights", "--sim_byzantine", "signflip:1"])
    assert (cfg.sim_workers, cfg.sync_dtype, cfg.sync_compression,
            cfg.parse_sim_byzantine()) == (4, "int8", "ef",
                                           ("signflip", 1, 1.0))
    with pytest.raises(ValueError, match="--num_workers"):
        config_from_args(["--sim_workers", "4", "--num_workers", "2"])


def test_grad_accum_slices_each_workers_batch():
    """``--grad_accum 2`` in the stacked step: each worker's batch in two
    slices over the full step's denominator, gradients summed; gpt_tiny
    fp32 at N=2 against K=1 from the same init: batch losses at rtol 1e-5
    and params at atol 1e-6 but for one element in 1e4 (fp32 sums in
    another order, then Adam's near-zero-gradient moves, as above)."""
    n = 2
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1000, (n, 2, 4, 16)).astype(np.int32)
    y = rng.integers(0, 1000, (n, 2, 4, 16)).astype(np.int32)
    m = np.ones((n, 2, 4), np.float32)
    packs = ((x, y, m), (x[:, :1], y[:, :1], m[:, :1]))
    out = {}
    for k in (1, 2):
        model = t_get_model("gpt_tiny", num_classes=1000)
        model.init_parameters(torch.Generator().manual_seed(3))
        kw = _kw(model="gpt_tiny", dataset="synthetic_lm", batch_size=4,
                 lr=1e-4, grad_accum=k)
        eng = SimEngine(model, Config(device="cpu", sim_workers=n, **kw),
                        CPU)
        state, mx = eng.round(eng.init_state(), *packs)
        out[k] = (mx, state)
    np.testing.assert_allclose(out[2][0]["batch_losses"],
                               out[1][0]["batch_losses"], rtol=1e-5)
    for a, b in zip(out[2][1].params, out[1][1].params):
        err = (a - b).abs()
        assert err.max() <= 2 * 1e-4 * 2
        assert (err > 1e-6).sum() <= max(1, err.numel() // 10_000)
