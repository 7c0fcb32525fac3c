"""Pipeline parallelism over the ``pipe`` axis of the port's rank grid
(``..._torch/parallel/pp.py``) against the JAX package's
``parallel/pp.py``: the schedules' orders run without processes (every
send meets its receive in order on the neighbour, no deadlock, the
microbatches in flight); GPipe and 1F1B on 4 gloo ranks of one spawn
against JAX's ``gpipe_schedule`` and ``onef1b_loss`` under ``shard_map``
on a 4-device ``pipe`` mesh, on JAX ``tests/test_pp.py``'s toy stages and
numpy inputs, at JAX's tolerances; one step of a model's pipe stages
(with ``model`` and ``fsdp`` beside ``pipe``) against the dense twin in
each rank; the parameter specs leaf by leaf against JAX's; and JAX's
refusals of the pipe flags, with its messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    config as j_config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.bert import (
    pp_tp_param_specs as j_pp_tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.pp import (
    gpipe_schedule as j_gpipe_schedule,
    onef1b_loss as j_onef1b_loss,
    pp_param_specs as j_pp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    config as t_config,
    driver as t_driver,
    grid_harness,
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.bert import (
    pp_tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    pp,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

STAGES = 4
# JAX TestGpipeSchedule: forward atol 1e-6, gradients atol 1e-5
GPIPE_M, GPIPE_MB, D = 8, 2, 16
# JAX TestOneF1B: loss rtol 1e-5; stage, head and input gradients rtol
# 1e-4, atol 1e-6
ONEF1B_MB = 2
# the module step against the dense twin: logits atol 1e-5, gradients
# atol 2e-4 (the grid's gates, tests/test_torch_tp.py)
LOGITS_ATOL, GRAD_ATOL = 1e-5, 2e-4
MODEL_VOCAB, MODEL_SEQ = 96, 16
# id -> (registry name, axes, schedule, microbatches)
MODEL_CASES = {
    "gpt_pipe_model_1f1b": ("gpt_tiny", {"pipe": 2, "model": 2}, "1f1b", 2),
    "bert_fsdp_pipe_gpipe": ("bert_tiny", {"fsdp": 2, "pipe": 2}, "gpipe",
                             2),
    "gpt_small_pipe4_1f1b": ("gpt_small", {"pipe": 4}, "1f1b", 4),
}


def _gpipe_inputs():
    """JAX TestGpipeSchedule._run's draws."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(GPIPE_M, GPIPE_MB, D)).astype(np.float32)
    w = rng.normal(size=(STAGES, 1)).astype(np.float32)
    return xs, w


def _onef1b_inputs(m):
    """JAX TestOneF1B._setup's draws."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(STAGES, D, D)) * 0.3).astype(np.float32)
    h = (rng.normal(size=(D, 3)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(m, ONEF1B_MB, D)).astype(np.float32)
    tgt = rng.normal(size=(m, ONEF1B_MB, 3)).astype(np.float32)
    return w, h, xs, tgt


# ----------------------------------------------------------------------
# (a) the orders, without processes
# ----------------------------------------------------------------------

_PEER = {"send_act": ("recv_act", 1), "recv_act": ("send_act", -1),
         "send_grad": ("recv_grad", -1), "recv_grad": ("send_grad", 1)}


def _simulate(orders):
    """Run every stage's order: a point-to-point op completes once its
    peer has posted the matching op (the receive for a send, and the
    reverse) for the same microbatch; a batch of ops ends when all of its
    ops have.  Returns each stage's most microbatches in flight; fails on
    an op met by the wrong microbatch or on a deadlock."""
    p = len(orders)
    pc = [0] * p
    done = [set() for _ in range(p)]       # completed ops of the batch
    live = [set() for _ in range(p)]       # forwarded, not yet backwarded
    most = [0] * p
    seen = {k: [[] for _ in range(p)] for k in _PEER}
    while any(pc[s] < len(orders[s]) for s in range(p)):
        progress = False
        for s in range(p):
            if pc[s] >= len(orders[s]):
                continue
            kind, arg = orders[s][pc[s]]
            if kind in ("F", "B"):
                (live[s].add if kind == "F" else live[s].remove)(arg)
                most[s] = max(most[s], len(live[s]))
                pc[s] += 1
                progress = True
                continue
            for op, i in arg:
                if (op, i) in done[s]:
                    continue
                want, step = _PEER[op]
                t = s + step
                assert 0 <= t < p, (s, op)
                if pc[t] >= len(orders[t]) or orders[t][pc[t]][0] != "X":
                    continue
                peer = [j for o, j in orders[t][pc[t]][1] if o == want]
                if not peer:
                    continue
                assert peer == [i], (f"stage {s} {op} microbatch {i} met "
                                     f"stage {t}'s {want} {peer}")
                done[s].add((op, i))
                done[t].add((want, i))
                seen[op][s].append(i)
                seen[want][t].append(i)
            if all(o in done[s] for o in arg):
                done[s] -= set(arg)
                pc[s] += 1
                progress = True
        assert progress, f"deadlock at {[orders[s][pc[s]] if pc[s] < len(orders[s]) else None for s in range(p)]}"
    return most, seen


@pytest.mark.parametrize("p", range(2, 9))
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedule_orders_meet_in_order_without_deadlock(schedule, p):
    """For P in 2..8 and M in {1, P-1, P, 2P+1}: every stage's order runs
    to its end with rendezvous point-to-point semantics; each activation
    sent by stage s is received by s+1, and each cotangent by s-1, in the
    same microbatch order; every microbatch is forwarded and backwarded
    once on every stage; 1F1B holds at most P-s microbatches in flight on
    stage s (min(P-s, M)), GPipe all M."""
    for m in sorted({1, p - 1, p, 2 * p + 1} - {0}):
        orders = [pp.order(schedule, p, s, m) for s in range(p)]
        most, seen = _simulate(orders)
        for s in range(p):
            assert [a for k, a in orders[s] if k == "F"] == list(range(m))
            assert sorted(a for k, a in orders[s] if k == "B") == \
                list(range(m))
            assert most[s] == pp.in_flight_bound(schedule, p, s, m)
            if s < p - 1:
                assert seen["send_act"][s] == seen["recv_act"][s + 1] \
                    == list(range(m))
                assert seen["recv_grad"][s] == seen["send_grad"][s + 1]
        if schedule == "1f1b":
            assert all(most[s] <= p - s for s in range(p))


# ----------------------------------------------------------------------
# (b), (c): the schedules on 4 gloo ranks against JAX
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """One spawn of 4 gloo ranks (one intra-op thread each): GPipe on the
    scale stages at M=8, 1F1B on the matmul stages with the head at M=8
    and M=7, and the model steps; {case: the ranks' results}."""
    d = tmp_path_factory.mktemp("pp_jobs")
    xs, w = _gpipe_inputs()
    jobs = [dict(kind="pp", axes={"pipe": STAGES}, schedule="gpipe", xs=xs,
                 w=w)]
    for m in (8, 7):
        w1, h, x1, tgt = _onef1b_inputs(m)
        jobs.append(dict(kind="pp", axes={"pipe": STAGES}, schedule="1f1b",
                         xs=x1, w=w1, head=h, tgt=tgt))
    for i, (name, axes, schedule, m) in enumerate(MODEL_CASES.values()):
        model = get_model(name, num_classes=MODEL_VOCAB)
        model.init_parameters(torch.Generator().manual_seed(i))
        rng = np.random.default_rng(300 + i)
        jobs.append(dict(
            model=name, vocab=MODEL_VOCAB, axes=axes, schedule=schedule,
            kw=dict(pp_microbatches=m, pp_schedule=schedule,
                    mesh_shape=",".join(f"{a}={n}" for a, n in axes.items())),
            state_dict={k: v.numpy() for k, v in model.state_dict().items()},
            x=rng.integers(0, MODEL_VOCAB, (8, MODEL_SEQ)),
            y=rng.integers(-1, MODEL_VOCAB, (8, MODEL_SEQ)),
            m=np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)))
    spec = d / "jobs.pt"
    torch.save({"axes": jobs[0]["axes"], "jobs": jobs}, spec)
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, 4, (store, str(spec), str(d)),
            ranks=range(4), threads=1), timeout_s=120.0)
    finally:
        mesh.remove_store(store)
    names = ["gpipe_m8", "onef1b_m8", "onef1b_m7", *MODEL_CASES]
    return {name: [torch.load(d / f"rank{r}-{i}.pt", weights_only=False)
                   for r in range(4)] for i, name in enumerate(names)}


def _pipe_mesh():
    return Mesh(np.array(jax.devices()[:STAGES]), ("pipe",))


def test_gpipe_matches_jax_gpipe_schedule(pp_runs):
    """JAX TestGpipeSchedule: the last stage's outputs equal JAX's
    ``gpipe_schedule`` of tanh(a * w_s) on a 4-device pipe mesh (atol
    1e-6), and the gradients of sum(out**2) with respect to every stage's
    weight and the inputs equal JAX's (atol 1e-5); every stage held all
    M microbatches in flight and hopped both ways."""
    xs, w = _gpipe_inputs()
    m = GPIPE_M

    def fn(w_local, x):
        return j_gpipe_schedule(lambda a: jnp.tanh(a * w_local[0]), x,
                                "pipe", m)

    sharded = jax.jit(jax.shard_map(fn, mesh=_pipe_mesh(),
                                    in_specs=(P("pipe"), P()),
                                    out_specs=P()))
    want = np.asarray(sharded(jnp.asarray(w), jnp.asarray(xs)))
    gw, gx = jax.grad(lambda a, b: (sharded(a, b) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(w), jnp.asarray(xs))
    ranks = pp_runs["gpipe_m8"]
    np.testing.assert_allclose(ranks[-1]["got"]["out"], want, atol=1e-6)
    np.testing.assert_allclose(
        np.stack([r["got"]["w_grad"] for r in ranks]), np.asarray(gw),
        atol=1e-5)
    np.testing.assert_allclose(ranks[0]["got"]["xs_grad"], np.asarray(gx),
                               atol=1e-5)
    for r in ranks:
        assert r["in_flight"] == m
        assert max(r["errors"].values()) < 1e-5, r["errors"]
    assert all(r["stats"]["fwd_calls"] > 0 for r in ranks[:-1])
    assert all(r["stats"]["bwd_calls"] > 0 for r in ranks[1:])


@pytest.mark.parametrize("m", [8, 7])
def test_onef1b_matches_jax_onef1b_loss(pp_runs, m):
    """JAX TestOneF1B (M=8 and the odd M=7): the loss equals JAX's
    ``onef1b_loss`` on a 4-device pipe mesh (rtol 1e-5), and the stage,
    head and input gradients its ``value_and_grad`` (rtol 1e-4, atol
    1e-6); stage s held at most 4 - s microbatches in flight."""
    w, h, xs, tgt = _onef1b_inputs(m)
    tgt_j = jnp.asarray(tgt)

    def stage_apply(wl, x):
        return jnp.tanh(x @ wl[0])

    def loss_fn(hp, y, i):
        return ((y @ hp - tgt_j[i]) ** 2).sum() / (m * ONEF1B_MB)

    def run(wa, hp, x):
        def inner(wl, hp, x):
            return j_onef1b_loss(stage_apply, loss_fn, wl, hp, x,
                                 axis_name="pipe", num_micro=m)[0]
        return jax.shard_map(inner, mesh=_pipe_mesh(),
                             in_specs=(P("pipe"), P(), P()),
                             out_specs=P())(wa, hp, x)

    loss, (gw, gh, gx) = jax.jit(jax.value_and_grad(run, argnums=(0, 1, 2)))(
        jnp.asarray(w), jnp.asarray(h), jnp.asarray(xs))
    ranks = pp_runs[f"onef1b_m{m}"]
    last, first = ranks[-1]["got"], ranks[0]["got"]
    np.testing.assert_allclose(float(last["loss"]), float(loss), rtol=1e-5)
    for got, want, name in (
            (np.stack([r["got"]["w_grad"] for r in ranks]), gw, "stage"),
            (last["head_grad"], gh, "head"), (first["xs_grad"], gx, "xs")):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for s, r in enumerate(ranks):
        assert r["in_flight"] == min(STAGES - s, m) <= STAGES - s
        assert max(r["errors"].values()) < 1e-5, r["errors"]


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_stages_match_dense_twin(pp_runs, name):
    """One step of a model's pipe stages (the engine's construction: the
    embedding on stage 0, each stage's blocks, the loss on the last stage,
    the replicated leaves' gradients summed over pipe, the fsdp shards
    gathered outside the schedule) against the dense twin in each rank:
    the last stage's logits at atol 1e-5, the worker's joined gradients
    at atol 2e-4; the stacked leaves are cut over pipe."""
    ranks = pp_runs[name]
    _model, axes, _schedule, _m = MODEL_CASES[name]
    for r in ranks:
        assert r["logits_err"] < LOGITS_ATOL, r["logits_err"]
        assert r["grads_err"] < GRAD_ATOL, r["grads_err"]
        assert any(spec[0] == "pipe" for key, spec in r["specs"].items()
                   if "['layers']" in key)
    lasts = [r for r in ranks if r["logits"].size]
    assert len(lasts) == 4 // axes["pipe"]
    # an fsdp rank's loss is its slice's numerator over the whole batch's
    # denominator
    loss = (sum(r["loss"] for r in lasts) if "fsdp" in axes
            else lasts[0]["loss"])
    np.testing.assert_allclose(loss, lasts[0]["dense_loss"], rtol=1e-5)


# ----------------------------------------------------------------------
# (d) the specs against JAX's
# ----------------------------------------------------------------------

def _jax_params(name):
    model = j_get_model(name, num_classes=MODEL_VOCAB, scan_layers=True)
    return jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((2, 16), jnp.int32),
                             train=False), jax.random.key(0))["params"]


def _flat(specs):
    return {jax.tree_util.keystr(path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))}


@pytest.mark.parametrize("name", ["bert_tiny", "gpt_tiny"])
def test_specs_match_jax(name):
    """``pp.pp_param_specs`` and ``bert.pp_tp_param_specs`` (GPT's tied
    table vocab-sharded) equal JAX's leaf by leaf on the port's JAX-layout
    keys of the stacked parameters; the stacked leaves lead with pipe."""
    shapes = weights.param_leaf_shapes(get_model(name,
                                                 num_classes=MODEL_VOCAB))
    params = _jax_params(name)
    tok = name.startswith("gpt")

    def pad(spec, key):
        return tuple(spec) + (None,) * (len(shapes[key]) - len(spec))

    want_pp = _flat(j_pp_param_specs(params, axis="pipe"))
    want_pptp = _flat(j_pp_tp_param_specs(params, pipe_axis="pipe",
                                          axis="model", shard_tok_emb=tok))
    got_pp = pp.pp_param_specs(shapes, "pipe")
    got_pptp = pp_tp_param_specs(shapes, pipe_axis="pipe", axis="model",
                                 shard_tok_emb=tok)
    assert set(got_pp) == set(want_pp) == set(shapes)
    for key in shapes:
        assert got_pp[key] == pad(want_pp[key], key), key
        assert got_pptp[key] == pad(want_pptp[key], key), key
        assert (got_pp[key][:1] == ("pipe",)) == ("['layers']" in key)


# ----------------------------------------------------------------------
# (e) the refusals
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flags,exc,match", [
    (["--model", "bert_tiny", "--pp_remat"], ValueError,
     "--pp_remat applies under pipeline parallelism"),
    (["--model", "bert_tiny", "--pp_schedule", "1f1b"], ValueError,
     "--pp_schedule 1f1b applies under pipeline parallelism"),
    (["--model", "mlp", "--dataset", "mnist", "--mesh_shape",
      "data=1,pipe=2", "--pp_schedule", "1f1b"], NotImplementedError,
     "--pp_schedule 1f1b supports bert_"),
    (["--model", "mlp", "--dataset", "mnist", "--mesh_shape",
      "data=1,pipe=2"], ValueError,
     r"a 'pipe' mesh axis \(pipeline parallelism\) applies to attention"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=2",
      "--batch_size", "9"], ValueError,
     "must be divisible by the 2 pipeline microbatches"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=4"], ValueError,
     "num_layers 2 not divisible by pp_size 4"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,fsdp=2,pipe=2",
      "--batch_size", "12", "--pp_microbatches", "4"], ValueError,
     "per-fsdp-slice batch 6 must be divisible by 4 pipeline"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=2",
      "--batch_size", "12", "--grad_accum", "2", "--pp_microbatches", "4"],
     ValueError,
     "per-accumulation-slice batch 6 must be divisible by 4 pipeline"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=2",
      "--layer_scan", "off"], ValueError,
     "--layer_scan off cannot combine with a 'pipe' mesh axis"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=2,expert=4",
      "--num_experts", "6"], ValueError,
     "num_experts 6 not divisible by expert-parallel size 4"),
    # elastic membership and staleness run under a pipe axis, as in JAX
    # (tests/test_torch_grid_chaos_axes.py, test_torch_grid_staleness.py)
    (["--model", "bert_tiny", "--mesh_shape", "data=2,pipe=2",
      "--chaos", "kill@1:w1"], None, None),
    (["--model", "bert_tiny", "--mesh_shape", "data=2,pipe=2",
      "--aggregation_by", "weights", "--sync_staleness", "1"], None, None),
], ids=["pp_remat_without_pipe", "1f1b_without_pipe", "1f1b_mlp",
        "pipe_mlp", "batch_microbatches", "layers_stages", "fsdp_slice",
        "accum_slice", "layer_scan_off", "moe", "chaos", "staleness"])
def test_config_refusals(flags, exc, match):
    """JAX's checks of the pipe axis and the --pp_* flags
    (driver.py:459-548, 672-709, models/bert.py:231-233), with its
    messages and exception types, each at the config or, where JAX's
    config takes the flags (--pp_remat without a pipe axis), when the run
    starts, as is --layer_scan off under a pipe axis; MoE
    runs under a pipe axis, with JAX's check that the expert axis divides
    the experts (models/moe.py:71-74); chaos and staleness under a pipe
    axis are taken by the port's Config and by JAX's (exc None)."""
    if exc is None:
        cfg = t_config.config_from_args(["--device", "cpu", *flags])
        j_config.config_from_args(["--device", "cpu", *flags])
        assert mesh.grid_axes(cfg) == {"data": 2, "pipe": 2}
        return
    with pytest.raises(exc, match=match):
        cfg = t_config.config_from_args(["--device", "cpu", *flags])
        t_driver.train_global(cfg, progress=False)


def test_pp_flags_parse_and_pp_remat_is_everything():
    """The pipe axis and the --pp_* flags parse; --pp_remat resolves to
    --remat_policy everything (JAX driver.py:488-492), an explicit policy
    wins."""
    cfg = t_config.config_from_args([
        "--device", "cpu", "--model", "gpt_tiny", "--mesh_shape",
        "data=1,pipe=2", "--pp_schedule", "1f1b", "--pp_microbatches", "4",
        "--pp_remat"])
    assert cfg.inner_axes() == {"pipe": 2}
    assert (cfg.pp_schedule, cfg.pp_microbatches) == ("1f1b", 4)
    assert cfg.resolve_remat_policy() == "everything"
    assert mesh.grid_axes(cfg) == {"data": 1, "pipe": 2}
    cfg = t_config.Config(model="gpt_tiny", mesh_shape="data=1,pipe=2",
                          pp_remat=True, remat_policy="dots_saveable")
    assert cfg.resolve_remat_policy() == "dots_saveable"
