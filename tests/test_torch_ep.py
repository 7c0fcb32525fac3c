"""Expert parallelism over the ``expert`` axis of the port's rank grid
(``..._torch/models/moe.py``, ``parallel/ep.py``, the expert specs and
``parallel/shards.py``) against the JAX package's ``MoEFFN`` under
``shard_map`` and the port's own dense twin: one MoE layer on its
expert (and model) shards at capacity factors 1.25 and 0.5 (tokens
dropped): the output, the aux loss and every gradient, the gate's
included; whole tiny models under expert, expert x model and expert x
fsdp against their dense twins; the specs of every family against
JAX's; a planted fault that skips the gate's sum over expert; and the
config's expert checks, with JAX's messages.  fp32, one intra-op thread
per rank; tolerances beside each case."""

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
    get_model as jax_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    moe as j_moe,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.bert import (
    pp_tp_param_specs as jax_pp_tp_param_specs,
    tp_param_specs as jax_tp_param_specs,
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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    moe as t_moe,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.bert import (
    pp_tp_param_specs,
    tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    ep as t_ep,
    tp as t_tp,
)

H, E, F, B, T = 32, 4, 64, 2, 16
# fp32 on both sides, sums in another order (test_torch_moe.py's ATOL)
ATOL = 1e-4
# the aux loss at weight 1, so its gradients through the gate are held as
# tightly as the rest
AUX_W = 1.0
# the whole-model checks: the grid's gates (test_torch_tp.py)
LOGITS_ATOL, GRAD_ATOL = 1e-5, 2e-4
VOCAB, SEQ = 96, 16
# (mesh of 4 ranks, job axes) of the MoE layer cases; an expert line of 2
# runs twice (data=2) in the 4-rank world
LAYER_AXES = {"ep": {"data": 2, "expert": 2},
              "ep_tp": {"data": 1, "expert": 2, "model": 2}}
CAPACITY = (1.25, 0.5)
MODEL_AXES = {"ep": {"data": 2, "expert": 2},
              "ep_tp": {"data": 1, "expert": 2, "model": 2},
              "ep_fsdp": {"data": 1, "fsdp": 2, "expert": 2}}
FAMILIES = {"bert": ("bert_tiny", {}), "gpt": ("gpt_tiny", {}),
            "llama": ("llama_tiny", {"num_kv_heads": 2}),
            "vit": ("vit_tiny", {})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer_inputs(seed: int = 0):
    """JAX MoEFFN's parameters (its init) and the input and cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H)).astype(np.float32)
    do = rng.normal(size=(B, T, H)).astype(np.float32)
    params = j_moe.MoEFFN(num_experts=E, ffn_dim=F).init(
        jax.random.key(seed), jnp.asarray(x))["params"]
    flat = {"gate": np.asarray(params["gate"]["kernel"]),
            **{k: np.asarray(params[k]) for k in ("w1", "b1", "w2", "b2")}}
    # nonzero biases, so their gradients and b2's 1/tp scale show
    for k in ("b1", "b2"):
        flat[k] = rng.normal(size=flat[k].shape).astype(np.float32) * 0.1
    return flat, x, do


def _jax_params(flat):
    return {"gate": {"kernel": jnp.asarray(flat["gate"])},
            **{k: jnp.asarray(flat[k]) for k in ("w1", "b1", "w2", "b2")}}


def _jax_layer_run(devices, which, cf, flat, x, do):
    """JAX's MoEFFN under shard_map on ``which``'s mesh (2 or 2 x 2 CPU
    devices): the output, the aux loss and the gradients of ``sum(out *
    do) + AUX_W * aux`` (whole leaves, JAX layout)."""
    ep_tp = which == "ep_tp"
    names = ("expert", "model") if ep_tp else ("expert",)
    m = Mesh(np.array(devices[:4 if ep_tp else 2]).reshape(
        (2, 2) if ep_tp else (2,)), names)
    mod = j_moe.MoEFFN(num_experts=E, ffn_dim=F, capacity_factor=cf,
                       expert_axis="expert", ep_size=2,
                       **(dict(model_axis="model", tp_size=2) if ep_tp
                          else {}))
    params = _jax_params(flat)
    if ep_tp:
        specs = j_moe.with_expert_overlay(
            lambda p: jax_tp_param_specs(p, axis="model"))(
                {"moe": params})["moe"]
    else:
        specs = j_moe.ep_param_specs({"moe": params})["moe"]

    def fwd(p, x):
        y, mut = mod.apply({"params": p}, x, mutable=["aux"])
        return y, jax.tree_util.tree_leaves(mut["aux"])[0]

    def loss(p, x, do):
        y, aux = fwd(p, x)
        return (y * do).sum() + AUX_W * aux

    f = jax.jit(jax.shard_map(fwd, mesh=m, in_specs=(specs, P()),
                              out_specs=(P(), P())))
    g = jax.jit(jax.grad(jax.shard_map(loss, mesh=m,
                                       in_specs=(specs, P(), P()),
                                       out_specs=P())))
    y, aux = f(params, jnp.asarray(x))
    grads = g(params, jnp.asarray(x), jnp.asarray(do))
    return (np.asarray(y), float(aux),
            {"gate": np.asarray(grads["gate"]["kernel"]),
             **{k: np.asarray(grads[k]) for k in ("w1", "b1", "w2", "b2")}})


def _spawn(tmp_path, jobs, n=4):
    spec = tmp_path / "jobs.pt"
    torch.save({"axes": jobs[0]["axes"], "jobs": jobs}, spec)
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, n, (store, str(spec), str(tmp_path)),
            ranks=range(n)), timeout_s=120.0)
    finally:
        mesh.remove_store(store)
    return [[torch.load(tmp_path / f"rank{r}-{i}.pt", weights_only=False)
             for r in range(n)] for i in range(len(jobs))]


def _model_job(name, kw, axes, seed):
    rng = np.random.default_rng(seed)
    model = get_model(name, num_classes=VOCAB, num_experts=E, **kw)
    model.init_parameters(torch.Generator().manual_seed(seed))
    x = rng.integers(0, VOCAB, (4, SEQ)).astype(np.int64)
    y = rng.integers(-1, VOCAB, (4, SEQ)).astype(np.int64)
    m = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    mesh_shape = ",".join(f"{a}={n}" for a, n in axes.items())
    return dict(model=name, vocab=VOCAB, axes=axes, x=x, y=y, m=m,
                kw=dict(kw, num_experts=E, moe_aux_weight=AUX_W,
                        mesh_shape=mesh_shape),
                state_dict={k: v.numpy() for k, v in
                            model.state_dict().items()})


@pytest.fixture(scope="module")
def ep_jobs(tmp_path_factory):
    """One spawn of 4 ranks: the MoE layer at each LAYER_AXES x CAPACITY
    case, then bert_tiny with 4 experts at each MODEL_AXES grid."""
    flat, x, do = _layer_inputs()
    layer = [dict(kind="moe", axes=LAYER_AXES[w], params=flat, x=x, do=do,
                  capacity_factor=cf, aux_weight=AUX_W)
             for w in LAYER_AXES for cf in CAPACITY]
    models = [_model_job("bert_tiny", {}, MODEL_AXES[w], i)
              for i, w in enumerate(MODEL_AXES)]
    out = _spawn(tmp_path_factory.mktemp("ep_jobs"), layer + models)
    cases = [(w, cf) for w in LAYER_AXES for cf in CAPACITY]
    return (dict(zip(cases, out[:len(layer)])),
            dict(zip(MODEL_AXES, out[len(layer):])), (flat, x, do))


@pytest.mark.parametrize("cf", CAPACITY, ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("which", sorted(LAYER_AXES))
def test_moe_layer_matches_jax_shard_map_and_dense(devices, ep_jobs, which,
                                                   cf):
    """JAX tests/test_moe.py:57-145 (and MoE x TP x EP): each rank's
    output and aux loss equal JAX's shard_map run of its expert-parallel
    MoEFFN, and each rank's gradients (its experts, its F slice; the
    gate whole) equal the matching slices of JAX's, at atol 1e-4; every
    error against the port's dense layer in the same rank within it too;
    with capacity factor 0.5 tokens are dropped."""
    layers, _models, (flat, x, do) = ep_jobs
    ranks = layers[(which, cf)]
    y, aux, grads = _jax_layer_run(devices, which, cf, flat, x, do)
    if cf < 1:
        dropped = np.abs(y).sum(-1) < 1e-6
        assert dropped.any(), "no token dropped at capacity factor 0.5"
    for r in ranks:
        assert max(r["errors"].values()) <= ATOL, r["errors"]
        np.testing.assert_allclose(r["out"], y, atol=ATOL)
        np.testing.assert_allclose(r["aux"], aux, atol=ATOL)
        for k, g in r["grads"].items():
            index = tuple(slice(a, b) for a, b in r["index"][k])
            np.testing.assert_allclose(g, grads[k][index], atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("which", sorted(MODEL_AXES))
def test_model_step_matches_dense_twin(ep_jobs, which):
    """bert_tiny with 4 experts (aux weight 1) on the expert grid: each
    rank's logits (its slice of the batch under fsdp) and the worker's
    joined gradients equal the dense twin's, whose fsdp slices route on
    their own (logits atol 1e-5, gradients 2e-4); the expert stacks are
    cut over expert (and fsdp claims a free dimension of other leaves);
    each rank's own aux loss equals the dense twin's over the same tokens
    (atol 1e-4), and every rank of an expert line computed the same."""
    _layers, models, _inputs = ep_jobs
    ranks = models[which]
    specs = ranks[0]["specs"]
    w1 = "['layers']['layer']['moe']['w1']"
    assert specs[w1][1] == "expert"
    if which == "ep_tp":
        assert specs[w1][3] == "model"
    if which == "ep_fsdp":
        assert any("fsdp" in s for k, s in specs.items() if "moe" not in k)
    for r in ranks:
        assert r["logits_err"] <= LOGITS_ATOL
        assert r["grads_err"] <= GRAD_ATOL
        assert r["aux_err"] <= ATOL, (r["aux"], r["dense_aux"])
    # ranks 0, 1 and 2, 3 share every coordinate but the expert one
    assert ranks[0]["aux"] == ranks[1]["aux"]
    assert ranks[2]["aux"] == ranks[3]["aux"]
    if which != "ep_fsdp":
        assert ranks[0]["aux"] == ranks[2]["aux"]


def _jax_specs(tree, params):
    specs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    return {jax.tree_util.keystr(k):
            tuple(list(s) + [None] * (shapes[k].ndim - len(s)))
            for k, s in specs}


@pytest.mark.parametrize("which", sorted(FAMILIES))
def test_specs_name_jax_dims(which):
    """``ep_param_specs``, ``pp_ep_param_specs`` and
    ``with_expert_overlay`` over the Megatron specs (and the pipe ones)
    shard the same dimensions of every family's leaves as JAX's, and the
    overlay refuses an expert dimension already sharded, with JAX's
    message."""
    name, kw = FAMILIES[which]
    vit = name.startswith("vit")
    ncls = 10 if vit else VOCAB
    x = (jnp.zeros((1, 32, 32, 3)) if vit
         else jnp.zeros((1, SEQ), jnp.int32))
    params = jax_get_model(name, num_classes=ncls, scan_layers=True,
                           num_experts=E, **kw).init(
                               jax.random.key(0), x)["params"]
    shapes = weights.param_leaf_shapes(get_model(
        name, num_classes=ncls, num_experts=E, **kw))
    assert shapes == {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(params)[0]}
    cases = [
        (t_moe.ep_param_specs(shapes),
         j_moe.ep_param_specs(params)),
        (t_moe.pp_ep_param_specs(shapes),
         j_moe.pp_ep_param_specs(params)),
        (t_moe.with_expert_overlay(tp_param_specs(shapes)),
         j_moe.with_expert_overlay(jax_tp_param_specs)(params)),
        (t_moe.with_expert_overlay(pp_tp_param_specs(shapes)),
         j_moe.with_expert_overlay(jax_pp_tp_param_specs)(params)),
    ]
    for got, want in cases:
        assert got == _jax_specs(want, params)
    assert got["['layers']['layer']['moe']['w1']"] == (
        "pipe", "expert", None, "model")
    with pytest.raises(ValueError) as ours:
        t_moe.with_expert_overlay(t_moe.ep_param_specs(shapes))
    with pytest.raises(ValueError) as theirs:
        j_moe.with_expert_overlay(
            lambda p: j_moe.ep_param_specs(p))(params)
    assert str(ours.value) == str(theirs.value)


class _KeepOwn(torch.autograd.Function):
    """The planted fault: the gate's f marker runs its all-reduce over the
    expert line (so the peer does not wait) but keeps this rank's own
    share of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        t_tp.all_reduce(g.contiguous(), ctx.group, stats=t_ep.STATS)
        return g, None


def test_skipping_the_gate_sum_fails_the_gate_gradient_check(tmp_path,
                                                             monkeypatch):
    """A planted fault: rank 0 (this process) keeps its own experts' share
    of the gate's combine-path gradient (the f marker's sum over expert
    skipped); its gate gradient leaves the dense one by far more than
    the gate (atol 1e-4) while every other leaf and the output stay
    within it; rank 1, unpatched, stays right."""
    real = t_ep.enter

    def planted(x, ep, tp):
        if x.ndim == 1 and ep is not None:      # the gate [N]
            return _KeepOwn.apply(x, ep)
        return real(x, ep, tp)

    monkeypatch.setattr(t_ep, "enter", planted)
    flat, x, do = _layer_inputs()
    job = dict(kind="moe", axes={"data": 1, "expert": 2}, params=flat, x=x,
               do=do, capacity_factor=1.25, aux_weight=AUX_W, summary=True)
    spec = tmp_path / "jobs.pt"
    torch.save({"axes": job["axes"], "jobs": [job]}, spec)
    with t_driver.SharedStart(2, [(grid_harness.module_worker,
                                   (str(spec), str(tmp_path)))]) as start:
        start.run()
    ranks = [torch.load(tmp_path / f"rank{r}-0.pt", weights_only=False)
             for r in range(2)]
    bad, good = ranks[0]["errors"], ranks[1]["errors"]
    assert bad["gate"] > 100 * ATOL, bad
    assert max(v for k, v in bad.items() if k != "gate") <= ATOL, bad
    assert max(good.values()) <= ATOL, good


@pytest.mark.parametrize("flags,match", [
    (["--model", "bert_tiny", "--mesh_shape", "data=1,expert=2"],
     "mesh has an 'expert' axis but --num_experts is 0"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,expert=4",
      "--num_experts", "6"],
     "num_experts 6 not divisible by expert-parallel size 4"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,expert=2,model=3",
      "--num_experts", "4"],
     r"ffn_dim 128 not divisible by tp_size 3 \(column-parallel expert"),
    (["--mesh_shape", "data=1,expert=2", "--num_experts", "4"],
     "--num_experts applies to attention models"),
    # elastic membership runs under an expert axis, as in JAX
    # (tests/test_torch_grid_chaos_axes.py)
    (["--model", "bert_tiny", "--mesh_shape", "data=2,expert=2",
      "--num_experts", "4", "--chaos", "kill@1:w1"], None),
], ids=["axis_without_experts", "experts_not_divisible", "model_axis",
        "cnn", "chaos"])
def test_config_expert_checks(flags, match):
    """JAX's checks of the expert axis (driver.py:583-615, models/moe.py:
    71-79) with its messages, at the config; --chaos under an expert axis
    is taken by the port's Config and by JAX's (match None)."""
    if match is None:
        cfg = t_config.config_from_args(["--device", "cpu", *flags])
        j_config.config_from_args(["--device", "cpu", *flags])
        assert cfg.inner_axes() == {"expert": 2} and cfg.chaos
        return
    with pytest.raises(ValueError, match=match):
        t_config.config_from_args(["--device", "cpu", *flags])


def test_moe_ffn_dim_must_divide_over_model():
    """The MoE layer's own checks of E over the expert line and F over the
    model line, with JAX's messages (models/moe.py:71-79)."""

    class Line:
        world_size, rank = 3, 0
    with pytest.raises(ValueError, match="ffn_dim 64 not divisible by "
                       "tp_size 3"):
        t_moe.MoEFFN(8, 4, 64, tp=Line())
    with pytest.raises(ValueError, match="num_experts 4 not divisible by "
                       "expert-parallel size 3"):
        t_moe.MoEFFN(8, 4, 64, ep=Line())


def _gpt_kw(**extra):
    """gpt_tiny with 4 experts, 2 rounds (the JAX test_moe.py driver
    config on the decoder, which ``main serve`` serves)."""
    return dict(model="gpt_tiny", dataset="synthetic_lm", epochs_global=2,
                epochs_local=1, batch_size=8, limit_train_samples=128,
                limit_eval_samples=32, compute_dtype="float32",
                augment=False, aggregation_by="weights", seed=9,
                num_experts=E, proportionality="uniform", probe_batches=1,
                **extra)


def _run(axes, **extra):
    cfg = t_config.Config(device="cpu", log_level="WARNING",
                          mesh_shape=",".join(f"{a}={n}"
                                              for a, n in axes.items()),
                          **_gpt_kw(**extra))
    n = mesh.world_size_of(mesh.grid_axes(cfg))
    if n == 1:
        return t_driver.train_global(cfg, progress=False)
    return t_driver.run_group(cfg, n, train_kwargs=dict(progress=False))


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    """gpt_tiny with 4 experts at data=1 and at data=1,expert=2, each
    writing a checkpoint a round."""
    dirs = {k: tmp_path_factory.mktemp(f"ckpt_{k}") for k in ("twin", "ep")}
    return {"twin": _run({"data": 1}, checkpoint_dir=str(dirs["twin"]),
                         checkpoint_every=1),
            "ep": _run({"data": 1, "expert": 2},
                       checkpoint_dir=str(dirs["ep"]), checkpoint_every=1),
            "dirs": dirs}


def test_ep_checkpoint_restores_bitwise_on_data_only(ckpt_runs):
    """The data=1,expert=2 checkpoint holds each expert stack in 2 pieces
    (each rank's experts, at their global index on dim 1 behind the
    layers) and every other leaf once (expert rank 0 writes it), and
    restores on data=1 with the worker's parameters bitwise; the run
    itself equals its data=1 twin (rtol 2e-3)."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        checkpoint as t_checkpoint,
    )
    np.testing.assert_allclose(ckpt_runs["ep"]["global_train_losses"],
                               ckpt_runs["twin"]["global_train_losses"],
                               rtol=2e-3)
    path = str(ckpt_runs["dirs"]["ep"] / "ckpt_2")
    manifest = t_checkpoint.read_manifest(path)
    assert manifest["process_count"] == 2
    payloads = list(t_checkpoint.verified_shards(path, manifest))
    w1 = ".params['layers']['layer']['moe']['w1']"
    assert sum(w1 in p["leaves"] for p in payloads) == 2
    assert sum(".params['layers']['layer']['moe']['gate']['kernel']"
               in p["leaves"] for p in payloads) == 1
    res = _run({"data": 1}, checkpoint_dir=str(ckpt_runs["dirs"]["ep"]),
               resume=True)
    assert res["round_timings"] == []
    for name, t in ckpt_runs["ep"]["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)


def test_data_only_checkpoint_restores_bitwise_on_ep(ckpt_runs):
    """The data=1 checkpoint restores on data=1,expert=2: each rank takes
    its experts, and the worker's parameters come back whole, bitwise."""
    res = _run({"data": 1, "expert": 2},
               checkpoint_dir=str(ckpt_runs["dirs"]["twin"]), resume=True)
    assert res["round_timings"] == []
    for name, t in ckpt_runs["twin"]["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)


def test_main_serve_loads_an_ep_trained_checkpoint(ckpt_runs):
    """``main serve`` off the data=1,expert=2 checkpoint: the model is
    rebuilt whole from the expert pieces into the capacity-free MoE decode
    and serves greedy requests whose first token is the argmax of a full
    forward of the trained parameters at a capacity that drops no token."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        main as t_main,
    )
    res = t_main.run(["serve", "--device", "cpu", "--checkpoint_dir",
                      str(ckpt_runs["dirs"]["ep"]), "--serve_max_batch",
                      "2", "--serve_page_size", "4", "--serve_max_pages",
                      "40", "--serve_prompt_buckets", "8,16",
                      "--serve_requests", "2", "--serve_max_new_tokens", "3",
                      "--serve_prompt", "1,2,3,4,5"])
    outs = [list(c.tokens) for c in res["completions"]]
    want = ckpt_runs["ep"]
    model = get_model("gpt_tiny", num_classes=want["model"].num_classes,
                      num_experts=E, capacity_factor=float(E))
    model.load_state_dict({k: v.cpu() for k, v in want["variables"].items()})
    with torch.no_grad():
        first = int(model(torch.tensor([[1, 2, 3, 4, 5]]))[0, -1].argmax())
    assert len(outs) == 2 and all(o[0] == first for o in outs), (outs,
                                                                 first)
