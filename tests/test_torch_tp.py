"""Tensor parallelism over the ``model`` axis of the port's rank grid
(``..._torch/parallel/tp.py``, the models' TP shards, ``mesh.Grid``)
against the JAX package's ``parallel/tp.py`` and the port's own dense
twin: the Megatron specs, one forward and backward of bert_tiny, a 2-layer
gpt (vocab-parallel tied head) and llama with GQA on 2 gloo ranks fed the
JAX parameters through ``weights.shard_params``, the vocab-parallel
statistics, and the driver through ``main.run --device cpu`` (the JAX
``test_tp.py`` cases, checkpoints across meshes, flash on the head
shards).  Tolerances are written beside each case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
    checkpoint as j_checkpoint,
    config as j_config,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as jax_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.bert import (
    tp_param_specs as jax_tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.fsdp import (
    add_fsdp_axis as jax_add_fsdp_axis,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.tp import (
    vocab_parallel_token_stats as jax_vp_stats,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.train import (
    masked_token_stats as jax_masked_token_stats,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    checkpoint as t_checkpoint,
    config as t_config,
    driver as t_driver,
    grid_harness,
    main as t_main,
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.bert import (
    tp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    fsdp as t_fsdp,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
    masked_token_stats,
)

VOCAB = 96          # divisible by tp 2 (the vocab-parallel heads)
SEQ = 16
# (registry name, extra model kwargs): a 2-layer gpt with the tied head
# sharded, llama with 4 query heads over 2 K/V heads (1 K/V head a shard)
MODELS = {"bert": ("bert_tiny", {}), "gpt": ("gpt_tiny", {}),
          "llama": ("llama_tiny", {"num_kv_heads": 2})}
# logits: the TP products sum the same terms in another order (fp32)
LOGITS_ATOL = 1e-5
# parameter gradients: JAX's own gate (test_tp.py)
GRAD_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank(tmp_path_factory):
    """One intra-op thread here and in the spawned ranks (the suite runs
    beside other test processes); the runs' plots go to a temporary
    directory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    PLOTS[:] = [str(tmp_path_factory.mktemp("plots"))]
    yield
    torch.set_num_threads(threads)


PLOTS = [""]


def _spec_tuple(spec, ndim):
    return tuple(list(spec) + [None] * (ndim - len(spec)))


def _jax_specs(tree, params):
    specs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    return {jax.tree_util.keystr(k): _spec_tuple(s, shapes[k].ndim)
            for k, s in specs}


def _jax_model(name, kw, **extra):
    return jax_get_model(name, num_classes=VOCAB, scan_layers=True, **kw,
                         **extra)


def _jax_params(name, kw, seed):
    model = _jax_model(name, kw)
    return model.init(jax.random.key(seed),
                      jnp.zeros((1, SEQ), jnp.int32))["params"]


@pytest.mark.parametrize("which", sorted(MODELS))
def test_specs_name_jax_dims(which):
    """``tp_param_specs`` (and ``add_fsdp_axis`` over it, the 2-D
    composition) on the port's leaves, mapped into the JAX layout by
    ``weights.param_leaf_shapes``, shard the same dimensions as JAX's on
    the same model's parameters."""
    name, kw = MODELS[which]
    gpt = which == "gpt"
    params = _jax_params(name, kw, 0)
    shapes = weights.param_leaf_shapes(get_model(name, num_classes=VOCAB,
                                                 **kw))
    want_shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                   jax.tree_util.tree_flatten_with_path(params)[0]}
    assert shapes == want_shapes
    ours = tp_param_specs(shapes, "model", shard_tok_emb=gpt)
    want = _jax_specs(jax_tp_param_specs(params, axis="model",
                                         shard_tok_emb=gpt), params)
    assert ours == want
    assert sum("model" in s for s in ours.values()) >= 2 * 3
    both = t_fsdp.add_fsdp_axis(ours, shapes, axis="fsdp", axis_size=2)
    want2 = _jax_specs(jax_add_fsdp_axis(
        jax_tp_param_specs(params, axis="model", shard_tok_emb=gpt), params,
        axis="fsdp", axis_size=2), params)
    assert both == want2


def test_shard_params_and_join_shards_round_trip():
    """``weights.shard_params`` cuts JAX's numpy parameters of bert_tiny
    for each rank of an fsdp=2 x model=2 block by the 2-D specs (each
    shard the slice at its ``shard_index``), and ``join_shards`` puts the
    four back together exactly."""
    params = _jax_params("bert_tiny", {}, 0)
    full = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    shapes = {k: v.shape for k, v in full.items()}
    specs = t_fsdp.add_fsdp_axis(tp_param_specs(shapes, "model"), shapes,
                                 axis="fsdp", axis_size=2)
    shards = []
    for f in range(2):
        for t in range(2):
            coords = {"fsdp": (f, 2), "model": (t, 2)}
            part = weights.shard_params(full, specs, coords)
            for k, a in part.items():
                index = weights.shard_index(shapes[k], specs[k], coords)
                np.testing.assert_array_equal(
                    a, full[k][tuple(slice(i, j) for i, j in index)])
            shards.append((coords, part))
    qkv = "['layers']['layer']['attn']['qkv']['kernel']"
    assert shards[0][1][qkv].size == full[qkv].size // 4
    joined = weights.join_shards(shards, specs, {"fsdp": 2, "model": 2})
    for k, a in full.items():
        np.testing.assert_array_equal(joined[k], a, err_msg=k)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (4, SEQ)).astype(np.int64)
    y = rng.integers(-1, VOCAB, (4, SEQ)).astype(np.int64)
    m = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    return x, y, m


def _jax_tp_run(name, kw, params, x, y, m, gpt):
    """JAX's TP module on 2 virtual devices: the whole logits (the local
    vocab slices stitched) and the gradients of the masked mean CE through
    ``vocab_parallel_token_stats``."""
    mesh_ = Mesh(np.array(jax.devices()[:2]), ("model",))
    tp = _jax_model(name, kw, tp_size=2, model_axis="model")
    specs = jax_tp_param_specs(params, axis="model", shard_tok_emb=gpt)
    fwd = jax.jit(jax.shard_map(
        lambda p, x: tp.apply({"params": p}, x), mesh=mesh_,
        in_specs=(specs, P()), out_specs=P(None, None, "model")))

    def loss(p, x, y, m):
        logits = tp.apply({"params": p}, x)
        ce, w, _ = jax_vp_stats(logits, y, m, "model")
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    grad = jax.jit(jax.grad(jax.shard_map(
        loss, mesh=mesh_, in_specs=(specs, P(), P(), P()), out_specs=P())))
    args = (jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
            jnp.asarray(m))
    g = grad(params, *args)
    return (np.asarray(fwd(params, args[0])),
            {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(g)[0]})


def _spawn(tmp_path, axes, jobs, n):
    spec = tmp_path / "jobs.pt"
    torch.save({"axes": axes, "jobs": jobs}, spec)
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, n, (store, str(spec), str(tmp_path)),
            ranks=range(n)), timeout_s=120.0)
    finally:
        mesh.remove_store(store)
    return [[torch.load(tmp_path / f"rank{r}-{i}.pt", weights_only=False)
             for r in range(n)] for i in range(len(jobs))]


@pytest.fixture(scope="module")
def tp_jobs(tmp_path_factory):
    """One spawn of 2 ranks (data=1, model=2) running the three models'
    module jobs and the vocab-parallel statistics job; with each model's
    JAX parameters and batch."""
    d = tmp_path_factory.mktemp("tp_jobs")
    jobs, inputs = [], {}
    for i, which in enumerate(sorted(MODELS)):
        name, kw = MODELS[which]
        params = _jax_params(name, kw, i)
        x, y, m = _batch(i)
        inputs[which] = (params, x, y, m)
        jobs.append(dict(model=name, vocab=VOCAB, kw=kw, x=x, y=y, m=m,
                         state_dict=weights.flax_to_torch(params)))
    rng = np.random.default_rng(3)
    vocab = dict(kind="vocab",
                 logits=rng.normal(size=(4, 8, VOCAB)).astype(np.float32),
                 labels=rng.integers(-1, VOCAB, (4, 8)),
                 mask=np.array([1.0, 1.0, 0.0, 1.0], np.float32))
    vit = get_model("vit_tiny", num_classes=10)
    vit.init_parameters(torch.Generator().manual_seed(0))
    vit_job = dict(model="vit_tiny", vocab=10, shape=(32, 32, 3),
                   state_dict={k: v.numpy() for k, v in
                               vit.state_dict().items()},
                   x=rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                   y=rng.integers(0, 10, 4), m=np.ones(4, np.float32))
    out = _spawn(d, {"data": 1, "model": 2}, jobs + [vocab, vit_job], 2)
    return (dict(zip(sorted(MODELS) + ["vocab", "vit"], out)), inputs,
            vocab)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_module_matches_jax_shard_map_and_dense_twin(tp_jobs, which):
    """The port's TP module on 2 gloo ranks: the stitched local logits
    (atol 1e-5) and the joined parameter gradients (atol 2e-4, JAX's gate)
    equal JAX's shard_map run of its TP module on the same parameters,
    and the port's dense twin in the same ranks; every rank computed the
    same loss."""
    results, inputs, _ = tp_jobs
    ranks = results[which]
    params, x, y, m = inputs[which]
    name, kw = MODELS[which]
    logits = np.concatenate([r["logits"] for r in ranks], axis=-1)
    want_logits, want_grads = _jax_tp_run(name, kw, params, x, y, m,
                                          which == "gpt")
    np.testing.assert_allclose(logits, want_logits, atol=LOGITS_ATOL)
    np.testing.assert_allclose(logits, ranks[0]["dense_logits"],
                               atol=LOGITS_ATOL)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], ranks[0]["dense_loss"],
                               rtol=1e-6)
    grads = ranks[0]["grads"]
    assert set(grads) == set(want_grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g, want_grads[key], atol=GRAD_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][key],
                                   atol=GRAD_ATOL, err_msg=key)
        np.testing.assert_array_equal(g, ranks[1]["grads"][key])


def test_vit_tp_blocks_match_the_dense_twin(tp_jobs):
    """ViT under TP (JAX's vit.py wires BERT's EncoderLayer): the blocks
    on their head and FFN shards, the patch embedding, position table and
    classifier replicated, so every rank's logits are whole: they equal
    the dense twin's (atol 1e-5) on both ranks, and the joined gradients
    equal its gradients (atol 2e-4)."""
    results, _, _ = tp_jobs
    ranks = results["vit"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"], r["dense_logits"],
                                   atol=LOGITS_ATOL)
    specs = ranks[0]["specs"]
    assert specs["['pos_emb']"] == (None, None, None)
    assert "model" in specs["['layers']['layer']['attn']['qkv']['kernel']"]
    for key, g in ranks[0]["grads"].items():
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][key],
                                   atol=GRAD_ATOL, err_msg=key)


def test_vocab_parallel_stats_match_dense_and_jax(tp_jobs):
    """``vocab_parallel_token_stats`` over the two vocab slices equals
    ``masked_token_stats`` on the whole logits and JAX's vocab-parallel
    stats under shard_map (ce atol 1e-5, weights and the correct count
    exactly, ignore-index labels and a masked row included), and the
    gradient of the masked mean CE equals the dense one (atol 1e-6)."""
    results, _, job = tp_jobs
    ranks = results["vocab"]
    logits = torch.from_numpy(job["logits"]).requires_grad_()
    labels = torch.from_numpy(job["labels"])
    mask = torch.from_numpy(job["mask"])
    ce, w, correct = masked_token_stats(logits, labels, mask)
    (g,) = torch.autograd.grad((ce * w).sum() / w.sum(), logits)
    mesh_ = Mesh(np.array(jax.devices()[:2]), ("model",))
    jl, jy, jm = (jnp.asarray(job["logits"]),
                  jnp.asarray(job["labels"], jnp.int32),
                  jnp.asarray(job["mask"]))
    j_ce, j_w, j_correct = jax.jit(jax.shard_map(
        lambda lg: jax_vp_stats(lg, jy, jm, "model"), mesh=mesh_,
        in_specs=P(None, None, "model"), out_specs=(P(), P(), P())))(jl)
    ref = jax_masked_token_stats(jl, jy, jm)
    for r in ranks:
        np.testing.assert_allclose(r["ce"], ce.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(r["ce"], np.asarray(j_ce), atol=1e-5)
        np.testing.assert_array_equal(r["w"], w.numpy())
        assert r["correct"] == float(correct) == float(j_correct)
        assert r["correct"] == float(ref[2])
    grad = np.concatenate([r["grad"] for r in ranks], axis=-1)
    np.testing.assert_allclose(grad, g.numpy(), atol=1e-6)


def _argv(*extra):
    return ["--device", "cpu", "--model", "bert_tiny", "--dataset",
            "synthetic_mlm", "--epochs_global", "2", "--epochs_local", "1",
            "--batch_size", "8", "--limit_train_samples", "128",
            "--limit_eval_samples", "32", "--compute_dtype", "float32",
            "--no_augment", "--aggregation_by", "weights", "--seed", "7",
            # the partition by share, not by the measured probe: the two
            # runs then train on the same shards
            "--proportionality", "uniform", "--probe_batches", "1",
            "--log_level", "WARNING", "--out_dir", PLOTS[0], *extra]


@pytest.fixture(scope="module")
def dp_run():
    return t_main.run(_argv("--num_workers", "2"))


def test_driver_tp_matches_data_only_run(dp_run):
    """JAX test_tp.py:181-186: bert_tiny on data=2,model=2 (4 processes)
    against the data=2 run, global train and val losses at rtol 2e-3,
    and the loss falls; the grid reports its axes, 4 ranks and each
    rank's TP all-reduces."""
    tp = t_main.run(_argv("--mesh_shape", "data=2,model=2"))
    np.testing.assert_allclose(tp["global_train_losses"],
                               dp_run["global_train_losses"], rtol=2e-3)
    np.testing.assert_allclose(tp["global_val_losses"],
                               dp_run["global_val_losses"], rtol=2e-3)
    assert tp["global_train_losses"][-1] < tp["global_train_losses"][0]
    assert tp["grid"]["axes"] == {"data": 2, "model": 2}
    assert tp["grid"]["ranks"] == 4
    assert all(s["calls"] > 0 for s in tp["grid"]["tp"])
    # the final evaluation's dense twin holds the whole parameters
    assert (tp["variables"]["blocks.0.attn.qkv.weight"].shape
            == dp_run["variables"]["blocks.0.attn.qkv.weight"].shape)
    assert tp["test_eval"]["loss"] == pytest.approx(
        dp_run["test_eval"]["loss"], rel=2e-3)


def test_driver_tp_gradients_mode_is_finite():
    """JAX test_tp.py:188-203: aggregation_by gradients under TP, whose
    aggregated-gradient norm sums the sharded leaves' squares over
    ``model`` and counts the replicated ones once."""
    res = t_main.run(_argv("--mesh_shape", "data=2,model=2",
                           "--aggregation_by", "gradients",
                           "--epochs_global", "1"))
    assert np.isfinite(res["global_train_losses"]).all()


@pytest.mark.parametrize("flags,match", [
    (["--model", "mlp", "--dataset", "mnist", "--mesh_shape",
      "data=2,model=2"], "attention models"),
    (["--model", "bert_tiny", "--mesh_shape", "data=1,seq=2,model=2",
      "--sequence_parallel", "ring_zigzag"], "CAUSAL"),
    # the pipe axis and the --pp_* flags run as JAX runs them: accepted
    (["--model", "bert_tiny", "--mesh_shape", "data=1,pipe=2"], None),
    # the expert axis runs with experts (tests/test_torch_ep.py); without
    # them it is refused as JAX refuses it; MoE x TP runs: accepted
    (["--model", "bert_tiny", "--mesh_shape", "data=1,expert=2"],
     "mesh has an 'expert' axis but --num_experts is 0"),
    (["--model", "bert_tiny", "--num_experts", "4", "--mesh_shape",
      "data=1,model=2"], None),
    # elastic membership and staleness run on the grid, as in JAX
    # (tests/test_torch_grid_elastic.py, test_torch_grid_staleness.py)
    (["--model", "bert_tiny", "--mesh_shape", "data=2,model=2",
      "--chaos", "kill@1:w1"], None),
    (["--model", "bert_tiny", "--mesh_shape", "data=2,model=2",
      "--aggregation_by", "weights", "--sync_staleness", "1"], None),
    (["--model", "bert_tiny", "--mesh_shape", "data=2,model=2",
      "--num_workers", "3"], "disagree"),
    (["--model", "bert_tiny", "--sequence_parallel", "ring"],
     "needs a 'seq' mesh axis"),
    (["--model", "bert_tiny", "--pp_microbatches", "2"], None),
], ids=["mlp_under_model", "seq", "pipe", "expert", "moe", "chaos",
        "staleness", "num_workers", "sequence_parallel", "pp"])
def test_config_refusals(flags, match):
    """JAX test_tp.py:205-213 (an mlp under ``model`` is refused), an
    expert axis without experts refused with JAX's message, the zig-zag
    ring on bert over seq x model and --sequence_parallel without a seq
    axis refused (tests/test_torch_sp.py has the rest of SP's refusals);
    a pipe axis, MoE under model, --pp_microbatches without a pipe axis
    (inert, as in JAX), --chaos and --sync_staleness under model are
    accepted (match None) by the port's Config and by JAX's, on the
    flag's grid (tests/test_torch_pp.py has the pipe refusals)."""
    if match is None:
        cfg = t_config.config_from_args(["--device", "cpu", *flags])
        j_config.config_from_args(["--device", "cpu", *flags])
        shape = (flags[flags.index("--mesh_shape") + 1]
                 if "--mesh_shape" in flags else "data=1")
        assert mesh.grid_axes(cfg) == {
            a: int(n) for a, n in (kv.split("=") for kv in shape.split(","))}
        return
    with pytest.raises(ValueError, match=match):
        t_config.config_from_args(["--device", "cpu", *flags])


def test_model_axis_needs_divisible_heads():
    """The models' checks (JAX bert.py:56-73): 4 heads over a model axis
    of 3 is refused when the shard is built."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.mesh import (
        Group,
    )
    with pytest.raises(ValueError, match="not divisible by tp_size 3"):
        get_model("bert_tiny", num_classes=96,
                  tp=Group(0, 3, torch.device("cpu")))


def test_driver_tp_flash_on_head_shards():
    """--attention_impl flash under TP on the CPU: each rank runs the
    kernels' plain versions on its 2 of bert_tiny's 4 heads; the losses
    equal the one-worker flash run's at rtol 2e-3."""
    argv = ["--attention_impl", "flash", "--epochs_global", "1"]
    one = t_main.run(_argv(*argv))
    tp = t_main.run(_argv(*argv, "--mesh_shape", "data=1,model=2"))
    np.testing.assert_allclose(tp["global_train_losses"],
                               one["global_train_losses"], rtol=2e-3)


@pytest.fixture(scope="module")
def tp_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_tp")
    res = t_main.run(_argv("--mesh_shape", "data=2,model=2",
                           "--epochs_global", "1", "--checkpoint_dir",
                           str(d), "--checkpoint_every", "1"))
    return d, res


def _resume(d, *mesh_flags):
    # epochs_global 1 with the epoch-1 checkpoint: no round runs, so the
    # results hold what was restored (the driver alone: no plots of a run
    # without rounds)
    cfg = t_config.config_from_args(_argv(
        *mesh_flags, "--epochs_global", "1", "--checkpoint_dir", str(d),
        "--resume"))
    return t_driver.run_group(cfg, mesh.world_size_of(mesh.grid_axes(cfg)))


@pytest.mark.parametrize("mesh_flags", [
    ("--num_workers", "2"), ("--mesh_shape", "data=2,fsdp=2")],
    ids=["data2", "data2_fsdp2"])
def test_checkpoint_restores_bitwise_across_meshes(tp_checkpoint,
                                                   mesh_flags):
    """A data=2,model=2 checkpoint (every rank's pieces at their global
    index, replicated leaves once) restores bitwise at data=2 and at
    data=2,fsdp=2: worker 0's parameters equal the saved ones, and at
    fsdp the rank's Adam moments are its shard of the saved ones."""
    d, saved = tp_checkpoint
    path = str(d / "ckpt_1")
    manifest = t_checkpoint.read_manifest(path)
    assert manifest["process_count"] == 4
    # the model-axis shards of a sharded leaf come from two ranks
    payloads = list(t_checkpoint.verified_shards(path, manifest))
    key = ".params['layers']['layer']['attn']['qkv']['kernel']"
    assert sum(key in p["leaves"] for p in payloads) == 4
    assert sum(".lr_epoch" in p["leaves"] for p in payloads) == 2
    res = _resume(d, *mesh_flags)
    for name, t in saved["variables"].items():
        np.testing.assert_array_equal(res["variables"][name].cpu().numpy(),
                                      t.cpu().numpy(), err_msg=name)
    if "fsdp" in mesh_flags[-1]:
        assert res["grid"]["axes"] == {"data": 2, "fsdp": 2}
        full, _ = t_checkpoint.host_tree(
            path, keep=lambda k: k.startswith(".opt_state.mu"))
        mu = {k[len(".opt_state.mu"):]: v[0] for k, v in full.items()}
        keys = list(weights.jax_param_leaves(
            saved["variables"], weights.state_layout(saved["model"])))
        specs = t_fsdp.fsdp_param_specs({k: mu[k].shape for k in keys},
                                        axis_size=2)
        want = weights.shard_params({k: mu[k] for k in keys}, specs,
                                    {"fsdp": (0, 2)})
        for k, t in zip(keys, res["state"].opt.mu):
            np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_jax_template_free_loader_reads_tp_pieces(tp_checkpoint):
    """JAX ``checkpoint.host_tree`` merges the port's TP pieces into the
    dense tree in JAX's layout: row 0 of every ``.params`` leaf equals the
    port's joined parameters of worker 0."""
    d, saved = tp_checkpoint
    tree, epoch = j_checkpoint.host_tree(str(d / "ckpt_1"))
    assert epoch == 1
    ours = weights.jax_param_leaves(
        {k: v for k, v in saved["variables"].items()},
        weights.state_layout(saved["model"]))
    for key, arr in ours.items():
        np.testing.assert_array_equal(tree[f".params{key}"][0], arr,
                                      err_msg=key)
    assert tree[".lr_epoch"].tolist() == [1, 1]
