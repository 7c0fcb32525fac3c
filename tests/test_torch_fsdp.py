"""ZeRO-3 / FSDP over the ``fsdp`` axis of the port's rank grid
(``..._torch/parallel/fsdp.py``, ``parallel/shards.py``) against the JAX
package's ``parallel/fsdp.py`` and the port's own data-only twin: the specs
on the JAX layout of image and transformer leaves, the gather and its
reduce-scatter on 2 gloo ranks, the driver through ``main.run --device
cpu`` (the JAX ``test_fsdp.py`` cases: mlp, bert_tiny, a BatchNorm model,
augmentation, the batch check, the (fsdp, model) composition) and the
sharded sync engine under inner axes, bitwise the dense one in fp32.
Tolerances are written beside each case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as jax_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.parallel.fsdp import (
    MIN_SHARD_ELEMS as JAX_MIN_SHARD_ELEMS,
    fsdp_param_specs as jax_fsdp_param_specs,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    config as t_config,
    grid_harness,
    main as t_main,
    mesh,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.parallel import (
    fsdp as t_fsdp,
)

PLOTS = [""]


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


@pytest.mark.parametrize("name,shape,kw", [
    ("mlp", (28, 28, 1), {}),
    ("enhanced_cnn", (32, 32, 3), {"width": 8}),
    ("bert_tiny", (16,), {}),
], ids=["mlp", "cnn", "bert_tiny"])
def test_specs_match_jax_on_its_layout(name, shape, kw):
    """``fsdp_param_specs`` on the port's leaves in the JAX layout
    (``weights.param_leaf_shapes``: Dense [in, out], conv HWIO, the
    stacked layers) shards the same dimension of the same leaves as JAX's
    on the same model: large leaves on their first divisible dimension,
    small ones replicated."""
    assert t_fsdp.MIN_SHARD_ELEMS == JAX_MIN_SHARD_ELEMS
    jkw = dict(kw, scan_layers=True) if name.startswith("bert") else kw
    num_classes = 96 if name.startswith("bert") else 10
    jmodel = jax_get_model(name, num_classes=num_classes, **jkw)
    x = (jnp.zeros((1, *shape), jnp.int32) if name.startswith("bert")
         else jnp.zeros((2, *shape), jnp.float32))
    # shapes only: the specs read nothing else (no init compiled)
    params = jax.eval_shape(lambda k: jmodel.init(k, x, train=False),
                            jax.random.key(0))["params"]
    want = {jax.tree_util.keystr(k): tuple(list(s) + [None] * (
        len(jax.tree_util.tree_flatten_with_path(params)[0][i][1].shape)
        - len(s))) for i, (k, s) in enumerate(
            jax.tree_util.tree_flatten_with_path(
                jax_fsdp_param_specs(params, axis="fsdp", axis_size=2),
                is_leaf=lambda s: isinstance(s, P))[0])}
    shapes = weights.param_leaf_shapes(get_model(
        name, num_classes=num_classes, **kw))
    ours = t_fsdp.fsdp_param_specs(shapes, axis="fsdp", axis_size=2)
    assert ours == want
    assert any("fsdp" in s for s in ours.values())


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    d = tmp_path_factory.mktemp("gather")
    rng = np.random.default_rng(0)
    leaves = {"['a']['kernel']": rng.normal(size=(256, 96)),
              "['a']['bias']": rng.normal(size=(96,)),
              "['b']['kernel']": rng.normal(size=(3, 3, 64, 64)),
              "['c']['odd']": rng.normal(size=(129, 129))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    job = dict(kind="gather", leaves=leaves,
               weights={k: rng.normal(size=v.shape).astype(np.float32)
                        for k, v in leaves.items()})
    cnn = get_model("enhanced_cnn", num_classes=10, width=8)
    cnn.init_parameters(torch.Generator().manual_seed(0))
    cnn_job = dict(model="enhanced_cnn", vocab=10, kw={"model_width": 8},
                   shape=(32, 32, 3),
                   state_dict={k: v.numpy() for k, v in
                               cnn.state_dict().items()},
                   x=rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                   y=rng.integers(0, 10, 8),
                   m=np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32))
    torch.save({"axes": {"data": 1, "fsdp": 2}, "jobs": [job, cnn_job]},
               d / "jobs.pt")
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, 2, (store, str(d / "jobs.pt"),
                                            str(d)), ranks=range(2)),
            timeout_s=120.0)
    finally:
        mesh.remove_store(store)
    return job, [torch.load(d / f"rank{r}-0.pt", weights_only=False)
                 for r in range(2)], [
        torch.load(d / f"rank{r}-1.pt", weights_only=False)
        for r in range(2)]


def test_gather_roundtrip_and_reduce_scatter(gathered):
    """JAX test_fsdp.py:54-79: the gather of each rank's shards gives the
    leaves back exactly, on both ranks; the gradient of a sharded leaf is
    the rank's shard of the cotangents summed over ranks (rank r weighs
    its loss by 1 + r, so the sum is 3x), and a replicated leaf's is the
    whole sum (reduce_replicated_grads); atol 1e-5 (fp32 sums)."""
    job, ranks, _ = gathered
    specs = ranks[0]["specs"]
    assert specs["['a']['kernel']"] == ("fsdp", None)
    assert specs["['b']['kernel']"] == (None, None, "fsdp", None)
    assert specs["['a']['bias']"] == (None,)          # below the minimum
    assert specs["['c']['odd']"] == (None, None)      # 129 is odd
    for r, res in enumerate(ranks):
        for key, full in job["leaves"].items():
            np.testing.assert_array_equal(res["full"][key], full)
            want = 3.0 * job["weights"][key]
            index = weights.shard_index(full.shape, specs[key],
                                        {"fsdp": (r, 2)})
            want = want[tuple(slice(a, b) for a, b in index)]
            np.testing.assert_allclose(res["grads"][key], want, atol=1e-5,
                                       err_msg=key)


def test_batchnorm_shards_match_the_sliced_dense_twin(gathered):
    """One fp32 step of enhanced_cnn (width 8, 21 BatchNorms, channels-last
    convs gathered from their HWIO shards) at data=1,fsdp=2: each rank's
    logits of its half of the batch and the joined parameter gradients
    equal the dense twin that normalises each half on its own over the
    whole batch's denominator (logits atol 1e-5, gradients atol 2e-4, the
    JAX TP gate), on both ranks; each rank's own differences (the ones
    chip_smoke.py gates) are these."""
    _, _, ranks = gathered
    logits = np.concatenate([r["logits"] for r in ranks])
    np.testing.assert_allclose(logits, ranks[0]["dense_logits"], atol=1e-5)
    assert any("fsdp" in s for s in ranks[0]["specs"].values())
    for key, g in ranks[0]["grads"].items():
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][key],
                                   atol=2e-4, err_msg=key)
        np.testing.assert_array_equal(g, ranks[1]["grads"][key])
    for r, res in enumerate(ranks):
        half = np.array_split(res["dense_logits"], 2)[r]
        assert res["logits_err"] == np.abs(res["logits"] - half).max()
        assert res["grads_err"] == max(
            np.abs(g - res["dense_grads"][k]).max()
            for k, g in res["grads"].items())


def _argv(model="mlp", dataset="mnist", *extra):
    return ["--device", "cpu", "--model", model, "--dataset", dataset,
            "--epochs_global", "2", "--epochs_local", "1", "--batch_size",
            "8", "--limit_train_samples", "128", "--limit_eval_samples",
            "32", "--compute_dtype", "float32", "--no_augment",
            "--aggregation_by", "weights", "--seed", "11",
            # the partition by share, not by the measured probe: the two
            # runs then train on the same shards
            "--proportionality", "uniform", "--probe_batches", "1",
            "--log_level", "WARNING", "--out_dir", PLOTS[0], *extra]


@pytest.mark.parametrize("model,dataset,rtol", [
    ("mlp", "mnist", 2e-4), ("bert_tiny", "synthetic_mlm", 2e-3)],
    ids=["mlp", "bert_tiny"])
def test_driver_fsdp_matches_data_only_run(model, dataset, rtol):
    """JAX test_fsdp.py:82-97: data=2,fsdp=2 against the data=2 run, the
    global train and val losses at JAX's gates (mlp 2e-4, bert_tiny
    2e-3); each rank holds about half of the large leaves' elements."""
    plain = t_main.run(_argv(model, dataset, "--num_workers", "2"))
    fsdp = t_main.run(_argv(model, dataset, "--mesh_shape",
                            "data=2,fsdp=2"))
    for k in ("global_train_losses", "global_val_losses"):
        np.testing.assert_allclose(fsdp[k], plain[k], rtol=rtol)
    assert fsdp["global_train_losses"][-1] < fsdp["global_train_losses"][0]
    whole = sum(t.numel() for t in plain["variables"].values())
    for row in fsdp["grid"]["state_bytes"]:
        assert row["params"] < 0.6 * 4 * whole
        assert row["opt_state"] < 2 * 0.6 * 4 * whole + 8
    assert all(s["gathers"] > 0 and s["reduce_scatters"] > 0
               for s in fsdp["grid"]["fsdp"])


def test_batchnorm_model_runs_with_equal_statistics():
    """JAX test_fsdp.py:99-123: a BatchNorm model (enhanced_cnn, width 8)
    at data=2,fsdp=2 trains to finite losses, each rank normalising its
    slice of the batch, and the running statistics are equal on the two
    fsdp ranks of each worker (averaged after every step)."""
    res = t_main.run(_argv("enhanced_cnn", "cifar10", "--model_width", "8",
                           "--mesh_shape", "data=2,fsdp=2",
                           "--epochs_global", "1"))
    assert np.isfinite(res["global_train_losses"]).all()
    sums = res["grid"]["buffer_checksums"]
    assert len(sums) == 4 and sums[0] is not None
    assert sums[0] == sums[1] and sums[2] == sums[3]


def test_augment_runs_decorrelated():
    """JAX test_fsdp.py:137-149: augmentation under FSDP (each fsdp rank's
    stream decorrelated by its index) trains to finite losses."""
    argv = _argv("lenet5", "mnist", "--mesh_shape", "data=1,fsdp=2",
                 "--epochs_global", "1")
    res = t_main.run([a for a in argv if a != "--no_augment"])
    assert np.isfinite(res["global_train_losses"]).all()


def test_batch_divisibility_error():
    """JAX test_fsdp.py:163-169."""
    with pytest.raises(ValueError, match="divisible"):
        t_config.config_from_args(_argv("mlp", "mnist", "--batch_size",
                                        "7", "--mesh_shape",
                                        "data=2,fsdp=2"))


BOTH = ("bert_tiny", "synthetic_mlm", "--mesh_shape",
        "data=1,fsdp=2,model=2")


@pytest.fixture(scope="module")
def both_run():
    return t_main.run(_argv(*BOTH))


def test_composes_with_tp(both_run):
    """JAX test_fsdp.py:171-190: data=1,fsdp=2,model=2 (ZeRO-3 claims a
    free dimension of the TP-sharded leaves) against data=1, global train
    losses at rtol 2e-3."""
    plain = t_main.run(_argv("bert_tiny", "synthetic_mlm", "--mesh_shape",
                             "data=1"))
    both = both_run
    np.testing.assert_allclose(both["global_train_losses"],
                               plain["global_train_losses"], rtol=2e-3)
    assert both["grid"]["ranks"] == 4
    assert all(s["calls"] > 0 for s in both["grid"]["tp"])
    assert all(s["gathers"] > 0 for s in both["grid"]["fsdp"])


def test_grid_streamed_remat_accum_equal_the_plain_grid_run(both_run):
    """The step bodies the grid shares: the same data=1,fsdp=2,model=2 run
    streamed in windows of 2 steps, every block rematerialised (its
    recompute re-runs the TP all-reduces inside the backward) and each
    rank's slice split into 2 accumulation microbatches gives the same
    losses (rtol 1e-6: fp32 sums in another order)."""
    res = t_main.run(_argv(*BOTH, "--stream_chunk_steps", "2",
                           "--remat_policy", "everything", "--grad_accum",
                           "2"))
    for k in ("global_train_losses", "global_val_losses"):
        np.testing.assert_allclose(res[k], both_run[k], rtol=1e-6)


@pytest.mark.parametrize("model,dataset,axes,how,extra", [
    ("mlp", "mnist", "data=2,fsdp=2", "equal", ()),
    ("bert_tiny", "synthetic_mlm", "data=2,model=2", "weighted", ()),
    ("bert_tiny", "synthetic_mlm", "data=2,expert=2", "equal",
     ("--num_experts", "4"))],
    ids=["fsdp-equal", "tp-weighted", "ep-equal"])
def test_sharded_sync_bitwise_dense_under_inner_axes(model, dataset, axes,
                                                     how, extra):
    """The intent of JAX test_sync.py:457-505 (which fails on jax 0.9 at
    collection): under inner axes the sync runs on each coordinate's
    shards over the data line, and in fp32 the sharded engine's rounds
    are bitwise the dense engine's: every metric and the final
    parameters; under an expert axis each expert coordinate's data line
    syncs its own experts."""
    runs = [t_main.run(_argv(model, dataset, "--mesh_shape", axes,
                             "--aggregation_type", how, "--sync_mode",
                             mode, "--epochs_global", "1", *extra))
            for mode in ("dense", "sharded")]
    dense, sharded = runs
    assert sharded["sync_engine"]["mode"] == "sharded"
    assert dense["sync_engine"]["mode"] == "dense"
    for k in ("global_train_losses", "global_val_losses",
              "all_workers_losses"):
        assert sharded[k] == dense[k], k
    for name, t in dense["variables"].items():
        assert torch.equal(sharded["variables"][name], t), name
