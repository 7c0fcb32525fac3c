"""``--remat_policy``, ``--grad_accum`` and the encoder slice end to end:

- every remat policy is bitwise the ``none`` twin in fp32 on the CPU
  (remat moves residency, never arithmetic: JAX ``config.py:135``), in all
  four transformer families, MoE included;
- the config and driver validate the knobs as the JAX package does;
- ``--grad_accum K`` against the JAX engine's step at the same K (dense
  and MoE, whose capacity is per microbatch), and K > 1 against K = 1;
- ``main.run`` on ``bert_tiny --attention_impl flash`` against the JAX
  driver's metrics for one round from the same initial parameters."""

import logging
import math

import jax
import numpy as np
import pytest
import torch

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    config as t_config,
    driver as t_driver,
    main as t_main,
    train as t_train,
    viz as t_viz,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
POLICIES = ["everything", "dots_saveable", "save_names:attn_out,block_out",
            "save_names:mlp_out", "offload_names:attn_out"]


def _family_inputs(family, rng):
    if family == "vit_tiny":
        return torch.from_numpy(
            rng.normal(size=(2, 32, 32, 3)).astype(np.float32)), 10
    return torch.from_numpy(rng.integers(0, 97, (2, 64))).long(), 97


def _loss_and_grads(model, x, cot):
    logits, aux = model(x, with_aux=True)
    loss = (logits * cot).sum() + (0.0 if aux is None else aux)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["bert_tiny", "gpt_tiny", "llama_tiny",
                                    "vit_tiny", "bert_tiny_moe"])
def test_remat_policy_is_bitwise_none(family, policy):
    experts = 4 if family.endswith("_moe") else 0
    name = family.removesuffix("_moe")
    if experts and policy == "save_names:mlp_out":
        policy = "save_names:moe_dispatch,mlp_out"
    rng = np.random.default_rng(0)
    x, ncls = _family_inputs(name, rng)
    kw = dict(num_classes=ncls, num_experts=experts, attention_impl="flash")
    base = get_model(name, **kw)
    base.init_parameters(torch.Generator().manual_seed(1))
    twin = get_model(name, remat_policy=policy, **kw)
    twin.load_state_dict(base.state_dict())
    out_shape = base(x).shape
    cot = torch.from_numpy(rng.normal(size=out_shape).astype(np.float32))
    loss_want, grads_want = _loss_and_grads(base, x, cot)
    loss, grads = _loss_and_grads(twin, x, cot)
    assert torch.equal(loss, loss_want)
    for (n, _), g, w in zip(base.named_parameters(), grads, grads_want):
        assert torch.equal(g, w), n


def test_offload_names_demotes_on_cpu_with_logged_reason(caplog):
    model = get_model("gpt_tiny", num_classes=97,
                      remat_policy="offload_names:attn_out,mlp_out")
    model.init_parameters(torch.Generator().manual_seed(0))
    with caplog.at_level(logging.INFO):
        model(torch.zeros(1, 8, dtype=torch.long)).sum().backward()
    assert ("offload_names:attn_out,mlp_out demoted to "
            "save_names:attn_out,mlp_out" in caplog.text)


def test_remat_recomputes_the_forward_once_per_block():
    """Under ``everything`` the backward runs each block's forward again:
    the attention of every block is called twice per train step."""
    model = get_model("bert_tiny", num_classes=97, remat_policy="everything")
    model.init_parameters(torch.Generator().manual_seed(0))
    calls = []
    for block in model.blocks:
        block.attn.register_forward_hook(lambda *a: calls.append(1))
    model(torch.zeros(2, 16, dtype=torch.long)).float().sum().backward()
    assert len(calls) == 2 * len(model.blocks)
    calls.clear()
    with torch.no_grad():
        model(torch.zeros(2, 16, dtype=torch.long))
    assert len(calls) == len(model.blocks)


@pytest.mark.parametrize("flags,match", [
    (["--remat_policy", "save_names:atn_out"], "unknown activation name"),
    (["--remat_policy", "save_names:moe_dispatch"], "unknown activation"),
    (["--remat_policy", "keep_names:attn_out"], "must start with one of"),
    (["--remat_policy", "save_names:"], "names no activation"),
    (["--remat_policy", "sometimes"], "remat policy must be one of"),
    (["--model", "enhanced_cnn", "--remat_policy", "save_names:attn_out"],
     "has none"),
    (["--grad_accum", "0"], "grad_accum must be >= 1"),
    (["--grad_accum", "3"], "must be divisible by --grad_accum 3"),
], ids=["typo", "moe_name_without_experts", "kind", "empty", "spelling",
        "cnn_names", "accum_zero", "accum_divides"])
def test_config_validates_transformer_knobs_as_jax(flags, match):
    argv = ["--device", "cpu", "--model", "bert_tiny", *flags]
    with pytest.raises(ValueError, match=match):
        t_config.config_from_args(argv)
    # the JAX config refuses the same
    from learning_deep_neural_network_in_distributed_computing_environment_tpu.config import (
        config_from_args as j_config_from_args,
    )
    with pytest.raises((ValueError, SystemExit)):
        j_config_from_args(["--device", "cpu", "--model", "bert_tiny",
                            *flags])


def test_config_accepts_the_transformer_knobs():
    cfg = t_config.config_from_args([
        "--model", "bert_base", "--num_experts", "8", "--grad_accum", "4",
        "--remat_policy", "offload_names:moe_dispatch,attn_out",
        "--expert_capacity_factor", "2.0", "--moe_aux_weight", "0.02"])
    assert (cfg.num_experts, cfg.grad_accum, cfg.expert_capacity_factor,
            cfg.moe_aux_weight) == (8, 4, 2.0, 0.02)
    assert cfg.parse_remat_policy() == ("offload_names",
                                        ("moe_dispatch", "attn_out"))
    d = t_config.Config()
    assert (d.expert_capacity_factor, d.moe_aux_weight, d.layer_scan) == (
        1.25, 0.01, "auto")


@pytest.mark.parametrize("over,match", [
    (dict(model="enhanced_cnn", num_experts=2), "applies to attention"),
    (dict(model="enhanced_cnn", grad_accum=2), "applies to attention"),
    (dict(model="enhanced_cnn", remat_policy="everything"), "unrolled"),
    # the port keeps one module per block (what auto gives): --layer_scan
    # stays at its default
    (dict(model="bert_tiny", remat_policy="everything", layer_scan="off"),
     "A.11"),
    (dict(model="mlp", layer_scan="on"), "A.11"),
], ids=["experts_cnn", "accum_cnn", "remat_cnn", "remat_unrolled",
        "scan_mlp"])
def test_driver_refuses_where_the_jax_driver_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        cfg = t_config.Config(device="cpu", **over)
        t_driver.build_model_for(cfg, 10, CPU, (28, 28, 1))


def test_build_model_for_passes_experts_capacity_and_remat():
    cfg = t_config.Config(device="cpu", model="vit_tiny", num_experts=2,
                          expert_capacity_factor=0.75,
                          remat_policy="dots_saveable")
    model = t_driver.build_model_for(cfg, 10, CPU, (32, 32, 3))
    moe = model.blocks[0].moe
    assert (moe.num_experts, moe.capacity_factor) == (2, 0.75)
    assert model.remat.kind == "dots_saveable"


def _mlm_packs(steps=3, batch=8):
    """Train/val packs [1, S, B, 32] of synthetic_mlm data; the last train
    step is half padding."""
    train, _ = load_dataset("synthetic_mlm", seed=0,
                            limit_train=2 * steps * batch, limit_test=1)
    x = train.images[:, :32].reshape(2, steps, batch, 32)
    y = train.labels[:, :32].reshape(2, steps, batch, 32)
    m = np.ones((steps, batch), np.float32)
    m[-1, batch // 2:] = 0.0
    return (x[:1], y[:1], m[None]), (x[1:], y[1:], np.ones_like(m)[None])


def _kw(**over):
    return {**dict(model="bert_tiny", dataset="synthetic_mlm",
                   epochs_local=1, batch_size=8, compute_dtype="float32",
                   augment=False, attention_impl="dense",
                   aggregation_by="weights", lr=3e-3), **over}


def _port_engine(params, **over):
    kw = _kw(**over)
    model = get_model(kw["model"], num_classes=1000,
                      num_experts=kw.get("num_experts", 0))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.flax_to_torch(params).items()})
    return t_train.LocalSGDEngine(model, t_config.Config(device="cpu", **kw),
                                  CPU)


@pytest.mark.parametrize("k,experts", [(2, 0), (4, 0), (4, 4)],
                         ids=["k2", "k4", "k4_moe"])
def test_grad_accum_round_matches_jax_engine_at_same_k(devices, k, experts):
    """One round of 3 steps (the last half padding) at the same K on both
    sides: batch losses at rtol 1e-4 and parameters at atol 1e-4 (fp32,
    sums in another order).  With experts the capacity is per
    microbatch on both sides."""
    train_pack, val_pack = _mlm_packs()
    kw = _kw(grad_accum=k, num_experts=experts)
    j_model = j_get_model("bert_tiny", num_classes=1000, scan_layers=True,
                          num_experts=experts)
    j_engine = j_train.LocalSGDEngine(
        j_model, build_mesh({"data": 1}, devices[:1]), JConfig(**kw))
    j_state = j_engine.init_state(jax.random.key(0), train_pack[0][0, 0])
    params0 = jax.device_get(j_engine.rank0_variables(j_state)["params"])
    engine = _port_engine(params0, grad_accum=k, num_experts=experts)
    state = engine.init_state()
    j_state, j_mx = j_engine.round(j_state, train_pack, val_pack)
    state, mx = engine.round(state, train_pack, val_pack)
    for key in ("train_loss", "train_acc", "val_loss", "val_acc",
                "batch_losses"):
        np.testing.assert_allclose(mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(mx["agg_grad_norm"],
                               np.asarray(j_mx["agg_grad_norm"]), rtol=1e-4)
    assert state.opt.count == 3
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(
        j_engine.rank0_variables(j_state)["params"]))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(weights.torch_to_flax(
        engine.model.state_dict(), num_heads=4))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], leaf, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_step_matches_the_full_batch_step(k):
    """On a dense model K slices over the full step's denominator sum to
    the K=1 step: loss and gradients within fp32 summation order (atol
    1e-6 on O(1e-2) gradients), one Adam step each."""
    (x, y, m), _ = _mlm_packs()
    model = get_model("bert_tiny", num_classes=1000)
    model.init_parameters(torch.Generator().manual_seed(0))
    steps = {}
    for kk in (1, k):
        twin = get_model("bert_tiny", num_classes=1000)
        twin.load_state_dict(model.state_dict())
        engine = t_train.LocalSGDEngine(
            twin, t_config.Config(device="cpu", **_kw(grad_accum=kk)), CPU)
        state = engine.init_state()
        xs, ys, ms = (torch.from_numpy(np.asarray(a)[0, -1])
                      for a in (x, y, m))
        loss, correct, grads = engine._train_step(
            state, xs.long(), ys.long(), ms, 1e-3, False)
        steps[kk] = (loss, correct, grads, state.opt.count)
    loss1, correct1, grads1, count1 = steps[1]
    loss_k, correct_k, grads_k, count_k = steps[k]
    assert count1 == count_k == 1 and correct1 == correct_k
    assert loss_k.item() == pytest.approx(loss1.item(), rel=1e-6)
    for g, w in zip(grads_k, grads1):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_main_bert_tiny_flash_round_matches_jax_driver(devices, tmp_path,
                                                       monkeypatch):
    """The whole slice: ``main.run`` on bert_tiny with flash attention
    (the plain kernel versions on the CPU) against the JAX driver from the
    same initial parameters, one round of 2 local epochs: the reference
    metrics at rtol 1e-4 (fp32 on both sides)."""
    monkeypatch.setattr(t_viz, "_plt", lambda: None)
    kw = dict(model="bert_tiny", dataset="synthetic_mlm", epochs_global=1,
              epochs_local=2, batch_size=8, limit_train_samples=40,
              limit_eval_samples=8, probe_batches=1, compute_dtype="float32",
              attention_impl="flash", lr=3e-3)
    init = {}
    j_init_state = j_train.LocalSGDEngine.init_state

    def capture(self, key, sample):
        state = j_init_state(self, key, sample)
        init["params"] = jax.device_get(self.rank0_variables(state)["params"])
        return state

    monkeypatch.setattr(j_train.LocalSGDEngine, "init_state", capture)
    j_res = j_train_global(JConfig(**kw),
                           mesh=build_mesh({"data": 1}, devices[:1]),
                           progress=False)
    t_build = t_driver.build_model_for

    def transplanted(cfg, num_classes, device, input_shape=None):
        model = t_build(cfg, num_classes, device, input_shape)
        model.load_state_dict({
            k: torch.from_numpy(np.array(v))
            for k, v in weights.flax_to_torch(init["params"]).items()})
        return model

    monkeypatch.setattr(t_driver, "build_model_for", transplanted)
    argv = ["--device", "cpu", "--out_dir", str(tmp_path)]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    results = t_main.run(argv)
    assert type(results["model"]).__name__ == "BertForMLM"
    assert results["shard_sizes"] == j_res["shard_sizes"]
    for key in ("global_train_losses", "global_val_losses",
                "global_train_accuracies", "global_val_accuracies",
                "worker_specific_train_losses", "all_epochs_losses"):
        got = np.asarray(results[key], np.float64)
        want = np.asarray(j_res[key], np.float64)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert all(math.isfinite(x) for x in results["all_workers_losses"][0])
    assert math.isfinite(results["test_eval"]["loss"])
