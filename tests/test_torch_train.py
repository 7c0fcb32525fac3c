"""The PyTorch port's local training phase against the JAX package's
``train.py``: StepLR, the clamped cross-entropy, masking, Adam, and one
single-worker local-SGD round from the same transplanted state on the same
numpy packs.  The JAX engine runs attention inside shard_map, where the
Pallas interpreter falls back to dense on the CPU, so a flash case here
holds the port's plain flash path against dense; kernel-level flash
parity is carried by tests/test_torch_flash.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu import (
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
    train as t_train,
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    Config as TConfig,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    load_dataset,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model as t_get_model,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def test_steplr_matches_jax():
    for epoch in (0, 1, 24, 25, 26, 49, 50, 77):
        want = float(j_train.steplr(1e-3, 0.1, 25, jnp.asarray(epoch)))
        assert t_train.steplr(1e-3, 0.1, 25, epoch) == pytest.approx(
            want, rel=1e-6)


def test_cross_entropy_clamp_semantics_match_jax():
    """Out-of-range labels clamp once, so the forward's gather and the
    backward's one-hot agree; values and grads match JAX's custom VJP
    (fp32 rounding: atol 1e-6)."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(-2, 15, (3, 5)).astype(np.int32)
    cot = rng.normal(size=(3, 5)).astype(np.float32)
    ce_want, vjp = jax.vjp(
        lambda lg: j_train.softmax_cross_entropy(lg, jnp.asarray(labels)),
        jnp.asarray(logits))
    (g_want,) = vjp(jnp.asarray(cot))
    lt = torch.from_numpy(logits).requires_grad_()
    ce = t_train.softmax_cross_entropy(lt, torch.from_numpy(labels).long())
    (g,) = torch.autograd.grad(ce, lt, torch.from_numpy(cot))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(ce_want),
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), atol=1e-6)


def test_masked_token_stats_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 6, 9)).astype(np.float32)
    labels = rng.integers(-1, 9, (4, 6)).astype(np.int32)
    mask = np.array([1, 0, 1, 1], np.float32)
    want = j_train.masked_token_stats(jnp.asarray(logits),
                                      jnp.asarray(labels), jnp.asarray(mask))
    got = t_train.masked_token_stats(torch.from_numpy(logits),
                                     torch.from_numpy(labels).long(),
                                     torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    j_params = [jnp.asarray(p) for p in params]
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    opt = t_train.Adam(t_params)
    for step in range(4):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        lr = 1e-2 / (step + 1)
        u, j_state = tx.update([jnp.asarray(g) for g in grads], j_state,
                               j_params)
        j_params = optax.apply_updates(j_params, [-lr * x for x in u])
        opt.step(t_params, [torch.from_numpy(g) for g in grads], lr)
    assert opt.count == 4
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def _packs(vocab_seed=0, steps=4, batch=4):
    """Train/val packs [1, S, B, L] of synthetic_lm data; train step 2 is
    all padding and step 3 half padding."""
    train, _ = load_dataset("synthetic_lm", seed=vocab_seed,
                            limit_train=2 * steps * batch, limit_test=1)
    x = train.images.reshape(2, steps, batch, -1)
    y = train.labels.reshape(2, steps, batch, -1)
    m = np.ones((steps, batch), np.float32)
    m[2] = 0.0
    m[3, batch // 2:] = 0.0
    return (x[:1], y[:1], m[None]), (x[1:], y[1:], np.ones_like(m)[None])


def _kw(**over):
    return {**dict(model="gpt_tiny", dataset="synthetic_lm", epochs_local=2,
                   batch_size=4, compute_dtype="float32", augment=False,
                   attention_impl="dense", aggregation_by="weights",
                   lr=3e-3), **over}


def _port_engine(params, **over):
    kw = _kw(**over)
    model_kw = ({"num_kv_heads": kw["num_kv_heads"]}
                if kw.get("num_kv_heads") else {})
    model = t_get_model(kw["model"], num_classes=1000,
                        attention_impl=kw["attention_impl"], **model_kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.flax_to_torch(params).items()})
    return t_train.LocalSGDEngine(model, TConfig(device="cpu", **kw), CPU)


def test_one_worker_round_matches_jax_engine(devices):
    """Per-epoch losses/accuracies at rtol 1e-4 and final params at atol
    1e-4: fp32 on both sides, differing in summation order only."""
    _round_matches_jax_engine(devices)


def test_one_worker_llama_round_matches_jax_engine(devices):
    """The same on llama_tiny with 2 KV heads and the port's flash path."""
    _round_matches_jax_engine(devices, model="llama_tiny", num_kv_heads=2,
                              attention_impl="flash")


def _round_matches_jax_engine(devices, **over):
    train_pack, val_pack = _packs()
    kw = _kw(**over)
    j_model_kw = ({"num_kv_heads": kw["num_kv_heads"]}
                  if kw.get("num_kv_heads") else {})
    j_model = j_get_model(kw["model"], num_classes=1000, scan_layers=True,
                          attention_impl=kw["attention_impl"], **j_model_kw)
    j_engine = j_train.LocalSGDEngine(
        j_model, build_mesh({"data": 1}, devices[:1]), JConfig(**kw))
    j_state = j_engine.init_state(jax.random.key(0), train_pack[0][0, 0])
    params0 = jax.device_get(j_engine.rank0_variables(j_state)["params"])
    engine = _port_engine(params0, **over)
    state = engine.init_state()

    j_state, j_mx = j_engine.round(j_state, train_pack, val_pack)
    state, mx = engine.round(state, train_pack, val_pack)
    for key in ("train_loss", "train_acc", "val_loss", "val_acc",
                "batch_losses", "batch_mask", "global_train_loss"):
        np.testing.assert_allclose(mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert state.lr_epoch == 2 and state.opt.count == 2 * 3
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(
        j_engine.rank0_variables(j_state)["params"]))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(weights.torch_to_flax(
        engine.model.state_dict(), num_heads=4,
        num_kv_heads=kw.get("num_kv_heads", 0)))[0])
    for path, leaf in want:
        np.testing.assert_allclose(got[path], leaf, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_all_padding_round_leaves_state_bit_identical():
    """Fully masked steps are no-ops: params, Adam moments and the step
    count stay bit-identical; only the StepLR clock advances."""
    model = t_get_model("gpt_tiny", num_classes=1000)
    model.init_parameters(torch.Generator().manual_seed(0))
    engine = t_train.LocalSGDEngine(model, TConfig(device="cpu", **_kw()),
                                    CPU)
    state = engine.init_state()
    (x, y, m), val_pack = _packs()
    before = [t.clone() for t in engine.params + state.opt.state_tensors()]
    state, mx = engine.round(state, (x, y, np.zeros_like(m)), val_pack)
    after = engine.params + state.opt.state_tensors()
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert state.opt.count == 0 and state.lr_epoch == 2
    assert mx["train_steps"] == 0 and not mx["batch_mask"].any()


def _image_packs(steps=4, batch=4):
    """Train/val packs [1, S, B, 32, 32, 3] of synthetic cifar10; train
    step 2 is half padding and the last step all padding."""
    train, _ = load_dataset("cifar10", seed=0, limit_train=2 * steps * batch,
                            limit_test=1)
    x = train.images.reshape(2, steps, batch, 32, 32, 3)
    y = train.labels.reshape(2, steps, batch)
    m = np.ones((steps, batch), np.float32)
    m[2, batch // 2:] = 0.0
    m[-1] = 0.0
    return (x[:1], y[:1], m[None]), (x[1:], y[1:], np.ones_like(m)[None])


def _cnn_port_engine(variables, **over):
    model = t_get_model("enhanced_cnn", num_classes=10, width=8)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.cnn_flax_to_torch(variables).items()})
    model = model.to(memory_format=torch.channels_last)
    kw = _kw(model="enhanced_cnn", dataset="cifar10", lr=1e-3, **over)
    return t_train.LocalSGDEngine(model, TConfig(device="cpu", **kw), CPU)


def test_one_worker_cnn_round_matches_jax_engine(devices):
    """enhanced_cnn at width 8, fp32, no augmentation, 2 local epochs, a
    shard whose last step is all padding, against the JAX engine from the
    same transplanted state: per-epoch metrics at rtol 1e-4, BatchNorm
    statistics at atol 1e-4, and params at atol 1e-4 but for at most one
    element in 1e4.  Adam's step is m / sqrt(v): where an element's
    gradient is near zero the two frameworks' fp32 difference can flip its
    sign, moving it by up to 2 lr per step, so those are held to that
    bound.  The padding step leaves everything bit-identical (the same
    round without it)."""
    train_pack, val_pack = _image_packs()
    kw = _kw(model="enhanced_cnn", dataset="cifar10", lr=1e-3)
    j_engine = j_train.LocalSGDEngine(
        j_get_model("enhanced_cnn", num_classes=10, width=8),
        build_mesh({"data": 1}, devices[:1]), JConfig(**kw))
    j_state = j_engine.init_state(jax.random.key(0), train_pack[0][0, 0])
    variables0 = jax.device_get(j_engine.rank0_variables(j_state))
    assert "batch_stats" in variables0
    engine = _cnn_port_engine(variables0)
    state = engine.init_state()

    j_state, j_mx = j_engine.round(j_state, train_pack, val_pack)
    state, mx = engine.round(state, train_pack, val_pack)
    for key in ("train_loss", "train_acc", "val_loss", "val_acc",
                "batch_losses", "batch_mask", "global_train_loss",
                "global_val_loss"):
        np.testing.assert_allclose(mx[key], np.asarray(j_mx[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert state.lr_epoch == 2 and state.opt.count == 2 * 3
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(
        j_engine.rank0_variables(j_state)))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        weights.cnn_torch_to_flax(engine.model.state_dict()))[0])
    assert len(got) == len(want)
    lr, flipped, total = 1e-3, 0, 0
    for path, leaf in want:
        where = jax.tree_util.keystr(path)
        err = np.abs(got[path] - leaf)
        if "batch_stats" in where:
            assert err.max() <= 1e-4, where
        else:
            assert err.max() <= 2 * lr * state.opt.count, where
            flipped += int((err > 1e-4).sum())
            total += err.size
    assert flipped <= total * 1e-4, (flipped, total)

    # the all-padding last step is a no-op: the round without it ends in
    # the same bits, BatchNorm statistics included
    twin = _cnn_port_engine(variables0)
    twin_state = twin.init_state()
    twin.round(twin_state, tuple(a[:, :-1] for a in train_pack), val_pack)
    assert twin_state.opt.count == state.opt.count
    for (k, a), b in zip(engine.model.state_dict().items(),
                         twin.model.state_dict().values()):
        assert torch.equal(a, b), k
