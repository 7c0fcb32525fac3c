"""The PyTorch port's image models against the JAX package's on the CPU:
``enhanced_cnn`` (the reference's model), ``mlp``, ``lenet5``,
``resnet18`` and ``resnet50`` at small widths, with flax variables
transplanted through ``weights.py``; the flax-semantics BatchNorm (biased
running variance, momentum 0.9); the full-width parameter counts; init
statistics; and the on-device augmentation against ``augment_batch``.

Tolerances: fp32 logits within 1e-4 of max |logit| and parameter gradients
within 1e-4 of each tensor's max |grad| (both frameworks in fp32, summing
in different orders); bf16 logits within 2e-2 of max |logit| (bf16
spacing is 2^-8 relative, rounded after every layer); BatchNorm statistics
within 1e-5; augmentation within 1e-6.  resnet50's train mode is the
exception, for the reason given at ``TRAIN_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.data import (
    augment as j_augment,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    augment as t_augment,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    MODEL_INPUT_SPECS,
    get_model as t_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.norm import (
    BatchNorm,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# case -> (small-size kwargs, input shape [B, H, W, C], data seed).  The
# cases' resnet50 takes the cifar stem: with the imagenet stem a 32x32
# input reaches its last stage at 1x1, where train-mode BatchNorm
# normalises over 4 values per channel and amplifies rounding about a
# thousandfold (on the CPU the JAX model alone moves its logits by 1e-4 of
# their max under 1e-7 relative input noise).  The imagenet stem is held
# on resnet18 at 64x64.
SMALL = {
    "enhanced_cnn": (dict(width=8), (4, 32, 32, 3), 0),
    "mlp": (dict(hidden=32), (4, 28, 28, 1), 1),
    "lenet5": ({}, (4, 28, 28, 1), 2),
    "resnet18": (dict(width=4), (4, 32, 32, 3), 1),
    "resnet50": (dict(width=4, stem="cifar"), (4, 32, 32, 3), 1),
    "resnet18_imagenet_stem": (dict(width=4, stem="imagenet"),
                               (4, 64, 64, 3), 5),
}
MODELS = list(SMALL)
BN_MODELS = ["enhanced_cnn", "resnet18", "resnet50",
             "resnet18_imagenet_stem"]
LADDER = ("enhanced_cnn", "mlp", "lenet5", "resnet18", "resnet50")
FULL_PARAMS = {"enhanced_cnn": 44_595_786}
# resnet50 in train mode: on the CPU, XLA's fp32 result itself drifts from
# a float64 run of the same network by about 1e-4 of the largest
# activation at the last stage (several times the port's drift), so
# train-mode logits are held at 1e-3 and statistics at 1e-4, and the
# gradients in eval mode, where the two agree to 1e-5: in train mode a
# ReLU input within that drift of zero flips the gradient of a whole
# BatchNorm channel.  The other cases'
# seeds are ones whose ReLU inputs lie clear of zero by more than the
# frameworks' fp32 difference.
TRAIN_TOL = {"resnet50": 1e-3}
STATS_TOL = {"resnet50": 1e-4}
EVAL_GRADS = ("resnet50",)


def _registry_name(case):
    return case.split("_imagenet")[0]


def _jax_model(case, dtype=jnp.float32):
    return j_get_model(_registry_name(case), num_classes=10, dtype=dtype,
                       **SMALL[case][0])


def _port_model(case, dtype=torch.float32):
    kw, shape, _ = SMALL[case]
    if case in ("mlp", "lenet5"):
        kw = {**kw, "input_shape": shape[1:]}
    return t_get_model(_registry_name(case), num_classes=10, dtype=dtype,
                       **kw)


@pytest.fixture(scope="module")
def flax_cases():
    """case -> dict of numpy inputs and flax results.  The variables are
    the port's init taken to flax by ``weights.py``, with the BatchNorm
    scale/bias and statistics moved off their init values so eval mode
    reads real statistics.  One jitted flax program per case computes
    the train-mode logits and mutated ``batch_stats``, the parameter
    gradients of <logits, cot> (in eval mode for ``EVAL_GRADS``), and the
    eval-mode logits in fp32 and bf16."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        _, shape, seed = SMALL[case]
        rng = np.random.default_rng(seed)
        x = rng.normal(size=shape).astype(np.float32)
        cot = rng.normal(size=(shape[0], 10)).astype(np.float32)
        model = _port_model(case)
        model.init_parameters(torch.Generator().manual_seed(1))
        variables = weights.cnn_torch_to_flax(model.state_dict())

        def perturb(path, leaf):
            last = jax.tree_util.keystr(path[-1:])
            if "scale" in last or "var" in last:
                return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
            if "mean" in last or ("bias" in last and leaf.ndim == 1):
                return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
            return leaf
        variables = jax.tree_util.tree_map_with_path(perturb, variables)
        f32, b16 = _jax_model(case), _jax_model(case, jnp.bfloat16)
        rest = {k: v for k, v in variables.items() if k != "params"}

        train_grads = case not in EVAL_GRADS

        def run(variables, x, cot):
            def loss(params):
                out, mut = f32.apply({"params": params, **rest}, x,
                                     train=train_grads,
                                     mutable=["batch_stats"])
                return (out * cot).sum(), (out, mut)
            (_, (_, mut)), grads = jax.value_and_grad(
                loss, has_aux=True)(variables["params"])
            train, mut = f32.apply(variables, x, train=True,
                                   mutable=["batch_stats"])
            return dict(train=train, batch_stats=mut.get("batch_stats"),
                        grads=grads,
                        eval=f32.apply(variables, x, train=False),
                        eval_bf16=b16.apply(variables, x, train=False))
        out = jax.device_get(jax.jit(run)(variables, x, cot))
        cache[case] = dict(variables=variables, x=x, cot=cot, **out)
        return cache[case]
    return get


def _load(case, variables, dtype=torch.float32):
    model = _port_model(case, dtype)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.cnn_flax_to_torch(variables).items()})
    return model.to(memory_format=torch.channels_last)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", MODELS)
def test_forward_matches_flax(flax_cases, case, train):
    c = flax_cases(case)
    model = _load(case, c["variables"])
    model.train(train)
    got = model(torch.from_numpy(c["x"]))
    assert got.dtype == torch.float32 and got.shape == (len(c["x"]), 10)
    _close(got.detach(), c["train" if train else "eval"],
           TRAIN_TOL.get(case, 1e-4) if train else 1e-4)


@pytest.mark.parametrize("case", MODELS)
def test_param_grads_match_flax(flax_cases, case):
    """Gradients of <logits, cot> for every parameter, in train mode
    (eval mode for ``EVAL_GRADS``)."""
    c = flax_cases(case)
    want = weights.cnn_flax_to_torch({"params": c["grads"]})
    model = _load(case, c["variables"])
    model.train(case not in EVAL_GRADS)
    (model(torch.from_numpy(c["x"])) * torch.from_numpy(c["cot"])).sum(
        ).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for key, g in want.items():
        _close(got[key].grad, g, 1e-4, key)


@pytest.mark.parametrize("case", MODELS)
def test_bf16_logits_match_flax(flax_cases, case):
    """Eval mode: in train mode the few values per channel of the small
    batch amplify the convs' one-ulp bf16 rounding differences (a
    different accumulation order) beyond 2e-2 of max |logit|, in JAX
    alone too (its own bf16 and fp32 logits of enhanced_cnn differ by
    2.4e-2 there)."""
    c = flax_cases(case)
    model = _load(case, c["variables"], torch.bfloat16)
    model.eval()
    got = model(torch.from_numpy(c["x"]))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _close(got.detach(), c["eval_bf16"], 2e-2)


@pytest.mark.parametrize("case", BN_MODELS)
def test_batch_stats_after_one_train_forward_match_flax(flax_cases, case):
    """flax stores the biased batch variance with momentum 0.9; torch's own
    running-stat update would store the unbiased one."""
    c = flax_cases(case)
    model = _load(case, c["variables"])
    model.train()
    model(torch.from_numpy(c["x"]))
    got = weights.cnn_torch_to_flax(model.state_dict())["batch_stats"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(c["batch_stats"])[0]
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], leaf,
                                   atol=STATS_TOL.get(case, 1e-5),
                                   err_msg=jax.tree_util.keystr(path))


def test_batchnorm_module_semantics():
    """Biased variance, ra <- 0.9 ra + 0.1 batch, eval mode on the running
    statistics, bf16 output with fp32 statistics."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(5, 3, 4, 4)) * 2 + 1).astype(
        np.float32))
    bn = BatchNorm(3)
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(
        y, (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5))
    bn.eval()
    before = bn.running_mean.clone()
    y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16 and torch.equal(before,
                                                      bn.running_mean)
    want = ((x - bn.running_mean[:, None, None])
            / torch.sqrt(bn.running_var[:, None, None] + 1e-5))
    torch.testing.assert_close(y.float(), want, atol=3e-2, rtol=1e-2)
    assert bn.running_var.dtype == torch.float32


@pytest.mark.parametrize("case", MODELS)
def test_weights_round_trip_exactly(flax_cases, case):
    variables = flax_cases(case)["variables"]
    sd = weights.cnn_flax_to_torch(variables)
    model = _port_model(case)
    assert set(sd) == set(model.state_dict())
    for key, arr in sd.items():
        assert arr.shape == model.state_dict()[key].shape, key
    back = weights.cnn_torch_to_flax(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(got[path], leaf), jax.tree_util.keystr(path)
    again = weights.cnn_flax_to_torch(back)
    assert all(np.array_equal(again[k], v) for k, v in sd.items())


@pytest.mark.parametrize("name", LADDER)
def test_full_width_param_count_matches_flax(name):
    """Without a compile: ``jax.eval_shape`` of the flax init against the
    port's module on the ``meta`` device."""
    example, classes = MODEL_INPUT_SPECS[name]
    shape = (1, *example)
    j_model = j_get_model(name, num_classes=classes)
    abstract = jax.eval_shape(j_model.init, jax.random.key(0),
                              jnp.zeros(shape, jnp.float32))
    want = sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(abstract["params"]))
    model = t_get_model(name, num_classes=classes, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert want == FULL_PARAMS.get(name, want)


@pytest.mark.parametrize("name", LADDER)
def test_init_statistics_match_flax_initializers(name):
    """Spread, not values (the frameworks draw different numbers):
    Xavier-uniform kernels inside +-sqrt(6 / (fan_in + fan_out)) with that
    range's std; He truncated-normal kernels inside 2 std of the
    truncated-normal scale with std sqrt(2 / fan_in); zero biases, unit
    BatchNorm scale and statistics mean 0 / var 1."""
    model = _port_model(name)
    model.init_parameters(torch.Generator().manual_seed(0))
    he = name.startswith("resnet")
    for key, p in model.named_parameters():
        p = p.detach()
        if key.endswith(".bias"):
            assert p.eq(0).all(), key
        elif p.ndim == 1:
            assert p.eq(1).all(), key
        else:
            fan_in = p[0].numel()
            if he:
                std = np.sqrt(2.0 / fan_in)
                limit = 2 * std / .87962566103423978
            else:
                limit = np.sqrt(6.0 / (fan_in + p.shape[0] * p[0, 0].numel()))
                std = limit / np.sqrt(3.0)
            assert p.abs().max() <= limit * (1 + 1e-6), key
            if p.numel() >= 500:
                assert abs(p.std().item() / std - 1) < 0.15, key
    for key, b in model.named_buffers():
        assert b.eq(1.0 if key.endswith("running_var") else 0.0).all(), key


def _jax_draws(key, b, h, w):
    """The draws of the JAX ``augment_batch`` (augment.py:30-52), from the
    same key with the same calls."""
    (k_flip, k_crop_y, k_crop_x, k_bright, k_contrast, k_cut_y,
     k_cut_x) = jax.random.split(key, 7)
    as_t = lambda a: torch.from_numpy(np.asarray(a).reshape(b).copy())
    return dict(
        flip=as_t(jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))),
        oy=as_t(jax.random.randint(k_crop_y, (b,), 0, 9)),
        ox=as_t(jax.random.randint(k_crop_x, (b,), 0, 9)),
        gain=as_t(jax.random.uniform(k_contrast, (b, 1, 1, 1), minval=0.8,
                                     maxval=1.2)),
        bias=as_t(jax.random.uniform(k_bright, (b, 1, 1, 1), minval=-0.2,
                                     maxval=0.2)),
        cy=as_t(jax.random.randint(k_cut_y, (b, 1, 1), 0, h)),
        cx=as_t(jax.random.randint(k_cut_x, (b, 1, 1), 0, w)))


@pytest.mark.parametrize("shape", [(16, 32, 32, 3), (8, 28, 28, 1)],
                         ids=["cifar", "mnist"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_augment_matches_jax(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(j_augment.augment_batch(key, jnp.asarray(x)))
    got = t_augment.apply_augment(torch.from_numpy(x),
                                  _jax_draws(key, *shape[:3]))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_augment_batch_invariants():
    """Shape and dtype kept; a generator seed repeats; every image has a
    zero cutout square; flips, crops and jitter all happen."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 32, 32, 3)).astype(np.float32))
    out = [t_augment.augment_batch(x, torch.Generator().manual_seed(7))
           for _ in range(2)]
    assert out[0].shape == x.shape and out[0].dtype == x.dtype
    assert torch.equal(out[0], out[1])
    other = t_augment.augment_batch(x, torch.Generator().manual_seed(8))
    assert not torch.equal(out[0], other)
    draws = t_augment.draw(64, 32, 32, torch.Generator().manual_seed(7),
                           torch.device("cpu"))
    for i in range(64):
        cy, cx = int(draws["cy"][i]), int(draws["cx"][i])
        region = out[0][i, max(cy - 4, 0):cy + 5, max(cx - 4, 0):cx + 5]
        assert region.eq(0).all()
    assert 0 < int(draws["flip"].sum()) < 64
    assert draws["oy"].min() >= 0 and draws["oy"].max() <= 8
    assert ((draws["gain"] >= 0.8) & (draws["gain"] < 1.2)).all()
    assert ((draws["bias"] >= -0.2) & (draws["bias"] < 0.2)).all()
