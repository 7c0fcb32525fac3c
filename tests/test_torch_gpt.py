"""The PyTorch port's GPT family against the JAX package's flax model on
transplanted parameters, plus the weight converter and the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as jax_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)

VOCAB, SEQ = 97, 128
# fp32 on both sides; logits and grads differ by summation order only
ATOL = 1e-4


def _flax_gpt_tiny(attention_impl="dense", scan_layers=True, seed=0):
    model = jax_get_model("gpt_tiny", num_classes=VOCAB, scan_layers=scan_layers,
                          attention_impl=attention_impl)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = model.init(jax.random.key(seed), ids)["params"]
    return model, params


def _torch_from_flax(params, attention_impl="dense"):
    model = get_model("gpt_tiny", num_classes=VOCAB,
                      attention_impl=attention_impl)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in weights.flax_to_torch(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
def test_gpt_tiny_logits_and_grads_match_flax(attention_impl):
    fmodel, params = _flax_gpt_tiny(attention_impl)
    tmodel = _torch_from_flax(params, attention_impl)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    # a per-token-mean cotangent keeps the grads O(1), so ATOL is relative
    cot = (rng.normal(size=(2, SEQ, VOCAB)) / (2 * SEQ)).astype(np.float32)

    def loss(p):
        logits = fmodel.apply({"params": p}, jnp.asarray(ids))
        return (logits * cot).sum(), logits

    (_, logits_want), grads_want = jax.value_and_grad(loss, has_aux=True)(
        params)
    logits = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_want), atol=ATOL)
    (logits * torch.from_numpy(cot)).sum().backward()
    grads = weights.torch_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}, num_heads=4)
    want = jax.tree_util.tree_flatten_with_path(grads_want)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_gpt2_small_param_count_on_meta():
    model = get_model("gpt2_small", device="meta")
    assert sum(p.numel() for p in model.parameters()) == 124_439_808


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_weights_round_trip_is_exact(scan_layers):
    _, params = _flax_gpt_tiny(scan_layers=scan_layers, seed=3)
    sd = weights.flax_to_torch(params)
    back = weights.torch_to_flax(sd, num_heads=4, stacked=scan_layers)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        assert np.array_equal(got[path], np.asarray(leaf)), path
    # and the other way: torch state_dict -> flax -> torch
    model = _torch_from_flax(params)
    sd2 = weights.flax_to_torch(weights.torch_to_flax(
        model.state_dict(), num_heads=4, stacked=scan_layers))
    for k, v in model.state_dict().items():
        assert np.array_equal(sd2[k], v.numpy()), k


def test_bf16_compute_keeps_fp32_params_and_bf16_logits():
    model = get_model("gpt_tiny", num_classes=VOCAB, dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(0))
    logits = model(torch.zeros(2, 16, dtype=torch.long))
    assert logits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_init_matches_flax_initializer_statistics():
    model = get_model("gpt_tiny", num_classes=VOCAB)
    model.init_parameters(torch.Generator().manual_seed(0))
    w = model.blocks[0].attn.qkv.weight
    assert abs(w.std().item() - 0.02) < 1e-3
    assert model.blocks[0].ln1.weight.eq(1).all()
    assert model.blocks[0].attn.qkv.bias.eq(0).all()
    assert model.blocks[0].ffn_bias.eq(0).all()


def test_registry_names():
    cnn = get_model("enhanced_cnn", width=8)
    assert type(cnn).__name__ == "EnhancedCNNModel"
    assert cnn(torch.zeros(2, 32, 32, 3)).shape == (2, 10)
    with pytest.raises(NotImplementedError, match="A.7"):
        get_model("bert_tiny")
    with pytest.raises(ValueError, match="unknown model"):
        get_model("nope")
