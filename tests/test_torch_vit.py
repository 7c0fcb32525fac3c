"""The PyTorch port's ViT against the JAX package's flax model on
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

CLASSES, IMG, HEADS = 10, 32, 4
# fp32 on both sides; logits and grads differ by summation order only
ATOL = 1e-4


def _flax_vit_tiny(attention_impl="dense", scan_layers=True, seed=0):
    model = jax_get_model("vit_tiny", num_classes=CLASSES,
                          scan_layers=scan_layers,
                          attention_impl=attention_impl)
    x = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    params = model.init(jax.random.key(seed), x)["params"]
    return model, params


def _torch_from_flax(params, attention_impl="dense"):
    model = get_model("vit_tiny", num_classes=CLASSES,
                      attention_impl=attention_impl)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in weights.flax_to_torch(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _assert_trees_close(got_tree, want_tree, atol):
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
def test_vit_tiny_logits_and_grads_match_flax(attention_impl):
    """vit_tiny's 16 patches are no multiple of the TPU kernel's block, so
    the JAX side falls back to its dense reference (as it logs); the port
    runs its flash path's plain version on the CPU."""
    fmodel, params = _flax_vit_tiny(attention_impl)
    tmodel = _torch_from_flax(params, attention_impl)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    cot = (rng.normal(size=(3, CLASSES)) / 3).astype(np.float32)

    def loss(p):
        logits = fmodel.apply({"params": p}, jnp.asarray(x))
        return (logits * cot).sum(), logits

    (_, logits_want), grads_want = jax.value_and_grad(loss, has_aux=True)(
        params)
    logits = tmodel(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (3, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_want), atol=ATOL)
    (logits * torch.from_numpy(cot)).sum().backward()
    grads = weights.torch_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}, num_heads=HEADS)
    _assert_trees_close(grads, grads_want, ATOL)


def test_vit_s16_param_count_and_sequence_on_meta():
    """ViT-S/16 at 224x224: patch embed 295,296, pos 75,264 (196 patches,
    no class token), 12 x 1,774,464 in the layers, head 385,000."""
    model = get_model("vit_s16", device="meta")
    assert sum(p.numel() for p in model.parameters()) == 22_049_128
    assert tuple(model.pos_emb.shape) == (1, 196, 384)
    b16 = get_model("vit_b16", device="meta")
    assert (len(b16.blocks), b16.blocks[0].ffn_in.out_features) == (12, 3072)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_weights_round_trip_is_exact(scan_layers):
    _, params = _flax_vit_tiny(scan_layers=scan_layers, seed=3)
    sd = weights.flax_to_torch(params)
    assert sd["pos_emb"].shape == (1, 16, 64)
    assert sd["patch_embed.weight"].shape == (64, 8 * 8 * 3)
    back = weights.torch_to_flax(sd, num_heads=HEADS, stacked=scan_layers)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        assert np.array_equal(got[path], np.asarray(leaf)), path
    model = _torch_from_flax(params)
    sd2 = weights.flax_to_torch(weights.torch_to_flax(
        model.state_dict(), num_heads=HEADS, stacked=scan_layers))
    for k, v in model.state_dict().items():
        assert np.array_equal(sd2[k], v.numpy()), k


def test_bf16_compute_keeps_fp32_params_and_fp32_head():
    """The classifier runs in fp32 on the mean-pooled bf16 activations
    (``models/vit.py:137-141``)."""
    model = get_model("vit_tiny", num_classes=CLASSES, dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(0))
    logits = model(torch.zeros(2, IMG, IMG, 3))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_init_matches_flax_initializer_statistics():
    model = get_model("vit_s16", num_classes=CLASSES)
    model.init_parameters(torch.Generator().manual_seed(0))
    for w in (model.patch_embed.weight, model.pos_emb,
              model.blocks[0].attn.qkv.weight, model.head.weight):
        assert abs(w.std().item() - 0.02) < 2e-3
    assert model.patch_embed.bias.eq(0).all() and model.head.bias.eq(0).all()
    assert model.blocks[0].ln_attn.weight.eq(1).all()
