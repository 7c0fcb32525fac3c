"""The PyTorch port's Llama family against the JAX package's flax model on
transplanted parameters: RoPE, the RoPE self-attention, ``llama_tiny``
logits and grads (dense, flash two-pass and flash fused backward), the
weight converter's Llama layout, parameter counts, init and the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as jax_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models.bert import (
    SelfAttention as JSelfAttention,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.ops import (
    attention as j_attn,
    pallas_ops,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.bert import (
    SelfAttention,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.ops import (
    attention as t_attn,
    flash as t_flash,
)

VOCAB, SEQ, HEADS = 97, 128, 4
# fp32 on both sides; logits and grads differ by summation order only
ATOL = 1e-4
KV_CASES = [pytest.param(None, id="mha"), pytest.param(2, id="gqa2")]


def _flax_llama_tiny(num_kv_heads=None, attention_impl="dense",
                     scan_layers=True, seed=0):
    model = jax_get_model("llama_tiny", num_classes=VOCAB,
                          scan_layers=scan_layers,
                          attention_impl=attention_impl,
                          num_kv_heads=num_kv_heads)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = model.init(jax.random.key(seed), ids)["params"]
    return model, params


def _torch_from_flax(params, num_kv_heads=None, attention_impl="dense"):
    model = get_model("llama_tiny", num_classes=VOCAB,
                      num_kv_heads=num_kv_heads,
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


@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 3, 16)).astype(np.float32)
    pos = np.arange(5, 42)
    want = j_attn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_attn.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rope_keeps_bf16_and_leaves_position_zero():
    x = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    y = t_attn.rope(x.bfloat16(), torch.arange(4))
    assert y.dtype == torch.bfloat16
    # angle 0 at position 0: the rotation is the identity there
    assert torch.equal(y[:, 0], x.bfloat16()[:, 0])


@pytest.mark.parametrize("num_kv_heads", KV_CASES)
def test_rope_self_attention_matches_flax(num_kv_heads):
    hidden = 64
    fmod = JSelfAttention(HEADS, causal=True, rope_theta=10000.0,
                          use_bias=False, num_kv_heads=num_kv_heads)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, hidden)).astype(np.float32)
    params = fmod.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = fmod.apply({"params": params}, jnp.asarray(x))
    tmod = SelfAttention(hidden, HEADS, num_kv_heads=num_kv_heads,
                         use_bias=False, causal=True, rope_theta=10000.0)
    sd = weights._block_to_torch({"attn": jax.device_get(params)})
    tmod.load_state_dict({k[len("attn."):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def _logits_and_grads_match(num_kv_heads, attention_impl):
    fmodel, params = _flax_llama_tiny(num_kv_heads, attention_impl)
    tmodel = _torch_from_flax(params, num_kv_heads, attention_impl)
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
        {k: p.grad for k, p in tmodel.named_parameters()}, num_heads=HEADS,
        num_kv_heads=num_kv_heads or 0)
    _assert_trees_close(grads, grads_want, ATOL)


@pytest.mark.parametrize("attention_impl", ["dense", "flash"])
@pytest.mark.parametrize("num_kv_heads", KV_CASES)
def test_llama_tiny_logits_and_grads_match_flax(num_kv_heads,
                                                attention_impl):
    _logits_and_grads_match(num_kv_heads, attention_impl)


@pytest.mark.parametrize("num_kv_heads", KV_CASES)
def test_llama_tiny_fused_backward_matches_flax(monkeypatch, num_kv_heads):
    """FLASH_BWD=fused on both sides: the Pallas fused kernel (interpret
    mode) and the port's plain fused backward; nothing is launched."""
    monkeypatch.setattr(pallas_ops, "_FUSED_BWD", True)
    monkeypatch.setattr(t_flash, "_FUSED_BWD", True)
    t_flash.reset_launch_counts()
    _logits_and_grads_match(num_kv_heads, "flash")
    assert all(n == 0 for n in t_flash.LAUNCHES.values())


@pytest.mark.parametrize("num_kv_heads", KV_CASES)
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_weights_round_trip_is_exact(scan_layers, num_kv_heads):
    _, params = _flax_llama_tiny(num_kv_heads, scan_layers=scan_layers,
                                 seed=3)
    sd = weights.flax_to_torch(params)
    assert not any(k.startswith(("pos_emb", "ln")) or "bias" in k
                   for k in sd)
    back = weights.torch_to_flax(sd, num_heads=HEADS,
                                 num_kv_heads=num_kv_heads or 0,
                                 stacked=scan_layers)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        assert np.array_equal(got[path], np.asarray(leaf)), path
    # and the other way: torch state_dict -> flax -> torch
    model = _torch_from_flax(params, num_kv_heads)
    sd2 = weights.flax_to_torch(weights.torch_to_flax(
        model.state_dict(), num_heads=HEADS, num_kv_heads=num_kv_heads or 0,
        stacked=scan_layers))
    assert set(sd2) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert np.array_equal(sd2[k], v.numpy()), k


@pytest.mark.parametrize("num_kv_heads,count", [
    (None, 271_090_688), (4, 245_924_864)], ids=["mha", "gqa4"])
def test_llama_medium_param_count_matches_flax(num_kv_heads, count):
    fmodel = jax_get_model("llama_medium", num_classes=32000,
                           num_kv_heads=num_kv_heads)
    shapes = jax.eval_shape(fmodel.init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    model = get_model("llama_medium", num_classes=32000,
                      num_kv_heads=num_kv_heads, device="meta")
    got = sum(p.numel() for p in model.parameters())
    assert got == want == count


def test_llama_medium_path_width_param_count():
    """The path's configuration: vocab 1000 (synthetic_lm), 4 KV heads."""
    model = get_model("llama_medium", num_classes=1000, num_kv_heads=4,
                      device="meta")
    assert sum(p.numel() for p in model.parameters()) == 182_436_864


def test_init_matches_flax_initializer_statistics():
    _, params = _flax_llama_tiny(2, seed=5)
    model = get_model("llama_tiny", num_classes=VOCAB, num_kv_heads=2)
    model.init_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    flat = weights.flax_to_torch(params)
    assert set(sd) == set(flat)
    for key, want in flat.items():
        got = sd[key].numpy()
        if key.endswith(("rms1.weight", "rms2.weight", "rms_f.weight")):
            assert np.array_equal(got, np.asarray(want)), key
            assert (got == 1).all(), key
        else:
            # N(0, 0.02) on both sides: same spread, different draws
            assert abs(got.std() - 0.02) < 3e-3, key
            assert abs(np.asarray(want).std() - 0.02) < 3e-3, key


def test_bf16_compute_keeps_fp32_params_and_bf16_logits():
    model = get_model("llama_tiny", num_classes=VOCAB, num_kv_heads=2,
                      dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(0))
    logits = model(torch.zeros(2, 16, dtype=torch.long))
    assert logits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_registry_names():
    small = get_model("llama_tiny", num_classes=VOCAB)
    assert (len(small.blocks), small.blocks[0].ffn_in.out_features,
            small.num_heads) == (2, 176, 4)
    medium = get_model("llama_medium", device="meta")
    assert (len(medium.blocks), medium.blocks[0].ffn_up.out_features,
            medium.num_classes) == (16, 2816, 32000)
    for name, cls in (("bert_base", "BertForMLM"), ("vit_s16", "ViT")):
        assert type(get_model(name, device="meta")).__name__ == cls
