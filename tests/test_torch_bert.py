"""The PyTorch port's BERT MLM against the JAX package's flax model on
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

VOCAB, SEQ, HEADS = 97, 128, 4
# fp32 on both sides; logits and grads differ by summation order only
ATOL = 1e-4


def _flax_bert_tiny(attention_impl="dense", scan_layers=True, seed=0):
    model = jax_get_model("bert_tiny", num_classes=VOCAB,
                          scan_layers=scan_layers,
                          attention_impl=attention_impl)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = model.init(jax.random.key(seed), ids)["params"]
    return model, params


def _torch_from_flax(params, attention_impl="dense"):
    model = get_model("bert_tiny", num_classes=VOCAB,
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
def test_bert_tiny_logits_and_grads_match_flax(attention_impl):
    """Bidirectional attention: the JAX side runs its Pallas kernel in
    interpret mode at L=128, the port its plain version on the CPU."""
    fmodel, params = _flax_bert_tiny(attention_impl)
    tmodel = _torch_from_flax(params, attention_impl)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
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
        {k: p.grad for k, p in tmodel.named_parameters()}, num_heads=HEADS)
    _assert_trees_close(grads, grads_want, ATOL)


def test_bert_base_param_count_on_meta():
    """BERT-base at synthetic_mlm's vocab of 1000: 12 x 7,087,872 in the
    layers, 1,161,216 + LN in the embeddings, 1,360,592 + LN in the head."""
    model = get_model("bert_base", num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 87_578_344
    assert sum(p.numel() for p in model.blocks[0].parameters()) == 7_087_872


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_weights_round_trip_is_exact(scan_layers):
    _, params = _flax_bert_tiny(scan_layers=scan_layers, seed=3)
    sd = weights.flax_to_torch(params)
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


def test_bf16_compute_keeps_fp32_params_and_bf16_logits():
    model = get_model("bert_tiny", num_classes=VOCAB, dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(0))
    logits = model(torch.zeros(2, 16, dtype=torch.long))
    assert logits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_init_matches_flax_initializer_statistics():
    model = get_model("bert_tiny", num_classes=VOCAB)
    model.init_parameters(torch.Generator().manual_seed(0))
    for w in (model.blocks[0].attn.qkv.weight, model.tok_emb.weight,
              model.pos_emb.weight, model.mlm_decoder.weight):
        assert abs(w.std().item() - 0.02) < 2e-3
    assert model.ln_emb.weight.eq(1).all() and model.mlm_ln.bias.eq(0).all()
    assert model.blocks[0].ffn_bias.eq(0).all()
    assert model.mlm_decoder.bias.eq(0).all()
