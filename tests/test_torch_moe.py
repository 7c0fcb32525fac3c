"""The port's Switch-MoE FFN against the JAX package's ``MoEFFN`` inside
every transformer family (bert, gpt, llama and vit tiny with 4 experts),
at the default capacity factor and at 0.5, where tokens are dropped:
logits, the summed load-balance loss and every gradient, on transplanted
parameters."""

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
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.moe import (
    MoEFFN,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

EXPERTS, HEADS, VOCAB, SEQ, CLASSES, IMG = 4, 4, 97, 32, 10, 32
# fp32 on both sides; sums in another order only (routing is discrete:
# the seeds give no gate within rounding of a tie)
ATOL = 1e-4
# the aux loss enters the objective at weight 1 here (0.01 in training),
# so its gradients through the gate are held as tightly as the rest
AUX_W = 1.0


def _inputs(family, rng):
    if family == "vit_tiny":
        x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
        return x, (2, CLASSES), torch.from_numpy(x)
    ids = rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    return ids, (2, SEQ, VOCAB), torch.from_numpy(ids).long()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("family",
                         ["bert_tiny", "gpt_tiny", "llama_tiny", "vit_tiny"])
def test_moe_logits_aux_and_grads_match_flax(family, capacity_factor):
    ncls = CLASSES if family == "vit_tiny" else VOCAB
    fmodel = jax_get_model(family, num_classes=ncls, scan_layers=True,
                           num_experts=EXPERTS,
                           capacity_factor=capacity_factor)
    rng = np.random.default_rng(1)
    x, out_shape, xt = _inputs(family, rng)
    params = fmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    cot = (rng.normal(size=out_shape) / np.prod(out_shape[:-1])).astype(
        np.float32)

    def loss(p):
        logits, mut = fmodel.apply({"params": p}, jnp.asarray(x),
                                   mutable=["aux"])
        aux = sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(mut["aux"]))
        return (logits * cot).sum() + AUX_W * aux, (logits, aux)

    (_, (logits_want, aux_want)), grads_want = jax.value_and_grad(
        loss, has_aux=True)(params)

    tmodel = get_model(family, num_classes=ncls, num_experts=EXPERTS,
                       capacity_factor=capacity_factor)
    tmodel.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            weights.flax_to_torch(params).items()},
                           strict=True)
    kept = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: kept.append(
            m.route(inp[0].reshape(-1, inp[0].shape[-1]))[3].sum().item()
            / inp[0].shape[0] / inp[0].shape[1]))
        for m in tmodel.modules() if isinstance(m, MoEFFN)]
    logits, aux = tmodel(xt, with_aux=True)
    for h in hooks:
        h.remove()
    assert len(kept) == 2
    if capacity_factor < 1:
        # capacity ceil(0.5 N / 4) holds at most half the tokens
        assert all(k <= 0.5 for k in kept), kept
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(logits_want), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(aux_want), rtol=1e-6)
    ((logits * torch.from_numpy(cot)).sum() + AUX_W * aux).backward()
    grads = weights.torch_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}, num_heads=HEADS,
        num_kv_heads=0)
    want = jax.tree_util.tree_flatten_with_path(grads_want)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family",
                         ["bert_tiny", "gpt_tiny", "llama_tiny", "vit_tiny"])
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_moe_weights_round_trip_is_exact(family, scan_layers):
    ncls = CLASSES if family == "vit_tiny" else VOCAB
    fmodel = jax_get_model(family, num_classes=ncls, scan_layers=scan_layers,
                           num_experts=EXPERTS)
    x = (jnp.zeros((1, IMG, IMG, 3)) if family == "vit_tiny"
         else jnp.zeros((1, SEQ), jnp.int32))
    params = jax.tree_util.tree_map(
        np.asarray, fmodel.init(jax.random.key(5), x)["params"])
    sd = weights.flax_to_torch(params)
    assert sd["blocks.1.moe.w1"].shape[0] == EXPERTS
    back = weights.torch_to_flax(sd, num_heads=HEADS, stacked=scan_layers)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(want) == len(got)
    for path, leaf in want:
        assert np.array_equal(got[path], leaf), path
    model = get_model(family, num_classes=ncls, num_experts=EXPERTS)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)


def test_moe_routing_order_capacity_and_aux():
    """Queue positions follow the flattened token order; a full expert
    drops later tokens; with a uniform gate the aux loss E * sum f_e P_e
    is 1 whatever the routing."""
    moe = MoEFFN(8, 4, 16, capacity_factor=1.0)
    with torch.no_grad():
        moe.gate.weight.zero_()
        moe.gate.weight[0, 0] = 10.0          # feature 0 -> expert 0
        moe.gate.weight[1, 1] = 10.0          # feature 1 -> expert 1
    toks = torch.zeros(8, 8)
    toks[:6, 0] = 1.0                         # tokens 0..5 prefer expert 0
    toks[6:, 1] = 1.0                         # tokens 6, 7 prefer expert 1
    probs, onehot, pos, keep, cap = moe.route(toks)
    assert cap == 2
    assert onehot.argmax(-1)[:6].eq(0).all()
    assert pos[:6].tolist() == [0, 1, 2, 3, 4, 5]
    assert keep[:6].tolist() == [1, 1, 0, 0, 0, 0]
    assert pos[6:].tolist() == [0, 1] and keep[6:].eq(1).all()
    with torch.no_grad():
        moe.gate.weight.zero_()
    _, aux = moe(torch.randn(1, 8, 8))
    # a uniform gate routes every tie to expert 0: f = (1, 0, 0, 0), P = 1/4
    assert aux.item() == pytest.approx(1.0)
