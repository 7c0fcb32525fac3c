"""Card-only tests of the PyTorch port (marker ``cuda``): its CUDA kernels,
and the image models, BatchNorm and augmentation on the card against the
CPU path.

The kernels have no CPU mode, so every test here skips without a CUDA
device.  The file imports nothing of JAX, so it also runs on a machine
without it, skipping the repository's JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

``chip_smoke.py`` runs the same comparisons at the main path's full size.
"""

import gc

import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
    augment as t_augment,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    MODEL_INPUT_SPECS,
    get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models.norm import (
    BatchNorm,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.ops import (
    flash as t_flash,
)

pytestmark = pytest.mark.cuda

# bf16 outputs of fp32 accumulations in another order than the fp32 plain
# version: 2e-2 of each tensor's largest magnitude (bf16 spacing is 2^-8
# relative); lse stays fp32 end to end: 1e-3 absolute
REL_TOL, LSE_TOL = 2e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, l, h, kv, d, dtype=torch.bfloat16, seed=4):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(cuda, dtype)
    return mk(b, l, h, d), mk(b, l, kv, d), mk(b, l, kv, d), mk(b, l, h, d)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernels_match_plain_versions_on_ragged_gqa(cuda, causal, dtype):
    """L=200 (not a tile multiple) and 8 query heads over 4 K/V heads."""
    q, k, v, do = _inputs(cuda, 2, 200, 8, 4, 64, dtype)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = t_flash.plain_forward(*f32[:3], causal)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    o, lse = t_flash.kernel_forward(q, k, v, causal, with_lse=True)
    dq = t_flash.kernel_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = t_flash.kernel_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    want = (o_ref, t_flash.plain_bwd_dq(*f32, lse_ref, delta, causal),
            *t_flash.plain_bwd_dkv(*f32, lse_ref, delta, causal))
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        assert got.dtype == dtype, name
        assert _rel(got, ref) <= REL_TOL, name
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_autograd_on_strided_views_matches_cpu_plain_path(cuda):
    """q/k/v as strided views of one fused projection, as the model hands
    them over: the kernels' gradients against the plain path on the CPU,
    and one launch of each kernel per call."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 96, 3, 4, 32)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 96, 4, 32)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        x = qkv.to(dev).requires_grad_()
        q, k, v = x.unbind(2)
        t_flash.reset_launch_counts()
        out = t_flash.flash_attention(q, k, v, causal=True)
        (dx,) = torch.autograd.grad(out, x, g.to(dev))
        grads[dev] = (out.detach().cpu(), dx.cpu())
        launches = dict(t_flash.LAUNCHES)
        assert launches == ({"flash_fwd": 1, "flash_bwd_dq": 1,
                             "flash_bwd_dkv": 1, "flash_bwd_fused": 0}
                            if dev == "cuda" else
                            {"flash_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0, "flash_bwd_fused": 0})
    # fp32 on both sides, different summation order
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fused_kernel_matches_plain_version_on_ragged_gqa(cuda, causal,
                                                          dtype):
    """L=200 (not a tile multiple), 8 query heads over 4 K/V heads (two
    members per group, so the group loop and the dq atomics from several
    key tiles both run).  The dq atomics sum in another order each run."""
    q, k, v, do = _inputs(cuda, 2, 200, 8, 4, 64, dtype, seed=6)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = t_flash.plain_forward(*f32[:3], causal)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    t_flash.reset_launch_counts()
    got = t_flash.kernel_bwd_fused(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert t_flash.LAUNCHES["flash_bwd_fused"] == 1
    want = t_flash.plain_bwd_fused(*f32, lse_ref, delta, causal)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        assert _rel(g, ref) <= REL_TOL, name


def test_fused_autograd_on_strided_views_matches_cpu_plain_path(
        cuda, monkeypatch):
    """With the switch on, grads through q/k/v views of one GQA projection
    against the CPU plain path, and one fused launch per backward."""
    monkeypatch.setattr(t_flash, "_FUSED_BWD", True)
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 96, 8, 32)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 96, 4, 32)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        x = qkv.to(dev).requires_grad_()
        q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 6:]
        t_flash.reset_launch_counts()
        out = t_flash.flash_attention(q, k, v, causal=True)
        (dx,) = torch.autograd.grad(out, x, g.to(dev))
        grads[dev] = (out.detach().cpu(), dx.cpu())
        n = int(dev == "cuda")
        assert dict(t_flash.LAUNCHES) == {
            "flash_fwd": n, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": n}
    # fp32 on both sides, different summation order (dq by atomics)
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def _close(got, ref, tol=REL_TOL):
    """max |got - ref| within ``tol`` of max |ref|; a reference that is
    zero to rounding (dq and dk at L=1, where ds = p (dp - delta) cancels)
    is measured against 1e-3 instead."""
    err = (got.float() - ref.float()).abs().max().item()
    return err <= tol * max(ref.float().abs().max().item(), 1e-3)


def _check_tensor_core_kernels(q, k, v, do, causal):
    """The bf16 forward (with and without lse), the two-pass pair and the
    fused backward against the plain versions on the same bf16 values."""
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = t_flash.plain_forward(*f32[:3], causal)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    o, lse = t_flash.kernel_forward(q, k, v, causal, with_lse=True)
    o_nolse, no_lse = t_flash.kernel_forward(q, k, v, causal)
    dq = t_flash.kernel_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = t_flash.kernel_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    fused = t_flash.kernel_bwd_fused(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert no_lse is None and torch.equal(o_nolse, o)
    assert o.dtype == torch.bfloat16 and _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    want = t_flash.plain_bwd_fused(*f32, lse_ref, delta, causal)
    for kernel, got in (("pair", (dq, dk, dv)), ("fused", fused)):
        for name, g, ref in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.bfloat16, (kernel, name)
            assert _close(g, ref), (kernel, name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 127, 129, 200])
def test_tensor_core_kernels_at_tile_edges(cuda, length, causal):
    """Lengths on and around the 64-row tiles (ragged tails, a single
    row), 8 query heads over 4 K/V heads, D=64."""
    _check_tensor_core_kernels(*_inputs(cuda, 2, length, 8, 4, 64, seed=8),
                               causal)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_tensor_core_kernels_across_head_dims_and_groups(cuda, head_dim,
                                                         rep):
    """Every instantiated head dim (D=128 runs 32-row query tiles in the
    backward) with 4 query heads over 4, 2 or 1 K/V heads, L=129."""
    _check_tensor_core_kernels(
        *_inputs(cuda, 2, 129, 4, 4 // rep, head_dim, seed=9), True)


def test_tensor_core_kernels_take_views_and_copy_misaligned_rows(cuda):
    """q/k/v as strided views of one GQA projection go in without a copy;
    an operand whose rows are misaligned on purpose (base 2 bytes off) is
    copied, not refused, and gives the same results."""
    rng = np.random.default_rng(10)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(cuda, torch.bfloat16)
    proj, do = mk(2, 129, 12, 64), mk(2, 129, 8, 64)
    q, k, v = proj[:, :, :8], proj[:, :, 8:10], proj[:, :, 10:]
    assert all(t_flash._rows_aligned(t) for t in (q, k, v, do))
    _check_tensor_core_kernels(q, k, v, do, True)

    buf = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    q_off = buf[1:].view(q.shape).copy_(q)
    assert not t_flash._rows_aligned(q_off)
    _check_tensor_core_kernels(q_off, k, v, do, True)
    o, lse = t_flash.kernel_forward(q, k, v, True, with_lse=True)
    o_off, lse_off = t_flash.kernel_forward(q_off, k, v, True, with_lse=True)
    assert torch.equal(o_off, o) and torch.equal(lse_off, lse)


def test_fused_tensor_core_kernel_repeats_within_tolerance(cuda):
    """Two runs on the same inputs: dk and dv (summed in registers) are
    identical; dq, summed by atomics in an order that changes from run to
    run, agrees within the tolerance."""
    q, k, v, do = _inputs(cuda, 2, 200, 8, 2, 64, seed=11)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = t_flash.plain_forward(*f32[:3], True)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    first = t_flash.kernel_bwd_fused(q, k, v, do, lse_ref, delta, True)
    second = t_flash.kernel_bwd_fused(q, k, v, do, lse_ref, delta, True)
    torch.cuda.synchronize()
    assert _close(second[0], first[0])
    assert torch.equal(second[1], first[1])
    assert torch.equal(second[2], first[2])


def test_two_pass_tensor_core_kernels_repeat_bitwise(cuda):
    """Two runs of the pair on the same inputs give the same bits: every
    block writes its outputs once from registers, with no atomics."""
    q, k, v, do = _inputs(cuda, 2, 200, 8, 2, 64, seed=12)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = t_flash.plain_forward(*f32[:3], True)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    runs = [(t_flash.kernel_bwd_dq(q, k, v, do, lse_ref, delta, True),
             *t_flash.kernel_bwd_dkv(q, k, v, do, lse_ref, delta, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(second, first), name


def test_cuda_inputs_the_kernels_do_not_take_raise(cuda):
    q = torch.zeros(1, 16, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="attention_impl dense"):
        t_flash.flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 16, 4, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        t_flash.flash_attention(q, q, q, causal=True)


def test_fused_kernel_refuses_inputs_it_does_not_take(cuda, monkeypatch):
    monkeypatch.setattr(t_flash, "_FUSED_BWD", True)
    q = torch.zeros(1, 16, 4, 48, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        t_flash.flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 16, 4, 48, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(RuntimeError, match="flash_bwd_fused kernel launch"):
        t_flash.kernel_bwd_fused(q, q, q, q, lse, lse, True)


CNN_MODELS = ("enhanced_cnn", "mlp", "lenet5", "resnet18", "resnet50")
# bf16 on the card against fp32 on the CPU through the whole network, one
# bf16 rounding per layer each way: logits within 5e-2 of the largest; the
# gradient of all parameters within 0.1 of its largest element and 0.15
# of its norm (backward roundings compound towards the input: the CPU's
# own bf16 path on these inputs is off by up to 5.1e-2 and 9.1e-2 of
# them, 15 % on the first layers' tensors)
LOGIT_TOL, GRAD_MAX_TOL, GRAD_NORM_TOL = 5e-2, 0.1, 0.15


def _cnn_pass(name, device, dtype, state, x, cot):
    """Eval-mode logits and parameter gradients of <logits, cot> of the
    full-width model ``name`` loaded from ``state``, in ``channels_last``;
    returned on the CPU as fp32."""
    model = get_model(name, num_classes=10, dtype=dtype, device=device)
    model.load_state_dict(state)
    model = model.to(memory_format=torch.channels_last).eval()
    logits = model(x.to(device))
    (logits * cot.to(device)).sum().backward()
    return (logits.detach().float().cpu(),
            [p.grad.float().cpu() for p in model.parameters()])


@pytest.mark.parametrize("name", CNN_MODELS)
def test_cnn_bf16_channels_last_on_card_matches_cpu_fp32(cuda, name):
    """Batch 8, eval mode on BatchNorm statistics moved off their init
    values (in train mode a small batch's statistics amplify rounding far
    beyond bf16's own error, see tests/test_torch_cnn.py)."""
    torch.manual_seed(0)
    model = get_model(name, num_classes=10)
    model.init_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    for key, t in state.items():
        if key.endswith(("running_var", "bn1.weight", "bn2.weight")):
            t.uniform_(0.5, 1.5)
        elif key.endswith("running_mean"):
            t.normal_(0.0, 0.1)
    x = torch.randn(8, *MODEL_INPUT_SPECS[name][0])
    cot = torch.randn(8, 10)
    ref_logits, ref_grads = _cnn_pass(name, "cpu", torch.float32, state, x,
                                      cot)
    logits, grads = _cnn_pass(name, cuda, torch.bfloat16, state, x, cot)
    assert _rel(logits, ref_logits) <= LOGIT_TOL
    got, ref = torch.cat([g.flatten() for g in grads]), torch.cat(
        [g.flatten() for g in ref_grads])
    assert _rel(got, ref) <= GRAD_MAX_TOL
    assert ((got - ref).norm() / ref.norm()).item() <= GRAD_NORM_TOL


def test_batchnorm_update_on_card_matches_cpu(cuda):
    """The same bf16 values through train mode on the card (bf16) and on the
    CPU (fp32): fp32 statistics in another summation order, 1e-5 of their
    size; the bf16 output within bf16 rounding."""
    x = (torch.randn(16, 64, 32, 32) * 2 + 1).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    out = {}
    for dev, inp in (("cpu", x.float()), (cuda, x.to(cuda))):
        bn = BatchNorm(64, device=dev).train()
        y = bn(inp)
        out[str(dev)] = (y.detach().float().cpu(), bn.running_mean.cpu(),
                         bn.running_var.cpu())
        assert y.dtype == inp.dtype and bn.running_var.dtype == torch.float32
    (y_ref, mean_ref, var_ref), (y, mean, var) = out["cpu"], out["cuda"]
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, var_ref, rtol=1e-5, atol=1e-6)
    assert _rel(y, y_ref) <= 1e-2


def test_augment_batch_on_a_cuda_generator(cuda):
    """Shape, dtype and device kept, a seed repeats, every cutout square is
    zero, and the same draws give the CPU's result."""
    x = torch.randn(64, 32, 32, 3, device=cuda)
    runs = [t_augment.augment_batch(
        x, torch.Generator(device=cuda).manual_seed(3)) for _ in range(2)]
    assert runs[0].shape == x.shape and runs[0].dtype == x.dtype
    assert runs[0].device == x.device and torch.equal(runs[0], runs[1])
    draws = t_augment.draw(64, 32, 32,
                           torch.Generator(device=cuda).manual_seed(3), cuda)
    assert all(d.device == x.device for d in draws.values())
    for i in range(64):
        cy, cx = int(draws["cy"][i]), int(draws["cx"][i])
        assert runs[0][i, max(cy - 4, 0):cy + 5,
                       max(cx - 4, 0):cx + 5].eq(0).all()
    cpu = t_augment.apply_augment(x.cpu(), {k: v.cpu() for k, v in
                                            draws.items()})
    torch.testing.assert_close(runs[0].cpu(), cpu, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(64, 128, 12, 12), (64, 196, 6, 6)],
                         ids=["bert_path", "vit_path"])
def test_tensor_core_kernels_at_encoder_path_shapes(cuda, shape):
    """The bidirectional instances the encoder paths run: BERT-base's
    [64, 128, 12, 64] and ViT-S/16's [64, 196, 6, 64], whose last key and
    query tiles hold 4 rows (196 = 3 x 64 + 4)."""
    _check_tensor_core_kernels(*_inputs(cuda, *shape, 64, seed=9),
                               causal=False)


def _encoder_pass(name, device, state, x, cot, **kw):
    model = get_model(name, num_classes=cot.shape[-1],
                      attention_impl="flash", device=device, **kw)
    model.load_state_dict(state)
    logits, aux = model(x.to(device), with_aux=True)
    loss = (logits * cot.to(device)).sum() + (0 if aux is None else aux)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return logits.detach().cpu(), [g.cpu() for g in grads]


@pytest.mark.parametrize("name,experts,policy", [
    ("bert_tiny", 0, "none"), ("vit_tiny", 0, "none"),
    ("bert_tiny", 4, "none"), ("bert_tiny", 0, "offload_names:attn_out"),
    ("bert_tiny", 4, "save_names:moe_dispatch,block_out"),
], ids=["bert", "vit", "bert_moe", "bert_offload", "bert_moe_names"])
def test_encoder_families_on_card_match_cpu_fp32(cuda, name, experts,
                                                  policy):
    """fp32 on both sides (the flash kernels' fp32 instance on the card,
    the plain version on the CPU): logits and every gradient at atol 1e-4.
    vit_tiny at 48 x 48 has 36 patches, a ragged tile; on the card
    offload_names keeps attn_out in pinned host memory."""
    torch.manual_seed(0)
    # hidden 128 over 4 heads: head_dim 32, an instance the kernels take
    kw = dict(num_experts=experts, remat_policy=policy, hidden=128)
    if name == "vit_tiny":
        kw["input_shape"] = (48, 48, 3)
        x, ncls = torch.randn(2, 48, 48, 3), 10
        cot = torch.randn(2, ncls)
    else:
        x, ncls = torch.randint(0, 97, (2, 96)), 97
        cot = torch.randn(2, 96, ncls) / 192
    model = get_model(name, num_classes=ncls, **kw)
    model.init_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    ref = _encoder_pass(name, "cpu", state, x, cot, **kw)
    got = _encoder_pass(name, cuda, state, x, cot, **kw)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-4)
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4)


def test_remat_policies_on_card_are_bitwise_none(cuda):
    """bf16 bert_tiny (hidden 128) with flash on the card: every policy's
    loss and gradients are the same bits as none's (the recompute repeats
    the same deterministic kernels; offload_names really goes through
    pinned host memory here)."""
    x = torch.randint(0, 97, (4, 128), device=cuda)
    base = get_model("bert_tiny", num_classes=97, attention_impl="flash",
                     dtype=torch.bfloat16, hidden=128, device=cuda)
    base.init_parameters(torch.Generator(device=cuda).manual_seed(0))
    results = {}
    for policy in ("none", "everything", "dots_saveable",
                   "save_names:attn_out,block_out", "offload_names:attn_out"):
        model = get_model("bert_tiny", num_classes=97, attention_impl="flash",
                          dtype=torch.bfloat16, remat_policy=policy,
                          hidden=128, device=cuda)
        model.load_state_dict(base.state_dict())
        loss = model(x).float().square().mean()
        results[policy] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    loss0, grads0 = results.pop("none")
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), policy


def _tiny_engine_state(name, device, seed, **kw):
    """A tiny model's engine and train state on ``device``, with moments,
    count, clock and seed words set off their init."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
        Config,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.train import (
        LocalSGDEngine,
    )
    model = get_model(name, num_classes=97, dtype=torch.float32,
                      device=device, **kw)
    model.init_parameters(torch.Generator(device=device).manual_seed(seed))
    engine = LocalSGDEngine(model, Config(model=name, device="cpu",
                                          seed=seed), device)
    state = engine.init_state()
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for m in state.opt.mu + state.opt.nu:
        m.normal_(generator=g)
    state.opt.count, state.lr_epoch = 7, 3
    return engine, state


def test_checkpoint_roundtrip_from_cuda_tensors(cuda, tmp_path):
    """An async save of a train state on the card (snapshot = D2H copies
    behind a synchronize), restored into a fresh engine on the card: every
    tensor, the count, the clock and the seed words equal."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        checkpoint as t_ckpt,
    )
    engine, state = _tiny_engine_state("llama_tiny", cuda, 0,
                                       num_kv_heads=2)
    eng = t_ckpt.CheckpointEngine(str(tmp_path), async_write=True)
    timing = {}
    eng.save(engine.checkpoint_state(state), 4, timing=timing)
    eng.close()
    assert timing["ckpt_snapshot_ms"] > 0 and timing["ckpt_write_ms"] > 0
    fresh, fstate = _tiny_engine_state("llama_tiny", cuda, 5,
                                       num_kv_heads=2)
    restored, epoch = t_ckpt.restore_checkpoint(
        t_ckpt.latest_checkpoint(str(tmp_path)),
        fresh.checkpoint_state(fstate))
    fstate = fresh.load_checkpoint_state(fstate, restored)
    want, got = (e.checkpoint_state(s) for e, s in ((engine, state),
                                                     (fresh, fstate)))
    assert epoch == 4
    for k, t in want.tensors().items():
        assert got.tensors()[k].device == t.device
        assert torch.equal(got.tensors()[k], t), k
    assert (got.count, got.lr_epoch, list(got.rng)) == (
        want.count, want.lr_epoch, list(want.rng))


@pytest.mark.parametrize("name,kw", [("gpt_tiny", {}),
                                     ("llama_tiny", {"num_kv_heads": 2})],
                         ids=["gpt", "llama_gqa"])
def test_serve_engine_on_card_matches_cpu(cuda, name, kw):
    """The paged decode on the card against the same engine on the CPU
    (fp32, TF32 off): greedy streams equal through the scheduler, and the
    prefill and decode logits within 1e-4."""
    import copy

    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        Request,
        ServeEngine,
    )
    cpu_model = get_model(name, num_classes=97, dtype=torch.float32, **kw)
    cpu_model.init_parameters(torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(cuda)
    geo = dict(max_batch=3, page_size=4, max_pages=32, prompt_buckets=(8, 16),
               max_seq=24)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(1, 97, 4 + 2 * i).tolist(),
                    max_new_tokens=6) for i in range(5)]
    streams = []
    for model in (cpu_model, card_model):
        out = ContinuousBatchingScheduler(ServeEngine(model, **geo)).run(
            reqs)
        streams.append([c.tokens for c in out["completions"]])
        assert out["pages"]["leaked"] == 0
    assert streams[0] == streams[1]
    logits = []
    for model in (cpu_model, card_model):
        eng = ServeEngine(model, **geo)
        row = eng.table_row(eng.allocator.alloc(4))
        _, first = eng.prefill(reqs[3].prompt, row, 0.0, 3)
        table = np.zeros((3, eng.pages_per_seq), np.int32)
        table[0] = row
        _, dec = eng.decode([5, 0, 0], [len(reqs[3].prompt), 0, 0], table,
                            np.zeros(3, np.float32), [3, 0, 0],
                            [True, False, False])
        logits.append((first.cpu(), dec[0].cpu()))
    for a, b in zip(*logits):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)


@pytest.mark.parametrize("name,kw", [("gpt_tiny", {}),
                                     ("llama_tiny", {"num_kv_heads": 2})])
def test_speculative_serve_on_card_matches_cpu(cuda, name, kw):
    """Speculative decoding on the card (fp32, TF32 off): the streams equal
    the card's plain run and the CPU's speculative run, with the same
    accepted counts, and both pools end empty."""
    import copy

    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.serve import (
        ContinuousBatchingScheduler,
        Request,
        ServeEngine,
    )
    geo = dict(max_batch=3, page_size=4, max_pages=32, prompt_buckets=(8, 16),
               max_seq=24)
    models = []
    for seed in (0, 99):
        m = get_model(name, num_classes=97, dtype=torch.float32, **kw)
        m.init_parameters(torch.Generator().manual_seed(seed))
        models.append(m)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(1, 97, 4 + 2 * i).tolist(),
                    max_new_tokens=6) for i in range(5)]
    outs = []
    for device in ("cpu", cuda):
        target, draft = (copy.deepcopy(m).to(device) for m in models)
        eng = ServeEngine(target, draft=ServeEngine(draft, **geo),
                          spec_tokens=3, **geo)
        out = ContinuousBatchingScheduler(eng).run(reqs)
        assert out["pages"]["leaked"] == out["pages"]["draft_leaked"] == 0
        outs.append(out)
    plain = ContinuousBatchingScheduler(ServeEngine(
        copy.deepcopy(models[0]).to(cuda), **geo)).run(reqs)
    streams = [[c.tokens for c in o["completions"]]
               for o in (*outs, plain)]
    assert streams[0] == streams[1] == streams[2]
    assert outs[0]["spec"] == outs[1]["spec"]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_streamed_round_on_card_is_bitwise_the_whole_round(cuda, prefetch):
    """enhanced_cnn (width 8, bf16, augmentation on) on the card: a round
    streamed in windows of 3 through pinned buffers and the side-stream
    copies equals the whole round bit for bit."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        config as t_config,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        driver as t_driver,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        train as t_train,
    )
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.data import (
        load_dataset,
        pack_window,
        window_feed,
    )
    cfg = t_config.Config(model="enhanced_cnn", model_width=8,
                          dataset="cifar10", batch_size=16, epochs_local=2,
                          stream_chunk_steps=3, stream_prefetch=prefetch)
    ds, _ = load_dataset("cifar10", "data", 0, 200, 4)
    tr, va = np.arange(150), np.arange(150, 190)
    runs = []
    for streamed in (False, True):
        model = t_driver.build_model_for(cfg, 10, cuda, ds.images.shape[1:])
        engine = t_train.LocalSGDEngine(model, cfg, cuda)
        state = engine.init_state()
        if streamed:
            state, mx = engine.round_streamed(
                state, window_feed(ds.images, ds.labels, tr, 16, 3, 12),
                window_feed(ds.images, ds.labels, va, 16, 3, 3))
        else:
            state, mx = engine.round(
                state, tuple(a[None] for a in pack_window(
                    ds.images, ds.labels, tr, 16, 0, 10)),
                tuple(a[None] for a in pack_window(
                    ds.images, ds.labels, va, 16, 0, 3)))
        runs.append((mx, {k: v.detach().cpu() for k, v in
                          engine.checkpoint_state(state).tensors().items()}))
    (w_mx, w_state), (s_mx, s_state) = runs
    np.testing.assert_array_equal(s_mx["batch_losses"][..., :10],
                                  w_mx["batch_losses"])
    for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_array_equal(s_mx[key], w_mx[key], err_msg=key)
    for k in w_state:
        assert torch.equal(s_state[k], w_state[k]), k


@pytest.mark.parametrize("fused", [False, True], ids=["two_pass", "fused"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_ops_under_vmap_launch_once_for_all_workers(cuda, monkeypatch,
                                                          fused, causal):
    """The scenario lab's form: each flash op under ``torch.func.vmap``
    over 3 workers of [2, 96, 8/4, 64] bf16 (the backward under
    ``vmap(grad(...))``) launches its kernel once for all workers, and
    each worker's O and gradients match its plain version (fp32 on the
    same bf16 values) at REL_TOL."""
    from torch.func import grad, vmap
    monkeypatch.setattr(t_flash, "_FUSED_BWD", fused)
    n = 3
    rng = np.random.default_rng(9)
    mk = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v, w = mk(n, 2, 96, 8, 64), mk(n, 2, 96, 4, 64), \
        mk(n, 2, 96, 4, 64), mk(n, 2, 96, 8, 64)
    attn = lambda q, k, v: t_flash.flash_attention(q, k, v, causal=causal)
    t_flash.reset_launch_counts()
    with torch.no_grad():
        o = vmap(attn)(q, k, v)
    assert dict(t_flash.LAUNCHES) == {"flash_fwd": 1, "flash_bwd_dq": 0,
                                      "flash_bwd_dkv": 0,
                                      "flash_bwd_fused": 0}
    loss = lambda q, k, v, w: (attn(q, k, v).float() * w.float()).sum()
    t_flash.reset_launch_counts()
    grads = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    torch.cuda.synchronize()
    assert dict(t_flash.LAUNCHES) == {
        "flash_fwd": 1, "flash_bwd_dq": 0 if fused else 1,
        "flash_bwd_dkv": 0 if fused else 1,
        "flash_bwd_fused": 1 if fused else 0}
    for i in range(n):
        f32 = [t[i].float().requires_grad_() for t in (q, k, v)]
        o_ref, _ = t_flash.plain_forward(*f32, causal)
        refs = torch.autograd.grad((o_ref * w[i].float()).sum(), f32)
        assert _rel(o[i], o_ref) <= REL_TOL
        for got, ref in zip(grads, refs):
            assert got.dtype == torch.bfloat16
            assert _rel(got[i], ref) <= REL_TOL


def _tiny_cnn_run(cuda, **kw):
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        config as t_config,
        driver as t_driver,
    )
    cfg = t_config.Config(model="enhanced_cnn", model_width=8,
                          dataset="cifar10", batch_size=16, epochs_global=2,
                          epochs_local=1, limit_train_samples=160,
                          limit_eval_samples=32, probe_batches=1, **kw)
    return t_driver.train_global(cfg, progress=False)


def test_memory_rows_on_card(cuda):
    """On the card every registered program has its row: the train step
    updates the parameters, BatchNorm statistics and Adam moments in
    place (alias bytes) and needs activations beyond them (temp bytes)."""
    res = _tiny_cnn_run(cuda)
    m = res["memory"]
    assert m["available"] is True and m["programs_unavailable"] == []
    assert set(m["programs"]) == {"train_step", "eval_step", "sync"}
    step = m["programs"]["train_step"][0]
    params = sum(p.numel() * 4 for p in res["model"].parameters())
    assert step["alias_bytes"] >= 3 * params    # params, mu, nu in place
    assert step["temp_bytes"] > 0 and step["argument_bytes"] > 0
    assert m["temp_bytes_total"] == sum(
        r["temp_bytes"] for rows in m["programs"].values() for r in rows)


def test_process_peak_survives_the_probe(cuda):
    """A peak reached before a tracked program's first call stays in the
    process peak the rounds report, though measuring the program reset
    the card's own peak statistic."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        probe,
    )
    gc.collect()                     # no garbage freed under the check
    probe.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    big = torch.empty(1 << 30, dtype=torch.uint8, device=cuda)
    del big
    tp = probe.TrackedProgram("p", lambda a: a * 2)
    tp(torch.ones(1024, device=cuda))
    assert torch.cuda.max_memory_allocated(cuda) < base + (1 << 30)
    assert probe.max_memory_allocated(cuda) >= base + (1 << 30)
    probe.reset_peak_memory_stats(cuda)
    assert probe.max_memory_allocated(cuda) < base + (1 << 30)


def test_planted_implicit_sync_trips_the_guard(cuda, monkeypatch):
    """--sanitize: a clean round passes the guard; an ``.item()`` planted
    in the train step is counted and raised."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        driver as t_driver,
        train as t_train,
    )
    res = _tiny_cnn_run(cuda, sanitize=True)
    assert res["sanitize"]["enabled"] is True
    assert res["sanitize"]["transfer_guard_violations"] == 0
    guards = []
    real_guard = t_driver._round_guard

    def spy(san, device):
        guards.append(san)
        return real_guard(san, device)

    real_step = t_train.LocalSGDEngine._train_step

    def planted(self, *args):
        out = real_step(self, *args)
        out[0].item()
        return out

    monkeypatch.setattr(t_driver, "_round_guard", spy)
    monkeypatch.setattr(t_train.LocalSGDEngine, "_train_step", planted)
    with pytest.raises(RuntimeError, match="synchronizing CUDA"):
        _tiny_cnn_run(cuda, sanitize=True)
    assert guards[0]["transfer_guard_violations"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0


def test_tp_gpt_with_flash_on_card_matches_dense_twin(cuda, tmp_path):
    """Tensor parallelism on the card: 2 gloo ranks on cuda:0 run
    gpt_small (4 heads of 32, 4 layers) with --attention_impl flash, each
    on its 2 heads, fp32 compute; the stitched logits (atol 1e-4) and the
    joined gradients (atol 2e-4, JAX's TP gate) equal the dense twin's in
    the same rank on the same card, and every rank launched the flash
    forward and the two-pass backward once per layer."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        grid_harness,
        mesh,
    )
    rng = np.random.default_rng(0)
    vocab = 1000
    model = get_model("gpt_small", num_classes=vocab)
    model.init_parameters(torch.Generator().manual_seed(0))
    job = dict(model="gpt_small", vocab=vocab,
               kw={"attention_impl": "flash"},
               state_dict={k: v.numpy() for k, v in
                           model.state_dict().items()},
               x=rng.integers(0, vocab, (4, 128)),
               y=rng.integers(0, vocab, (4, 128)),
               m=np.ones(4, np.float32))
    torch.save({"axes": {"data": 1, "model": 2}, "jobs": [job]},
               tmp_path / "jobs.pt")
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            grid_harness.module_worker, 2,
            (store, str(tmp_path / "jobs.pt"), str(tmp_path), "cuda"),
            ranks=range(2)), timeout_s=300.0)
    finally:
        mesh.remove_store(store)
    ranks = [torch.load(tmp_path / f"rank{r}-0.pt", weights_only=False)
             for r in range(2)]
    logits = np.concatenate([r["logits"] for r in ranks], axis=-1)
    np.testing.assert_allclose(logits, ranks[0]["dense_logits"], atol=1e-4)
    for key, g in ranks[0]["grads"].items():
        np.testing.assert_allclose(g, ranks[0]["dense_grads"][key],
                                   atol=2e-4, err_msg=key)
    for r in ranks:
        assert r["launches"]["flash_fwd"] == 4
        assert r["launches"]["flash_bwd_dq"] == 4
        assert r["launches"]["flash_bwd_dkv"] == 4


def test_tp_run_on_card_passes_the_sanitizer(cuda, tmp_path):
    """--sanitize under tensor parallelism: every per-layer all-reduce
    stages through pinned host memory behind an explicit event fence
    (``comms._to_host``), which the sync-debug guard does not count; a
    short gpt_small run at data=1,model=2 counts no implicit sync."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        main as t_main,
    )
    res = t_main.run(["--model", "gpt_small", "--dataset", "synthetic_lm",
                      "--attention_impl", "flash", "--mesh_shape",
                      "data=1,model=2", "--epochs_global", "1",
                      "--epochs_local", "1", "--batch_size", "8",
                      "--limit_train_samples", "64",
                      "--limit_eval_samples", "16", "--sanitize",
                      "--out_dir", str(tmp_path)])
    assert res["sanitize"]["transfer_guard_violations"] == 0
    assert np.isfinite(res["global_train_losses"]).all()


def test_hier_sync_on_card_is_bitwise_its_dense_twin(cuda, tmp_path):
    """The hierarchical sync on CUDA tensors: 4 gloo ranks on cuda:0 as 2
    slices x 2 workers, uneven leaves in 1 KiB buckets.  fp32 equals the
    dense twin ``aggregate_hier`` bit for bit on every rank (ring and
    double ring, equal and weighted); the int8 inner and outer wires with
    both levels' error feedback land within one quantum of each wire
    stage (``sync_harness.hier_bounds``); the bytes handed to gloo per
    level equal ``hier_wire_bytes`` (the double ring's shift-2 hop over 2
    slices is the slice's own payload, taken locally)."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        comms,
        mesh,
        sync_harness,
    )
    shapes = [(13, 7), (257,), (31, 5), (3,)]
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=(4, *s)).astype(np.float32) for s in shapes]
    np.savez(tmp_path / "in.npz",
             **{f"leaf{j}": a for j, a in enumerate(leaves)})
    cases = []
    for topology in ("ring", "double_ring"):
        for how in ("equal", "weighted"):
            cases.append(dict(mode="hier", slices=2, how=how,
                              topology=topology, local_weight=0.3,
                              bucket_bytes=1024, twin=True))
            cases.append(dict(mode="hier", slices=2, how=how,
                              topology=topology, local_weight=0.3,
                              bucket_bytes=1024, wire="int8",
                              outer_wire="int8", ef=True))
    store = mesh.new_store_path()
    try:
        mesh.join_workers(mesh.spawn_workers(
            sync_harness.engines_worker, 4,
            (store, "cuda", str(tmp_path / "in.npz"), cases, str(tmp_path),
             120.0), ranks=range(4)), timeout_s=300.0)
    finally:
        mesh.remove_store(store)
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for c in range(0, len(cases), 2):
        case = cases[c]
        for j in range(len(shapes)):
            for o in outs:
                assert np.array_equal(o[f"{c}/first{j}"], o[f"{c}/twin{j}"])
        bounds = sync_harness.hier_bounds(
            leaves, 2, topology=case["topology"], how=case["how"],
            wire="int8", outer_wire="int8", bucket_bytes=1024,
            local_weight=0.3)
        for j, b in enumerate(bounds):
            fp32 = np.stack([o[f"{c}/first{j}"] for o in outs])
            got = np.stack([o[f"{c + 1}/first{j}"] for o in outs])
            assert (np.abs(got.astype(np.float64) - fp32) <= b).all()
        for k, wire in ((c, torch.float32), (c + 1, torch.int8)):
            want = comms.hier_wire_bytes(
                [(s, torch.float32) for s in shapes], 2,
                topology=case["topology"], wire_dtype=wire,
                outer_wire_dtype=wire, bucket_bytes=1024)
            hops = 2 if case["topology"] == "double_ring" else 1
            for o in outs:
                assert int(o[f"{k}/wire_ici"]) == want["ici"]
                assert int(o[f"{k}/wire_dcn"]) == want["dcn"] // hops


def test_hier_run_on_card_passes_the_sanitizer(cuda, tmp_path):
    """--sanitize under the hierarchical sync: a short cnn run at 2 slices
    x 2 workers with the int8 outer wire and error feedback stages every
    collective (the int8 scales too) through pinned host memory, so the
    sync-debug guard counts no implicit sync; the workers of each slice
    end bitwise equal."""
    from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
        main as t_main,
    )
    res = t_main.run(["--model", "enhanced_cnn", "--model_width", "8",
                      "--dataset", "cifar10", "--num_slices", "2",
                      "--num_workers", "2", "--topology", "ring",
                      "--aggregation_by", "weights", "--sync_dtype_outer",
                      "int8", "--sync_compression", "ef",
                      "--epochs_global", "2", "--epochs_local", "1",
                      "--batch_size", "16", "--limit_train_samples", "256",
                      "--limit_eval_samples", "32", "--sanitize",
                      "--out_dir", str(tmp_path)])
    assert res["sanitize"]["transfer_guard_violations"] == 0
    assert res["sync_engine"]["mode"] == "hier"
    assert np.isfinite(res["global_train_losses"]).all()
    sums = res["param_checksums"]
    assert sums[0] == sums[1] and sums[2] == sums[3]
