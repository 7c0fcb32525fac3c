"""Card-only tests of the PyTorch port's CUDA kernels (marker ``cuda``).

The kernels have no CPU mode, so every test here skips without a CUDA
device.  The file imports nothing of JAX, so it also runs on a machine
without it, skipping the repository's JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

``chip_smoke.py`` runs the same comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

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
