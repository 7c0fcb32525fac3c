"""The PyTorch port's flash attention against the JAX package's Pallas
kernels (run in interpret mode on the CPU, outside shard_map).

On CPU tensors the port's wrappers compute the plain fp32 versions of the
CUDA kernels, so these tests hold the plain versions (the kernels'
reference on the card, see chip_smoke.py) against the TPU kernels'
arithmetic.  Inputs are made with numpy from a seed and handed to both.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.ops import (
    pallas_ops,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.ops import (
    attention as t_attn,
    flash as t_flash,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, L, H, D = 1, 128, 4, 16
# forward: both sides compute in fp32, differing only in summation order
FWD_ATOL = 1e-5
# gradients: three chained products per element, fp32 rounding accumulates
GRAD_ATOL = 1e-4
CASES = [pytest.param(causal, kv, id=f"{'causal' if causal else 'full'}-"
                      f"{'mha' if kv == H else 'gqa2'}")
         for causal in (False, True) for kv in (H, H // 2)]


def _inputs(kv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, kv, D)).astype(np.float32)
    g = rng.normal(size=(B, L, H, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal,kv", CASES)
def test_forward_and_lse_match_pallas(causal, kv):
    q, k, v, _ = _inputs(kv)
    want = pallas_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    got = t_attn.attend(*map(torch.from_numpy, (q, k, v)), impl="flash",
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    _, lse_want = pallas_ops._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        with_lse=True)
    _, lse_got = t_flash.flash_forward(*map(torch.from_numpy, (q, k, v)),
                                       causal, with_lse=True)
    np.testing.assert_allclose(lse_got.numpy(), np.asarray(lse_want)[..., 0],
                               atol=FWD_ATOL)


@pytest.mark.parametrize("causal,kv", CASES)
def test_grads_match_pallas(causal, kv):
    q, k, v, g = _inputs(kv, seed=1)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: pallas_ops.flash_attention(q_, k_, v_,
                                                      causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_attn.attend(qt, kt, vt, impl="flash", causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)


def test_plain_path_launches_no_kernel_and_matches_dense():
    q, k, v, _ = _inputs(H // 2, seed=2)
    t_flash.reset_launch_counts()
    got = t_flash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True)
    want = t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                        causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_ATOL)
    assert all(n == 0 for n in t_flash.LAUNCHES.values())


def test_mask_runs_dense_path():
    q, k, v, _ = map(torch.from_numpy, _inputs(H, seed=3))
    mask = torch.from_numpy(np.random.default_rng(0).random((L, L)) > 0.3)
    mask |= torch.eye(L, dtype=torch.bool)
    np.testing.assert_allclose(
        t_flash.flash_attention(q, k, v, mask=mask).numpy(),
        t_attn.dot_product_attention(q, k, v, mask).numpy(), atol=0)


def test_kernel_shape_rules():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert t_flash._supported(q, k, k)
    assert not t_flash._supported(q[..., :16], k[..., :16], k[..., :16])
    assert not t_flash._supported(q.half(), k.half(), k.half())
    assert not t_flash._supported(q, k.float(), k)
    # no 128-multiple rule: the kernels mask ragged tails themselves
    assert t_flash._supported(q[:, :5], k[:, :5], k[:, :5])


def _shifted(shape, dtype, elements):
    """A contiguous tensor whose base lies ``elements`` past an aligned
    allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize("make,copied", [
    (lambda: torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16), False),
    (lambda: torch.zeros(2, 8, 3, 4, 64, dtype=torch.bfloat16)[:, :, 1],
     False),
    (lambda: torch.zeros(2, 8, 6, 32, dtype=torch.float32)[:, :, 4:], False),
    (lambda: _shifted((2, 8, 4, 64), torch.bfloat16, 8), False),
    (lambda: _shifted((2, 8, 4, 64), torch.bfloat16, 1), True),
    (lambda: _shifted((2, 8, 4, 32), torch.float32, 2), True),
    (lambda: torch.zeros(2, 8, 4, 68, dtype=torch.bfloat16)[..., :64], True),
    (lambda: torch.zeros(2, 9, 4, 64, dtype=torch.bfloat16)[:, 1:], False),
    (lambda: torch.zeros(2, 8, 64, 4, dtype=torch.bfloat16).transpose(2, 3),
     True),
], ids=["contiguous", "qkv-view", "gqa-kv-view-fp32", "base-16-bytes-on",
        "base-2-bytes-off", "base-8-bytes-off-fp32", "head-stride-136-bytes",
        "seq-slice", "head-dim-strided"])
def test_kernel_layout_copies_only_operands_it_cannot_read(make, copied):
    """The wrappers' layout rule (``_kernel_layout``): an operand goes to
    the kernel where it lies when its head_dim is contiguous and its base
    and batch/seq/head strides are 16-byte multiples (cp.async moves
    16-byte row chunks); otherwise it is copied to a fresh contiguous
    tensor with the same values."""
    t = make()
    t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape))
    (out,) = t_flash._kernel_layout(t)
    assert (out is not t) == copied
    assert t_flash._rows_aligned(out)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, t)
    if copied:
        assert out.is_contiguous()


def test_other_devices_raise():
    q = torch.empty(1, 8, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_flash.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("causal,kv", CASES)
def test_plain_fused_backward_matches_pallas_fused(monkeypatch, causal, kv):
    """``plain_bwd_fused`` against ``_flash_backward_fused`` with 128-row
    blocks at L=256: the Pallas kernel runs a 2x2 block grid, so its dq
    comes from multi-block partials (and, causal, a zeroed masked tile)."""
    monkeypatch.setattr(pallas_ops, "BQ", 128)
    monkeypatch.setattr(pallas_ops, "BK", 128)
    rng = np.random.default_rng(6)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, g = mk(B, 256, H, D), mk(B, 256, kv, D), mk(B, 256, kv, D), \
        mk(B, 256, H, D)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = pallas_ops._flash_forward(jq, jk, jv, causal, with_lse=True)
    want = pallas_ops._flash_backward_fused(jq, jk, jv, o, lse, jg, causal)
    o_np = np.asarray(o)
    delta = torch.from_numpy((g * o_np).sum(-1).transpose(0, 2, 1).copy())
    got = t_flash.plain_bwd_fused(
        *map(torch.from_numpy, (q, k, v, g)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()), delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("env,want", [({"FLASH_BWD": "fused"}, True),
                                      ({"FLASH_BWD": "twopass"}, False),
                                      ({}, False)],
                         ids=["fused", "other", "unset"])
def test_flash_bwd_switch_is_read_at_import(env, want):
    """A process that imports only the port sees the switch as the JAX
    package does (``pallas_ops.py:524``): on exactly for "fused"."""
    code = (f"import sys\n"
            f"from {t_flash.__name__} import _use_fused_bwd\n"
            f"assert not any(m.split('.')[0] == 'jax' for m in sys.modules)\n"
            f"print(_use_fused_bwd())\n")
    base = {k: v for k, v in os.environ.items()
            if k not in ("FLASH_BWD", "PYTHONSTARTUP")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**base, **env}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == str(want)


@pytest.mark.parametrize("causal,kv", CASES)
def test_fused_switch_on_cpu_gives_two_pass_grads(monkeypatch, causal, kv):
    """Under the switch the CPU autograd path runs the fused plain version:
    the two-pass grads, and no kernel launch."""
    q, k, v, g = map(torch.from_numpy, _inputs(kv, seed=7))
    grads = {}
    for fused in (False, True):
        monkeypatch.setattr(t_flash, "_FUSED_BWD", fused)
        t_flash.reset_launch_counts()
        qt, kt, vt = (a.clone().requires_grad_() for a in (q, k, v))
        out = t_attn.attend(qt, kt, vt, impl="flash", causal=causal)
        grads[fused] = torch.autograd.grad(out, (qt, kt, vt), g)
        assert all(n == 0 for n in t_flash.LAUNCHES.values())
    for name, a, b in zip(("dq", "dk", "dv"), grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=name)
