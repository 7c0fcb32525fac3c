"""``utils/flops.py`` of the port on the CPU: the FLOP count of a step
against the analytic 2*M*N*K count and against the JAX package's count of
the same flax mlp (XLA's cost model), the dense-twin count on the meta
device, and the peaks, which are unknown off a CUDA card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.utils import (
    flops as j_flops,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    driver as t_driver,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.config import (
    config_from_args,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model as t_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.utils import (
    flops,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

B, HIDDEN, CLASSES, PIXELS = 32, 256, 10, 28 * 28
# the mlp step: forward 2*B*K*N per layer, backward the weight gradient
# of every layer and the input gradient of all but the first
MLP_STEP_FLOPS = (2 * B * PIXELS * HIDDEN * 2
                  + 2 * B * HIDDEN * CLASSES * 3)
# XLA's cost model also counts the elementwise work (bias adds, ReLU,
# softmax): 26,233,494 against the matmuls' 26,181,632 at this size
# (1.98e-3 more, measured on the CPU); the limit leaves room for XLA's
# version, not for a missing matmul (a layer's backward is >= 1.9 %)
JAX_RTOL = 5e-3


def _mlp_step(model):
    params = list(model.parameters())
    x = torch.zeros(B, 28, 28, 1)
    y = torch.zeros(B, dtype=torch.long)
    return lambda: torch.autograd.grad(F.cross_entropy(model(x), y), params)


def test_mlp_step_count_is_the_analytic_count():
    model = t_get_model("mlp", num_classes=CLASSES, input_shape=(28, 28, 1))
    assert flops.compiled_flops(_mlp_step(model)) == MLP_STEP_FLOPS


def test_matmul_count_is_2mnk():
    a, b = torch.zeros(64, 96), torch.zeros(96, 48)
    assert flops.compiled_flops(torch.matmul, a, b) == 2 * 64 * 96 * 48
    assert flops.compiled_flops(torch.relu, a) is None   # no matmul


def test_count_agrees_with_the_jax_package():
    model = j_get_model("mlp", num_classes=CLASSES)
    x = np.zeros((B, 28, 28, 1), np.float32)
    y = np.zeros(B, np.int32)
    params = model.init(jax.random.key(0), x)["params"]

    def loss(p, x, y):
        logits = model.apply({"params": p}, x)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                             y[:, None], 1))

    want = j_flops.compiled_flops(jax.jit(jax.grad(loss)), params, x, y)
    got = flops.compiled_flops(_mlp_step(
        t_get_model("mlp", num_classes=CLASSES, input_shape=(28, 28, 1))))
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)


@pytest.mark.parametrize("argv,example,dtype", [
    (["--model", "enhanced_cnn", "--model_width", "8"], (32, 32, 3),
     torch.float32),
    (["--model", "gpt_tiny", "--attention_impl", "flash"], (16,),
     torch.long),
], ids=["cnn", "gpt"])
def test_dense_twin_on_meta_counts_what_the_cpu_counts(argv, example,
                                                       dtype):
    """The train-step count of a model's dense twin on the meta device
    (what the card's MFU uses; no card time) equals the count of the same
    step run on CPU tensors."""
    cfg = dataclasses.replace(config_from_args(["--device", "cpu", *argv]),
                              attention_impl="dense")
    counts = []
    for dev in ("meta", "cpu"):
        model = t_driver.build_model_for(cfg, 10, torch.device(dev),
                                         example)
        x = torch.zeros((4, *example), dtype=dtype, device=dev)
        counts.append(flops.train_step_flops(model, x))
    assert counts[0] == counts[1] and counts[0] > 0


def test_peaks_and_mfu_off_the_card(monkeypatch):
    assert flops.peak_flops(torch.device("cpu")) is None
    assert flops.hbm_bytes_per_sec(torch.device("cpu")) is None
    assert flops.mfu(1e12, 1.0, torch.device("cpu")) is None
    # the data-sheet table, keyed by the card's reported name
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda", 0)
    assert flops.peak_flops(cuda) == 989e12
    assert flops.hbm_bytes_per_sec(cuda) == 3.35e12
    assert flops.mfu(989e12 / 2, 1.0, cuda) == pytest.approx(0.5)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 PCIe")
    assert flops.peak_flops(cuda) == 756e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert flops.peak_flops(cuda) is None
