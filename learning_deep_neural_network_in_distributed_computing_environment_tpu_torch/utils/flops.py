"""FLOP accounting and MFU (model FLOPs utilization) on the card (port of
the JAX package's ``utils/flops.py``).

Per-step FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one call: it counts the matmul-like ATen ops (matmuls, convolutions,
attention) at 2*M*N*K each, forward and backward, from their shapes, and
no elementwise work.  The port's flash-attention ops are
``autograd.Function``s over ctypes launches that the counter cannot see,
so a step's model FLOPs are counted on its dense formulation, as the JAX
package's benchmark counts them: the same model with
``attention_impl="dense"``, on the ``meta`` device, where the call only
propagates shapes and costs no card time.  MFU divides the achieved FLOP
rate by the card's peak bf16 rate.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense (no sparsity) bf16 tensor-core FLOP/s and HBM bytes/s per card,
# from NVIDIA's H100 data sheet, keyed by a substring of
# torch.cuda.get_device_name (lower case), most specific first: the SXM
# part reports as "NVIDIA H100 80GB HBM3".
_PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),
    ("h100 sxm", 989e12, 3.35e12),
)


def _peaks(device) -> Optional[tuple[float, float]]:
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
    return None


def peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card, or None off a known CUDA card
    (the CPU included)."""
    p = _peaks(device)
    return None if p is None else p[0]


def hbm_bytes_per_sec(device=None) -> Optional[float]:
    """HBM bandwidth of one card in bytes/s, or None off a known CUDA
    card."""
    p = _peaks(device)
    return None if p is None else p[1]


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` (the name is JAX's, whose count comes from the
    compiled executable).  None when the call counts no FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def train_step_flops(model: torch.nn.Module, x: torch.Tensor
                     ) -> Optional[float]:
    """Model FLOPs of one train step of ``model`` on the batch ``x``: the
    forward and the backward to every trainable parameter.  The loss is
    the logits' sum, whose backward runs the same matmuls as the
    cross-entropy's (the loss itself is elementwise work, not counted).
    Give it the dense twin of the trained model on the ``meta`` device
    (``driver.build_model_for`` with ``attention_impl="dense"`` and
    ``torch.device("meta")``)."""
    params = [p for p in model.parameters() if p.requires_grad]
    return compiled_flops(
        lambda: torch.autograd.grad(model(x).float().sum(), params))


def mfu(flops_per_step: Optional[float], step_time_s: float,
        device=None) -> Optional[float]:
    """Achieved fraction of peak: (FLOPs/step / step_time) / peak.  None
    when either the FLOPs or the card's peak is unknown."""
    peak = peak_flops(device)
    if not flops_per_step or not peak or step_time_s <= 0:
        return None
    return (flops_per_step / step_time_s) / peak
