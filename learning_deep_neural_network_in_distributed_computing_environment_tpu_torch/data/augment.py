"""On-device image augmentation (port of the JAX package's
``data/augment.py:22-58``), applied to each train batch [B, H, W, C] inside
the train step, on the batch's device, with no host round trip.

In this order, per image:

1. horizontal flip with probability 0.5;
2. reflect-pad by ``pad`` and a random crop back to H x W (offsets in
   [0, 2 * pad]);
3. gain U(0.8, 1.2) and bias U(-0.2, 0.2): ``x * gain + bias``;
4. cutout: zero the square ``|y - cy| <= cutout_size // 2`` and
   ``|x - cx| <= cutout_size // 2`` (9 x 9 at the default 8), centre
   anywhere in the image.

``augment_batch`` draws these from an explicit ``torch.Generator`` on the
batch's device; ``apply_augment`` is a pure function of the batch and the
draws, so the tests feed it the draws the JAX package makes from its key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draw(b: int, h: int, w: int, generator: torch.Generator,
         device: torch.device, pad: int = 4) -> dict[str, torch.Tensor]:
    """The per-image random draws of one batch."""
    kw = dict(generator=generator, device=device)
    uniform = lambda lo, hi: torch.empty(b, device=device).uniform_(
        lo, hi, generator=generator)
    return dict(flip=torch.rand(b, **kw) < 0.5,
                oy=torch.randint(0, 2 * pad + 1, (b,), **kw),
                ox=torch.randint(0, 2 * pad + 1, (b,), **kw),
                gain=uniform(0.8, 1.2), bias=uniform(-0.2, 0.2),
                cy=torch.randint(0, h, (b,), **kw),
                cx=torch.randint(0, w, (b,), **kw))


def apply_augment(x: torch.Tensor, draws: dict[str, torch.Tensor], *,
                  pad: int = 4, cutout_size: int = 8) -> torch.Tensor:
    """Augment ``x`` [B, H, W, C] with the given draws: ``flip`` [B] bool,
    ``oy``/``ox``/``cy``/``cx`` [B] integer, ``gain``/``bias`` [B]."""
    b, h, w, _ = x.shape
    col = lambda t: t.reshape(b, 1, 1, 1)
    x = torch.where(col(draws["flip"]), x.flip(2), x)
    # F.pad reflects the last two dims: pad H and W of the NCHW view
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="reflect").permute(0, 2, 3, 1)
    rows = draws["oy"][:, None] + torch.arange(h, device=x.device)
    cols = draws["ox"][:, None] + torch.arange(w, device=x.device)
    x = xp[torch.arange(b, device=x.device)[:, None, None],
           rows[:, :, None], cols[:, None, :]]
    x = x * col(draws["gain"]) + col(draws["bias"])
    half = cutout_size // 2
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    inside = (((yy - draws["cy"][:, None, None]).abs() <= half)
              & ((xx - draws["cx"][:, None, None]).abs() <= half))
    return torch.where(inside[..., None], 0.0, x)


def augment_batch(x: torch.Tensor, generator: torch.Generator, *,
                  pad: int = 4, cutout_size: int = 8) -> torch.Tensor:
    """Augment ``x`` [B, H, W, C] with draws from ``generator`` (on the
    batch's device)."""
    b, h, w, _ = x.shape
    return apply_augment(x, draw(b, h, w, generator, x.device, pad),
                         pad=pad, cutout_size=cutout_size)
