"""Shadow-pass helpers (port of part of basicrenderer_tpu/ops/shadows.py).

Only `downsample2d` is ported so far: the alpha-MASK pass and the texture
sampler read their reduced-rate planes through it. Shadow maps, cascades
and the VSM are later slices.
"""

from __future__ import annotations

import torch


def downsample2d(x: torch.Tensor, ds: int) -> torch.Tensor:
    """(H, W) -> (H//ds, W//ds) POINT sample: the top-left pixel of every
    ds x ds block (not an average), as the JAX package's reshape-index
    form computes it."""
    if ds == 1:
        return x
    h, w = x.shape
    return x[:h // ds * ds:ds, :w // ds * ds:ds]
