"""Object-level frustum culling (port of basicrenderer_tpu/ops/culling.py's
`frustum_cull_spheres`; the HZB and two-phase occlusion come with the
cluster slice)."""

from __future__ import annotations

import torch

from ..utils import math3d


def frustum_cull_spheres(viewproj: torch.Tensor, centers: torch.Tensor,
                         radii: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) visibility mask for bounding spheres (world space)."""
    planes = math3d.frustum_planes(viewproj)
    return valid & math3d.sphere_in_frustum(planes, centers, radii)
