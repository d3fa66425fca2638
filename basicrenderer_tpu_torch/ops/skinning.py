"""Linear-blend skinning.

Port of basicrenderer_tpu/ops/skinning.py (reference: compute skinning in
shaders/Include/skinningCommon.hlsli + the SkeletonManager's GPU
buffers). A prepass rewrites the scene's vertex positions and normals, so
every downstream path reads deformed geometry: the soup setup, and the
cluster setups, which with FrameConfig.enable_skinning set up from the
global vertex table instead of the (static) cluster pages
(ops/raster_setup.setup_from_compacted). The JAX package fetches the four
joint matrices by one-hot matmuls; here they are index gathers (exact).
"""

from __future__ import annotations

import dataclasses

import torch

from ..graph.framedata import SceneBuffers


def apply_skinning(scene: SceneBuffers, joint_palette: torch.Tensor,
                   vert_joints: torch.Tensor, vert_weights: torch.Tensor
                   ) -> SceneBuffers:
    """Returns a scene with skinned positions and normals.

    joint_palette: (Jcap, 16) f32 object-space skin matrices (world(joint)
    @ inverse_bind), already offset per instance by the bridge.
    vert_joints: (V, 4) i32 global palette indices; vert_weights: (V, 4)
    f32 (all-zero weights = an unskinned vertex, passed through)."""
    p = scene.positions
    n = scene.normals
    skinned = torch.sum(vert_weights, dim=1) > 1e-6
    # Blend the 4 joint matrices first (LBS): M = sum_k w_k * palette[j_k],
    # then transform once.
    m = torch.zeros((p.shape[0], 16), dtype=torch.float32, device=p.device)
    for k in range(4):
        m = m + joint_palette[vert_joints[:, k].long()] * vert_weights[:, k:k + 1]
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    sx = m[:, 0] * px + m[:, 1] * py + m[:, 2] * pz + m[:, 3]
    sy = m[:, 4] * px + m[:, 5] * py + m[:, 6] * pz + m[:, 7]
    sz = m[:, 8] * px + m[:, 9] * py + m[:, 10] * pz + m[:, 11]
    nx0, ny0, nz0 = n[:, 0], n[:, 1], n[:, 2]
    # Normals by the rotation part (uniform-scale assumption, like the
    # reference's skinning shader).
    nx = m[:, 0] * nx0 + m[:, 1] * ny0 + m[:, 2] * nz0
    ny = m[:, 4] * nx0 + m[:, 5] * ny0 + m[:, 6] * nz0
    nz = m[:, 8] * nx0 + m[:, 9] * ny0 + m[:, 10] * nz0
    nlen = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-12)
    sp = torch.where(skinned[:, None], torch.stack([sx, sy, sz], 1), p)
    sn = torch.where(skinned[:, None],
                     torch.stack([nx * nlen, ny * nlen, nz * nlen], 1), n)
    return dataclasses.replace(scene, positions=sp, normals=sn)
