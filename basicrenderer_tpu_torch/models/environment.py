"""Environment (image-based lighting) precompute and caching.

Port of basicrenderer_tpu/models/environment.py for cubemap inputs (the
Radiance .hdr equirect loader waits for the HDR decoder). An environment
is its 9 SH radiance coefficients and its GGX-prefiltered radiance mips,
every mip resampled to SPEC_RES so that the runtime mip pick is a lerp.
Results are cached as .npz under basicrenderer_tpu_torch/_build/env/
(gitignored), keyed on the input's bytes.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..ops import ibl

CACHE_DIR = Path(__file__).resolve().parents[1] / "_build" / "env"
SPEC_RES = 64   # all prefiltered mips resampled to this (mip = lerp index)
SPEC_MIPS = 5


def _linear_weights(n_in: int, n_out: int, dev) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize(..., "linear") along one
    axis: half-pixel centres, the triangle kernel widened by n_in / n_out
    when downsampling (antialiasing), columns normalised to sum 1, and
    output samples outside the input dropped."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=dev)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """x resized to `shape` as jax.image.resize(x, shape, "linear") does:
    each axis whose size changes is contracted with its weight matrix."""
    for dim, n_out in enumerate(shape):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out, x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([dim], [0])), -1, dim)
    return x


class Environment:
    """`sh` (9, 3) and `spec_mips` (SPEC_MIPS, 6, SPEC_RES, SPEC_RES, 3), f32
    numpy arrays; build_scene_buffers takes them as env_sh and
    env_specular."""

    def __init__(self, sh: np.ndarray, spec_mips: np.ndarray, name: str = ""):
        self.sh = sh
        self.spec_mips = spec_mips
        self.name = name

    @staticmethod
    def precompute(cubemap: np.ndarray, name: str = "",
                   use_cache: bool = True, device="cuda") -> "Environment":
        """SH projection and GGX prefilter of a (6, R, R, 3) radiance
        cubemap, computed on `device` (the card unless the caller names
        another device). An equirect (H, W, 3) input raises: its loader is
        not ported yet."""
        arr = np.asarray(cubemap, np.float32)
        if arr.ndim != 4 or arr.shape[0] != 6 or arr.shape[3] != 3:
            raise NotImplementedError(
                "Environment.precompute takes a (6, R, R, 3) cubemap; the "
                "equirect path (equirect_to_cubemap) is not ported yet")
        path = None
        if use_cache:
            key = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
            path = CACHE_DIR / f"{key}.npz"
            if path.exists():
                z = np.load(path)
                return Environment(z["sh"], z["spec"], name)
        cube = torch.tensor(arr, device=device)
        sh = ibl.project_sh(cube).cpu().numpy()
        mips = ibl.prefilter_specular(cube, mips=SPEC_MIPS)
        spec = np.stack([
            resize_linear(m, (6, SPEC_RES, SPEC_RES, 3)).cpu().numpy()
            for m in mips])
        if path is not None:
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
            np.savez(tmp, sh=sh, spec=spec)
            os.replace(tmp, path)
        return Environment(sh.astype(np.float32), spec.astype(np.float32),
                           name)

    @staticmethod
    def procedural(intensity: float = 1.0, sun_dir=(-0.45, -1.0, -0.3),
                   res: int = 128, use_cache: bool = True,
                   device="cuda") -> "Environment":
        """The procedural sky with a sun disk (ops/ibl.py), precomputed."""
        cube = ibl.make_procedural_environment(res, intensity, sun_dir,
                                               device=device)
        return Environment.precompute(cube.cpu().numpy(), name="procedural",
                                      use_cache=use_cache, device=device)
