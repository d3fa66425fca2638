"""Environment (image-based lighting) precompute and caching.

Port of basicrenderer_tpu/models/environment.py. The input is a (6, R, R,
3) radiance cubemap or an (H, W, 3) equirect panorama (resampled to a
cubemap first; `Environment.from_hdr` reads one from a Radiance .hdr
file). An environment is its 9 SH radiance coefficients and its GGX-prefiltered radiance mips,
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
    def precompute(equirect_or_cubemap: np.ndarray, name: str = "",
                   cubemap_res: int = 128, use_cache: bool = True,
                   device="cuda") -> "Environment":
        """SH projection and GGX prefilter of a (6, R, R, 3) radiance
        cubemap, or of an (H, W, 3) equirect resampled to a
        `cubemap_res` cubemap, computed on `device` (the card unless the
        caller names another device)."""
        arr = np.asarray(equirect_or_cubemap, np.float32)
        if arr.shape[-1] != 3 or arr.ndim not in (3, 4) \
                or (arr.ndim == 4 and arr.shape[0] != 6):
            raise ValueError(f"Environment.precompute takes an (H, W, 3) "
                             f"equirect or a (6, R, R, 3) cubemap, not "
                             f"{arr.shape}")
        path = None
        if use_cache:
            key = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
            path = CACHE_DIR / f"{key}.npz"
            if path.exists():
                z = np.load(path)
                return Environment(z["sh"], z["spec"], name)
        cube = torch.tensor(arr, device=device)
        if arr.ndim == 3:                      # equirect (H, W, 3)
            cube = ibl.equirect_to_cubemap(cube, cubemap_res)
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
    def from_hdr(path: str, cubemap_res: int = 128, use_cache: bool = True,
                 device="cuda") -> "Environment":
        """Load a Radiance .hdr equirect panorama and precompute it."""
        from .texprocess import load_hdr
        with open(path, "rb") as f:
            img = load_hdr(f.read())
        return Environment.precompute(img, name=os.path.basename(path),
                                      cubemap_res=cubemap_res,
                                      use_cache=use_cache, device=device)

    @staticmethod
    def procedural(intensity: float = 1.0, sun_dir=(-0.45, -1.0, -0.3),
                   res: int = 128, use_cache: bool = True,
                   device="cuda") -> "Environment":
        """The procedural sky with a sun disk (ops/ibl.py), precomputed."""
        cube = ibl.make_procedural_environment(res, intensity, sun_dir,
                                               device=device)
        return Environment.precompute(cube.cpu().numpy(), name="procedural",
                                      use_cache=use_cache, device=device)
