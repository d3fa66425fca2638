"""Tile-granular history reprojection for TAA: the CUDA kernel
(csrc/taa_warp.cu) and its plain PyTorch version.

Port of basicrenderer_tpu/ops/taa_warp.py (the Pallas `_warp_kernel`,
its wrapper `warp_history_tiles` and its twin `warp_history_ref`). Motion
from the camera and from rigid objects is piecewise smooth, so history is
warped with one fractional (dy, dx) per raster tile: every pixel of the
tile takes the bilinear sample of the edge-extended history at its own
position plus the tile's motion. Pixels whose own motion disagrees with
their tile's reject history in ops/post.taa_resolve_mv.

The shifts are clipped to the TPU kernel's pad (PAD_Y - 2 rows, PAD_XL - 2
columns), so both packages warp by the same amounts; the edge pad itself
is a clamp of the source coordinates here.

`warp_history` picks the implementation by the device of its inputs: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import cuda_build

PAD_Y = 72          # top pad rows of the TPU kernel (max |dy| = PAD_Y - 2)
PAD_YB = 88         # its bottom pad rows
PAD_XL = 192        # its left pad columns (max |dx| = PAD_XL - 2)
PAD_XR = 320        # its right pad columns
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "taa_warp.cu"


def _check_inputs(history: torch.Tensor, tile_dy: torch.Tensor,
                  tile_dx: torch.Tensor, tile_h: int, tile_w: int) -> None:
    if history.dtype != torch.float32 or history.dim() != 3:
        raise ValueError(f"history must be (H, W, C) f32, got "
                         f"{tuple(history.shape)} {history.dtype}")
    H, W, _C = history.shape
    if tile_h <= 0 or tile_w <= 0 or H % tile_h or W % tile_w:
        raise ValueError(f"history {H}x{W} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")
    T = (H // tile_h) * (W // tile_w)
    for name, x in (("tile_dy", tile_dy), ("tile_dx", tile_dx)):
        if x.dtype != torch.float32 or tuple(x.shape) != (T,):
            raise ValueError(f"{name} must be ({T},) f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != history.device:
            raise ValueError(f"{name} is on {x.device}, history on "
                             f"{history.device}")


def _clipped(tile_dy: torch.Tensor, tile_dx: torch.Tensor):
    return (torch.clamp(tile_dy, -(PAD_Y - 2.0), PAD_Y - 2.0),
            torch.clamp(tile_dx, -(PAD_XL - 2.0), PAD_XL - 2.0))


def warp_history(history: torch.Tensor, tile_dy: torch.Tensor,
                 tile_dx: torch.Tensor, tile_h: int, tile_w: int
                 ) -> torch.Tensor:
    """history (H, W, C) + per-tile fractional motion (T,) each, in
    row-major tile order -> warped history (H, W, C). H and W must be tile
    multiples (callers pass the padded frame). Each implementation checks
    its inputs."""
    dev = history.device
    if dev.type == "cuda":
        return warp_history_tiles(history, tile_dy, tile_dx, tile_h, tile_w)
    if dev.type == "cpu":
        return warp_history_plain(history, tile_dy, tile_dx, tile_h, tile_w)
    raise ValueError(f"no history warp for device {dev}")


def warp_history_plain(history: torch.Tensor, tile_dy: torch.Tensor,
                       tile_dx: torch.Tensor, tile_h: int, tile_w: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    warp_history_ref): every pixel's four clamped taps gathered at once,
    blended in the kernel's order of f32 operations."""
    _check_inputs(history, tile_dy, tile_dx, tile_h, tile_w)
    H, W, C = history.shape
    ty, tx = H // tile_h, W // tile_w
    dev = history.device
    dy, dx = _clipped(tile_dy, tile_dx)
    y0, x0 = torch.floor(dy), torch.floor(dx)
    fy, fx = dy - y0, dx - x0

    def per_pixel(v):
        return v.view(ty, tx).repeat_interleave(tile_h, 0) \
            .repeat_interleave(tile_w, 1)

    y0p = per_pixel(y0).to(torch.int64)
    x0p = per_pixel(x0).to(torch.int64)
    fyp = per_pixel(fy)[..., None]
    fxp = per_pixel(fx)[..., None]
    yy = torch.arange(H, device=dev, dtype=torch.int64)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    r0 = torch.clamp(yy + y0p, 0, H - 1)
    r1 = torch.clamp(yy + y0p + 1, 0, H - 1)
    c0 = torch.clamp(xx + x0p, 0, W - 1)
    c1 = torch.clamp(xx + x0p + 1, 0, W - 1)
    flat = history.reshape(H * W, C)

    def tap(r, c):
        return flat[(r * W + c).reshape(-1)].reshape(H, W, C)

    gy, gx = 1.0 - fyp, 1.0 - fxp
    top = tap(r0, c0) * gy + tap(r1, c0) * fyp
    bot = tap(r0, c1) * gy + tap(r1, c1) * fyp
    return top * gx + bot * fxp


_fns = {}


def _kernel_fn(name: str = "br_taa_warp"):
    """An entry point of the built library with its ctypes signature."""
    if name not in _fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, p, p, i, i, i, i, i, p]
                       if name == "br_taa_warp" else [i, i, i])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def blocks_per_sm(channels: int, tile_h: int, tile_w: int) -> int:
    """Resident blocks an SM of the kernel on (tile_h, tile_w) tiles of a
    `channels`-channel history."""
    return _kernel_fn("br_taa_warp_blocks_per_sm")(channels, tile_h, tile_w)


def warp_history_tiles(history: torch.Tensor, tile_dy: torch.Tensor,
                       tile_dx: torch.Tensor, tile_h: int, tile_w: int
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    `warp_history_tiles.launches` counts the launches."""
    _check_inputs(history, tile_dy, tile_dx, tile_h, tile_w)
    dev = history.device
    if dev.type != "cuda":
        raise ValueError(f"warp_history_tiles needs CUDA tensors, got {dev}")
    for name, x in (("history", history), ("tile_dy", tile_dy),
                    ("tile_dx", tile_dx)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    H, W, C = history.shape
    out = torch.empty_like(history)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(history.data_ptr(), tile_dy.data_ptr(), tile_dx.data_ptr(),
                 out.data_ptr(), H, W, C, tile_h, tile_w, stream)
    if err != 0:
        raise RuntimeError(f"history warp kernel launch failed: CUDA error {err}")
    warp_history_tiles.launches += 1
    return out


warp_history_tiles.launches = 0
