"""Tile rasterizer with fused attribute resolve: the CUDA kernel
(csrc/raster.cu) and its plain PyTorch version.

Port of basicrenderer_tpu/ops/raster_pallas.py::_raster_kernel in its plain
mode (its reference twins are ops/raster_ref.py::raster_tiles_ref and
ops/resolve_pallas.py::resolve_attributes_ref). Per tile, walk the tile's
binned pair rows and then the global big-triangle list, evaluate the
barycentric edge planes and the depth plane at pixel centres, keep the
closest (reverse-Z max) depth + triangle id per pixel, and write the
perspective attribute planes of the winner.

`raster_tiles` picks the implementation by the device of the pairs: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version.

Plane evaluation is the one numerical contract both share with the JAX
reference: every plane is fma(a, px, b*py) + c, each step rounded to f32
(see `plane_eval`). Any other form changes which pixels sit exactly on an
edge, and exact `vis` parity is lost.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..graph.framedata import FrameConfig
from ..utils import cuda_build
from .raster_setup import SETUP_LANES, BinnedPairs

# Channels: [octu/w, octv/w, u/w, v/w, mat_id, tangent, unused, accum];
# the plain mode writes 0-4 and leaves 5-7 zero.
NUM_CHANNELS = 8
_ATTR_CHANNELS = 5
_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raster.cu"


def plane_eval(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """a*px + b*py + c as fma(a, px, round(b*py)) + c.

    XLA's CPU backend contracts the JAX reference's planes into exactly this
    form, and the CUDA kernel spells it with __fmaf_rn. PyTorch has no f32
    fused multiply-add, so the fma is emulated in f64: a*px is exact there,
    and the sum is rounded back to f32 before c is added in f32."""
    return (a.double() * px.double() + (b * py).double()).float() + c


def _check_modes(config: FrameConfig, init, peel, accum: bool) -> None:
    if init is not None:
        raise NotImplementedError(
            "seeded raster (two-phase occlusion replay) is not ported yet "
            "(FrameConfig.enable_occlusion)")
    if peel is not None:
        raise NotImplementedError(
            "peeled raster (OIT / alpha-mask peels) is not ported yet "
            "(FrameConfig.enable_oit, FrameConfig.enable_alpha_mask)")
    if accum:
        raise NotImplementedError(
            "accumulating raster (OIT beyond-K tail) is not ported yet "
            "(FrameConfig.enable_oit)")
    if config.enable_vertex_tangents:
        raise NotImplementedError(
            "the tangent channel is not ported yet "
            "(FrameConfig.enable_vertex_tangents)")


def raster_tiles(pairs: BinnedPairs, config: FrameConfig, tile_row0: int = 0,
                 init=None, peel=None, accum: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused raster + attribute resolve on the padded tile grid.

    Returns (depth (H', W') f32, vis (H', W') i32,
             channels (NUM_CHANNELS, H', W') f32). `tile_row0` offsets the
    tile grid vertically in global screen space (edge planes are in global
    pixels). The seeded, peeled, accum and tangent modes of the TPU kernel
    raise NotImplementedError."""
    _check_modes(config, init, peel, accum)
    dev = pairs.pair_data.device
    if dev.type == "cuda":
        return raster_tiles_cuda(pairs, config, tile_row0)
    if dev.type == "cpu":
        return raster_tiles_plain(pairs, config, tile_row0)
    raise ValueError(f"no raster for device {dev}")


def _to_image(t: torch.Tensor, config: FrameConfig) -> torch.Tensor:
    """(..., tiles, th, tw) -> (..., H', W')."""
    th, tw = config.tile_h, config.tile_w
    lead = t.shape[:-3]
    t = t.reshape(*lead, config.tiles_y, config.tiles_x, th, tw)
    t = t.transpose(-3, -2)
    return t.reshape(*lead, config.tiles_y * th, config.tiles_x * tw)


def raster_tiles_plain(pairs: BinnedPairs, config: FrameConfig,
                       tile_row0: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, vectorised across tiles: step s
    gathers row start_t + s of every tile t at once (masked past each
    tile's count), then every tile walks the big-triangle list with the
    kernel's bbox test. Reads the longest tile's row count and the big
    count on the host."""
    th, tw = config.tile_h, config.tile_w
    tiles_x = config.tiles_x
    N = config.num_tiles
    pair_data = pairs.pair_data
    dev = pair_data.device
    f32 = torch.float32
    n_rows = pair_data.shape[0]

    t = torch.arange(N, device=dev)
    ty = t // tiles_x + tile_row0
    tx = t % tiles_x
    # Pixel centres, broadcast (N, 1, tw) and (N, th, 1).
    px = (torch.arange(tw, device=dev, dtype=f32)[None, None, :]
          + (tx * tw).to(f32)[:, None, None] + 0.5)
    py = (torch.arange(th, device=dev, dtype=f32)[None, :, None]
          + (ty * th).to(f32)[:, None, None] + 0.5)
    txf, tyf = tx.to(f32), ty.to(f32)

    depth = torch.zeros((N, th, tw), dtype=f32, device=dev)
    vis = torch.zeros((N, th, tw), dtype=torch.int32, device=dev)
    chans = torch.zeros((_ATTR_CHANNELS, N, th, tw), dtype=f32, device=dev)

    def row_step(rows: torch.Tensor, live: torch.Tensor) -> None:
        d = rows[:, :, None, None]                       # (N, 32, 1, 1)
        e0 = plane_eval(d[:, 0], d[:, 1], d[:, 2], px, py)
        e1 = plane_eval(d[:, 3], d[:, 4], d[:, 5], px, py)
        e2 = (1.0 - e0) - e1
        z = plane_eval(d[:, 6], d[:, 7], d[:, 8], px, py)
        tri_id_f = d[:, 9]
        ok = live[:, None, None] & (tri_id_f > 0.5)
        passd = ok & (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z > depth)
        depth.copy_(torch.where(passd, z, depth))
        vis.copy_(torch.where(passd, tri_id_f.to(torch.int32), vis))
        for ch in range(4):
            val = plane_eval(d[:, 15 + ch * 3], d[:, 16 + ch * 3],
                             d[:, 17 + ch * 3], px, py)
            chans[ch] = torch.where(passd, val, chans[ch])
        chans[4] = torch.where(passd, d[:, 10], chans[4])

    offs = pairs.tile_offsets.long().clamp(max=n_rows)
    starts, counts = offs[:-1], offs[1:] - offs[:-1]
    for s in range(int(counts.max()) if N else 0):
        idx = torch.clamp(starts + s, max=n_rows - 1)
        row_step(pair_data[idx], s < counts)
    for j in range(min(int(pairs.big_count), n_rows)):
        row = pair_data[j]
        hit = ((txf >= row[11]) & (txf <= row[12])
               & (tyf >= row[13]) & (tyf <= row[14]))
        row_step(row.expand(N, SETUP_LANES), hit)

    channels = torch.cat([chans, torch.zeros(
        (NUM_CHANNELS - _ATTR_CHANNELS, N, th, tw), dtype=f32, device=dev)])
    return (_to_image(depth, config), _to_image(vis, config),
            _to_image(channels, config))


_raster_fn = None


def _kernel_fn():
    """The built library's entry point with its ctypes signature."""
    global _raster_fn
    if _raster_fn is None:
        fn = cuda_build.load(_SOURCE).lib.br_raster_tiles
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _raster_fn = fn
    return _raster_fn


def build_kernel() -> cuda_build.CudaLibrary:
    """Build (if needed) and load the kernel library; returns it."""
    _kernel_fn()
    return cuda_build.load(_SOURCE)


def raster_tiles_cuda(pairs: BinnedPairs, config: FrameConfig,
                      tile_row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    `raster_tiles_cuda.launches` counts the launches."""
    pd, offs, big = pairs.pair_data, pairs.tile_offsets, pairs.big_count
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_cuda needs CUDA tensors, got {dev}")
    if pd.dtype != torch.float32 or pd.dim() != 2 or pd.shape[1] != SETUP_LANES:
        raise ValueError(f"pair_data must be (R, {SETUP_LANES}) f32, got "
                         f"{tuple(pd.shape)} {pd.dtype}")
    if offs.dtype != torch.int32 or offs.shape != (config.num_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({config.num_tiles + 1},) "
                         f"i32, got {tuple(offs.shape)} {offs.dtype}")
    if big.dtype != torch.int32 or big.numel() != 1:
        raise ValueError(f"big_count must be one i32, got {big.dtype}")
    for name, x in (("pair_data", pd), ("tile_offsets", offs),
                    ("big_count", big)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, pair_data on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Hp, Wp = config.padded_height, config.padded_width
    depth = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    vis = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(offs.data_ptr(), big.data_ptr(), pd.data_ptr(), pd.shape[0],
                 depth.data_ptr(), vis.data_ptr(), channels.data_ptr(),
                 config.tiles_x, config.tiles_y, config.tile_h, config.tile_w,
                 int(tile_row0), stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    raster_tiles_cuda.launches += 1
    return depth, vis, channels


raster_tiles_cuda.launches = 0
