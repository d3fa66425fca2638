"""Visibility-buffer attribute resolve (K6): the CUDA kernel
(csrc/resolve.cu) and its plain PyTorch version.

Port of basicrenderer_tpu/ops/resolve_pallas.py: `_resolve_kernel`
through `resolve_attributes_pallas` (K6, per-triangle BinnedPairs), and
its twin `resolve_attributes_ref` (both pair kinds). Given a visibility
buffer, walk each tile's binned setup rows once more and, wherever a
row's triangle id equals the pixel's vis, write the row's perspective
attribute planes (channels 0-3) and material/object combo (channel 4),
and with FrameConfig.enable_vertex_tangents its flat tangent angle
(lane 27, channel 5); the last writer wins, the other channels stay
zero.

No frame path calls it: the rasters fuse this resolve (ops/raster.py),
as the JAX package's Pallas frame does. It stands as the port of K6 and
as a second opinion on K1's fused channels.

`resolve_attributes` picks the implementation by the device of the
pairs: CUDA tensors launch the kernel (or raise), CPU tensors run the
plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Union

import torch

from ..graph.framedata import FrameConfig
from ..utils import cuda_build
from .raster import (NUM_CHANNELS, ModeLaunches, _to_image, _to_tiles,
                     expand_group_pairs, plane_eval)
from .raster_setup import SETUP_LANES, BinnedPairs, GroupBinnedPairs

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "resolve.cu"
MAX_TILES = 12287   # csrc/resolve.cu kMaxTiles: 48 KB of staged offsets
# K6's launches in tangent mode (the wrapper's own `launches` counts all).
TANGENT_LAUNCHES = ModeLaunches("K6-tangent")


def resolve_attributes(pairs: Union[BinnedPairs, GroupBinnedPairs],
                       vis: torch.Tensor, config: FrameConfig,
                       tile_row0: int = 0) -> torch.Tensor:
    """vis (H', W') i32 padded visibility buffer -> channels
    (NUM_CHANNELS, H', W') f32."""
    dev = vis.device
    if dev.type == "cuda":
        if isinstance(pairs, GroupBinnedPairs):
            raise NotImplementedError(
                "K6 takes per-triangle BinnedPairs, as the TPU kernel does "
                "(group-binned pairs: resolve_attributes_plain on the CPU)")
        return resolve_attributes_cuda(pairs, vis, config, tile_row0)
    if dev.type == "cpu":
        return resolve_attributes_plain(pairs, vis, config, tile_row0)
    raise ValueError(f"no resolve for device {dev}")


def resolve_attributes_plain(pairs: Union[BinnedPairs, GroupBinnedPairs],
                             vis: torch.Tensor, config: FrameConfig,
                             tile_row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K6 (resolve_attributes_ref's walk):
    per-triangle pairs walk each tile's rows, then the big rows
    [0, big_count) with no box test; group-binned pairs walk every row of
    each (group, tile) pair, then of every live big group. Vectorised
    across tiles; reads the longest tile's row count on the host.
    Channel 5 takes lane 27 under config.enable_vertex_tangents."""
    if isinstance(pairs, GroupBinnedPairs):
        pair_data, offs = expand_group_pairs(pairs, config, tile_row0,
                                             boxed=False)
        big = 0
    else:
        pair_data, offs = pairs.pair_data, pairs.tile_offsets
        big = int(pairs.big_count)
    th, tw = config.tile_h, config.tile_w
    N = config.num_tiles
    dev = pair_data.device
    f32 = torch.float32
    n_rows = pair_data.shape[0]
    t = torch.arange(N, device=dev)
    ty = t // config.tiles_x + tile_row0
    tx = t % config.tiles_x
    px = (torch.arange(tw, device=dev, dtype=f32)[None, None, :]
          + (tx * tw).to(f32)[:, None, None] + 0.5)
    py = (torch.arange(th, device=dev, dtype=f32)[None, :, None]
          + (ty * th).to(f32)[:, None, None] + 0.5)
    vis_t = _to_tiles(vis, config)
    chans = torch.zeros((NUM_CHANNELS, N, th, tw), dtype=f32, device=dev)

    def row_step(rows: torch.Tensor, live: torch.Tensor) -> None:
        d = rows[:, :, None, None]                       # (N, 32, 1, 1)
        tri = d[:, 9].to(torch.int32)
        mask = live[:, None, None] & (vis_t == tri) & (tri > 0)
        for ch in range(4):
            val = plane_eval(d[:, 15 + ch * 3], d[:, 16 + ch * 3],
                             d[:, 17 + ch * 3], px, py)
            chans[ch] = torch.where(mask, val, chans[ch])
        chans[4] = torch.where(mask, d[:, 10], chans[4])
        if config.enable_vertex_tangents:
            chans[5] = torch.where(mask, d[:, 27], chans[5])

    if n_rows:
        offs = offs.long().clamp(max=n_rows)
        starts, counts = offs[:-1], offs[1:] - offs[:-1]
        for s in range(int(counts.max()) if N else 0):
            idx = torch.clamp(starts + s, max=n_rows - 1)
            row_step(pair_data[idx], s < counts)
        every = torch.ones((N,), dtype=torch.bool, device=dev)
        for j in range(min(big, n_rows)):
            row_step(pair_data[j].expand(N, SETUP_LANES), every)
    return _to_image(chans, config)


_fns = {}
# The library's kernels, in br_resolve_blocks_per_sm's numbering.
KERNELS = ("id_table_kernel", "last_match_kernel", "attr_pixels_kernel",
           "attr_pixels_kernel<tangent>")


def _kernel_fn(name: str):
    """An entry point of the built library with its ctypes signature."""
    if name not in _fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "br_resolve":
            fn.argtypes = [p, p, p, ll, p, p, p, i, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        elif name == "br_resolve_scratch":
            fn.argtypes = [i, i, i, i]
            fn.restype = ll
        else:
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def blocks_per_sm(config: FrameConfig) -> dict:
    """Resident blocks an SM of each of K6's kernels (KERNELS) on
    `config`'s tile grid."""
    fn = _kernel_fn("br_resolve_blocks_per_sm")
    return {k: fn(i, config.num_tiles) for i, k in enumerate(KERNELS)}


def build_kernel() -> cuda_build.CudaLibrary:
    """Build (if needed) and load the resolve library; returns it."""
    return cuda_build.load(SOURCE)


def resolve_attributes_cuda(pairs: BinnedPairs, vis: torch.Tensor,
                            config: FrameConfig,
                            tile_row0: int = 0) -> torch.Tensor:
    """Launch K6 on the current stream (no synchronisation; three CUDA
    kernels: the per-tile id tables, the last match of each id, the
    pixels), with the tangent channel under
    config.enable_vertex_tangents. Equals resolve_attributes_plain for
    any vis whose positive ids are below 2^31 - 1.
    `resolve_attributes_cuda.launches` counts the calls,
    TANGENT_LAUNCHES those in tangent mode."""
    pd, offs, big = pairs.pair_data, pairs.tile_offsets, pairs.big_count
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"resolve_attributes_cuda needs CUDA tensors, got "
                         f"{dev}")
    if pd.dtype != torch.float32 or pd.dim() != 2 or pd.shape[1] != SETUP_LANES:
        raise ValueError(f"pair_data must be (R, {SETUP_LANES}) f32, got "
                         f"{tuple(pd.shape)} {pd.dtype}")
    if offs.dtype != torch.int32 or offs.shape != (config.num_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({config.num_tiles + 1},) "
                         f"i32, got {tuple(offs.shape)} {offs.dtype}")
    if big.dtype != torch.int32 or big.numel() != 1:
        raise ValueError(f"big_count must be one i32, got {big.dtype}")
    if config.num_tiles > MAX_TILES:
        raise ValueError(f"K6 stages at most {MAX_TILES} tile offsets, got "
                         f"{config.num_tiles} tiles")
    Hp, Wp = config.padded_height, config.padded_width
    if vis.dtype != torch.int32 or tuple(vis.shape) != (Hp, Wp):
        raise ValueError(f"vis must be ({Hp}, {Wp}) i32, got "
                         f"{tuple(vis.shape)} {vis.dtype}")
    for name, x in (("pair_data", pd), ("tile_offsets", offs),
                    ("big_count", big), ("vis", vis)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    dims = (config.tiles_x, config.tiles_y, config.tile_h, config.tile_w)
    # The id hash tables, their keys and the per-pixel slots; written by
    # the kernels before they are read, so not initialised here.
    scratch = torch.empty((_kernel_fn("br_resolve_scratch")(*dims),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn("br_resolve")(
            offs.data_ptr(), big.data_ptr(), pd.data_ptr(), pd.shape[0],
            vis.data_ptr(), channels.data_ptr(), scratch.data_ptr(), *dims,
            int(tile_row0), int(config.enable_vertex_tangents), stream)
    if err != 0:
        raise RuntimeError(f"resolve kernel launch failed: CUDA error {err}")
    resolve_attributes_cuda.launches += 1
    if config.enable_vertex_tangents:
        TANGENT_LAUNCHES.launches += 1
    return channels


resolve_attributes_cuda.launches = 0
