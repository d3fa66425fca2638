"""Carry state across from the JAX package to the port.

Each function takes one of the JAX package's buffer types given as a
mapping of field name -> numpy array (for example
`{f: np.asarray(getattr(x, f)) for f in x._fields}` for a NamedTuple) and
returns the port's type with the same values on `device` (the card
unless the caller names another device). Fields the port does not carry
are ignored; uint32 words become int32 tensors with the same bits. No JAX
is imported here: the caller converts.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .graph.framedata import FrameParams, SceneBuffers, ViewData
from .ops.raster_setup import BinnedPairs, GroupBinnedPairs
from .ops.vsm import VsmState


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        raise TypeError("expected f32 data, got f64")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # A copy: arrays from JAX are read-only, and tensors must own theirs.
    return torch.as_tensor(np.array(a, order="C"), device=device)


def _fill(cls, data: Mapping, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            v = data[f.name]
            # Plain-float fields (FrameParams.light_size) stay host floats.
            kw[f.name] = (float(v) if isinstance(f.default, float)
                          else _tensor(v, device))
        elif f.default is dataclasses.MISSING:
            raise KeyError(f"{cls.__name__} needs field {f.name!r}")
    return cls(**kw)


def scene_buffers(data: Mapping, device="cuda") -> SceneBuffers:
    """JAX SceneBuffers fields -> the port's SceneBuffers (soup, cluster,
    texture and environment fields)."""
    return _fill(SceneBuffers, data, device)


def view_data(data: Mapping, device="cuda") -> ViewData:
    """JAX ViewData fields -> the port's ViewData."""
    return _fill(ViewData, data, device)


def frame_params(data: Mapping, device="cuda") -> FrameParams:
    """JAX FrameParams fields -> the port's FrameParams."""
    return _fill(FrameParams, data, device)


def vsm_state(data: Mapping, device="cuda") -> VsmState:
    """JAX VsmState fields -> the port's VsmState (page tables, ages,
    atlas, frozen z range, initialised flag)."""
    return _fill(VsmState, data, device)


def binned_pairs(data: Mapping, device="cuda") -> BinnedPairs:
    """JAX BinnedPairs fields -> the port's BinnedPairs (i32 counters)."""
    return BinnedPairs(
        pair_data=_tensor(data["pair_data"], device),
        tile_offsets=_tensor(np.asarray(data["tile_offsets"], np.int32), device),
        num_pairs=_tensor(np.asarray(data["num_pairs"], np.int32), device),
        overflow=_tensor(np.asarray(data["overflow"], np.int32), device),
        big_count=_tensor(np.asarray(data["big_count"], np.int32), device),
    )


def group_binned_pairs(data: Mapping, device="cuda") -> GroupBinnedPairs:
    """JAX GroupBinnedPairs fields -> the port's GroupBinnedPairs."""
    return GroupBinnedPairs(**{
        f: _tensor(data[f] if f == "lanes" else np.asarray(data[f], np.int32),
                   device)
        for f in GroupBinnedPairs._fields})
