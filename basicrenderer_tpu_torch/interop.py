"""Carry state across from the JAX package to the port.

Each function takes one of the JAX package's buffer types given as a
mapping of field name -> numpy array (for example
`{f: np.asarray(getattr(x, f)) for f in x._fields}` for a NamedTuple) and
returns the port's type with the same values on `device`. Fields the port
does not carry are ignored. No JAX is imported here: the caller converts.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .graph.framedata import FrameParams, SceneBuffers, ViewData
from .ops.raster_setup import BinnedPairs


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        raise TypeError("expected f32 data, got f64")
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


def scene_buffers(data: Mapping, device="cpu") -> SceneBuffers:
    """JAX SceneBuffers fields -> the port's SceneBuffers (soup fields)."""
    return _fill(SceneBuffers, data, device)


def view_data(data: Mapping, device="cpu") -> ViewData:
    """JAX ViewData fields -> the port's ViewData."""
    return _fill(ViewData, data, device)


def frame_params(data: Mapping, device="cpu") -> FrameParams:
    """JAX FrameParams fields -> the port's FrameParams."""
    return _fill(FrameParams, data, device)


def binned_pairs(data: Mapping, device="cpu") -> BinnedPairs:
    """JAX BinnedPairs fields -> the port's BinnedPairs (i32 counters)."""
    return BinnedPairs(
        pair_data=_tensor(data["pair_data"], device),
        tile_offsets=_tensor(np.asarray(data["tile_offsets"], np.int32), device),
        num_pairs=_tensor(np.asarray(data["num_pairs"], np.int32), device),
        overflow=_tensor(np.asarray(data["overflow"], np.int32), device),
        big_count=_tensor(np.asarray(data["big_count"], np.int32), device),
    )
