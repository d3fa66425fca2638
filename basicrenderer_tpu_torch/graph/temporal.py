"""Frame-to-frame bookkeeping: the inputs a temporal frame needs.

Counterpart of the TAA and VSM parts of basicrenderer_tpu/renderer.py
(`Renderer.render`, renderer.py:459-525, and the VSM invalidation of
`Renderer.update`, renderer.py:383-427); the port's renderer.py
delegates them here. Per frame, `TemporalState.inputs` gives:

- the ViewData with the Halton sub-pixel jitter in the projection (with
  enable_taa; in render pixels, also under TAAU);
- the FrameParams with this frame's `frame_index` (GTAO rotates its slices
  with it);
- the frame function's keyword arguments: `prev_depth` (with occlusion or
  TAA; zeros before the first frame), `taa_history` (the previous frame's
  "taa_out", at the output size under TAAU; None first or when its shape
  is not this config's), and, once a previous frame exists,
  `prev_viewproj` (its UN-jittered view-projection: the jitter is a
  supersampling offset, not motion) with `moving_rel` / `moving_ids`, the
  objects whose model matrix changed since, each with prev_viewproj @
  prev_model @ inv(cur_model);
- with enable_vsm, `vsm_state`: the page cache the previous frame
  returned (its light-space z range frozen at first use), made anew on
  first use or when the VSM geometry changes, dropped when any light
  changes, with the pages under moved objects invalidated (up to
  MAX_MOVING objects; more drop the whole cache).

`carry(out)` takes the frame's outputs over to the next frame. The caller
refreshes the scene buffers (`bridge.update_dynamic`) when objects move.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import vsm as vsm_ops
from ..ops.motion import MAX_MOVING
from ..ops.post import taa_jitter
from .framedata import FrameConfig, FrameParams, ViewData, make_view


class TemporalState:
    """Temporal state across the frames of one view: previous depth,
    history, un-jittered view-projection and object matrices, the frame
    index and the VSM page cache. Tensors go to `device` (the card unless
    the caller names another)."""

    def __init__(self, config: FrameConfig, params: FrameParams = None,
                 device="cuda"):
        self.config = config
        self.device = device
        self.params = params if params is not None else FrameParams.default(device)
        self.frame_index = 0
        self.prev_depth: Optional[torch.Tensor] = None
        self.taa_history: Optional[torch.Tensor] = None
        self.prev_viewproj: Optional[np.ndarray] = None
        self.prev_object_mats: Optional[np.ndarray] = None
        self.vsm_state = None
        self._vsm_geom = None
        self._vsm_light_hash = None
        self._vsm_prev_mats: Optional[np.ndarray] = None
        self._vsm_prev_bounds: Optional[np.ndarray] = None

    def inputs(self, scene, bridge, camera=None, objects=None, lights=None
               ) -> Tuple[ViewData, FrameParams, Dict[str, object]]:
        """(view, params, frame kwargs) for this state's current frame of
        `scene`'s camera. Records this frame's un-jittered view-projection
        and object matrices for the next frame's motion. `camera` (view,
        proj, position), `objects` (bridge.snapshot_objects()) and `lights`
        (the light table) stand in for reading the scene and the bridge,
        for a caller that captured them earlier (the Renderer's scene
        overlap)."""
        cfg = self.config
        fi = self.frame_index
        view_np, proj_np, cam_pos = camera if camera is not None else \
            scene.camera_matrices(aspect=cfg.width / cfg.height)
        vp_unjit = (proj_np @ view_np).astype(np.float32)
        if cfg.enable_taa:
            jx, jy = taa_jitter(fi)
            proj_np = np.array(proj_np, np.float32)
            proj_np[0] += (2.0 * jx / cfg.width) * proj_np[3]
            proj_np[1] += (2.0 * jy / cfg.height) * proj_np[3]
        view = make_view(view_np, proj_np, cam_pos, device=self.device)
        params = dataclasses.replace(self.params, frame_index=torch.tensor(
            fi, dtype=torch.int32, device=self.device))
        kwargs: Dict[str, object] = {}
        if objects is None and (cfg.enable_taa or cfg.enable_vsm):
            objects = bridge.snapshot_objects()
        if cfg.enable_occlusion or cfg.enable_taa:
            shape = (cfg.padded_height, cfg.padded_width)
            if self.prev_depth is None or tuple(self.prev_depth.shape) != shape:
                self.prev_depth = torch.zeros(shape, dtype=torch.float32,
                                              device=self.device)
            kwargs["prev_depth"] = self.prev_depth
        if cfg.enable_taa:
            hist = self.taa_history
            out_h = cfg.output_height or cfg.height
            out_w = cfg.output_width or cfg.width
            if hist is not None and tuple(hist.shape) != (out_h, out_w, 3):
                hist = None
            kwargs["taa_history"] = hist
            cur_mats = objects[0]
            prev_mats = self.prev_object_mats
            if self.prev_viewproj is not None and prev_mats is not None \
                    and prev_mats.shape == cur_mats.shape:
                rel, ids = moved_objects(self.prev_viewproj, prev_mats,
                                         cur_mats)
                kwargs["prev_viewproj"] = self._t(self.prev_viewproj)
                kwargs["moving_rel"] = self._t(rel)
                kwargs["moving_ids"] = self._t(ids)
            self.prev_viewproj = vp_unjit
            self.prev_object_mats = cur_mats.copy()
        if cfg.enable_vsm:
            if lights is None:
                lights = bridge.snapshot_lights()[0]
            self._vsm_invalidate(lights, objects[0], objects[2])
            geom = (vsm_ops.geometry(cfg), cfg.vsm_num_lights)
            if self.vsm_state is None or self._vsm_geom != geom:
                self.vsm_state = vsm_ops.init_states(cfg, device=self.device)
            self._vsm_geom = geom
            kwargs["vsm_state"] = self.vsm_state
        return view, params, kwargs

    def _vsm_invalidate(self, lights: np.ndarray, mats: np.ndarray,
                        bounds: np.ndarray) -> None:
        """Drop the VSM cache when a light changed (the light basis moves
        every page) or more than MAX_MOVING objects moved; else clear the
        pages under each moved object's old and new bounding spheres
        (`lights`, `mats`, `bounds`: this frame's light table, object
        matrices and spheres)."""
        lh = hash(lights.tobytes())
        if lh != self._vsm_light_hash:
            self.vsm_state = None
        self._vsm_light_hash = lh
        pm, pb = self._vsm_prev_mats, self._vsm_prev_bounds
        if pm is not None and pm.shape == mats.shape \
                and self.vsm_state is not None:
            moved = np.nonzero(np.abs(mats - pm).max(axis=(1, 2)) > 1e-7)[0]
            if len(moved) > MAX_MOVING:
                self.vsm_state = None
            elif len(moved):
                spheres = np.full((MAX_MOVING, 4), -1.0, np.float32)
                for i, o in enumerate(moved):
                    c0, r0 = pb[o, :3], pb[o, 3]
                    c1, r1 = bounds[o, :3], bounds[o, 3]
                    rad = float(np.linalg.norm(c1 - c0)) * 0.5 \
                        + max(float(r0), float(r1))
                    spheres[i] = [*((c0 + c1) * 0.5), rad]
                sph = self._t(spheres)
                st = self.vsm_state
                if isinstance(st, tuple):
                    self.vsm_state = tuple(
                        vsm_ops.invalidate_pages(s, sph, self._t(lights[k, 4:7]),
                                                 self.config)
                        for k, s in enumerate(st))
                else:
                    self.vsm_state = vsm_ops.invalidate_pages(
                        st, sph, self._t(lights[0, 4:7]), self.config)
        self._vsm_prev_mats = mats.copy()
        self._vsm_prev_bounds = bounds.copy()

    def carry(self, out: Dict[str, torch.Tensor]) -> None:
        """Keep this frame's outputs for the next frame and advance the
        frame index."""
        cfg = self.config
        if cfg.enable_occlusion or cfg.enable_taa:
            self.prev_depth = out["depth_padded"]
        if cfg.enable_taa:
            self.taa_history = out["taa_out"]
        if "vsm_state" in out:
            self.vsm_state = out["vsm_state"]
        self.frame_index += 1

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)


def moved_objects(prev_viewproj: np.ndarray, prev_mats: np.ndarray,
                  cur_mats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(MAX_MOVING, 4, 4) f32 relative matrices and (MAX_MOVING,) i32 ids
    (-1 unused) of the first MAX_MOVING objects whose model matrix changed
    by more than 1e-7; a singular current matrix leaves its slot unused."""
    rel = np.zeros((MAX_MOVING, 4, 4), np.float32)
    ids = np.full((MAX_MOVING,), -1, np.int32)
    moved = np.nonzero(np.abs(cur_mats - prev_mats).max(axis=(1, 2)) > 1e-7)[0]
    for i, o in enumerate(moved[:MAX_MOVING]):
        try:
            inv_cur = np.linalg.inv(cur_mats[o])
        except np.linalg.LinAlgError:
            continue
        rel[i] = prev_viewproj @ prev_mats[o] @ inv_cur
        ids[i] = o
    return rel, ids
