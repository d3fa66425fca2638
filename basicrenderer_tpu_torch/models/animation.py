"""Skeletons + keyframe animation.

Port of basicrenderer_tpu/models/animation.py, copied with its behaviour
unchanged (host numpy): joint hierarchies with inverse-bind matrices,
keyframed translation / rotation / scale channels with LINEAR, STEP and
CUBICSPLINE interpolation, clip blending and cross-fades, the skinning
palette, and rigid node-TRS animation. The quaternion slerp and the TRS
composition are utils/math3d.py's numpy f32 versions. The glTF importer
fills the registry; skinned rendering is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..utils import math3d


@dataclasses.dataclass
class Skeleton:
    """Joint hierarchy (parents[i] < i; -1 = root) + inverse bind matrices."""
    parents: np.ndarray                  # (J,) i32
    inverse_bind: np.ndarray             # (J, 4, 4) f32
    rest_pos: np.ndarray                 # (J, 3)
    rest_rot: np.ndarray                 # (J, 4) xyzw
    rest_scale: np.ndarray               # (J, 3)
    names: Optional[List[str]] = None

    @property
    def num_joints(self) -> int:
        return len(self.parents)


@dataclasses.dataclass
class Channel:
    """One animated property of one joint."""
    joint: int
    path: str                            # "translation" | "rotation" | "scale"
    times: np.ndarray                    # (N,) f32 seconds
    values: np.ndarray                   # (N, 3|4); CUBICSPLINE: (3N, C)
    #                                      [in-tangent, value, out-tangent]
    #                                      per key (glTF layout)
    interpolation: str = "LINEAR"        # LINEAR | STEP | CUBICSPLINE


@dataclasses.dataclass
class AnimationClip:
    name: str
    channels: List[Channel]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)),
                   default=0.0)

    def sample_trs(self, skeleton: Skeleton, t: float, loop: bool = True):
        """Joint-local (pos (J,3), rot (J,4), scale (J,3)) at time t —
        the blendable representation (reference: Animation controllers
        mixing clips before palette composition)."""
        pos = skeleton.rest_pos.copy()
        rot = skeleton.rest_rot.copy()
        scl = skeleton.rest_scale.copy()
        dur = self.duration
        if loop and dur > 0:
            t = t % dur
        for ch in self.channels:
            v = _sample_channel(ch, t)
            if ch.path == "translation":
                pos[ch.joint] = v
            elif ch.path == "rotation":
                rot[ch.joint] = v / max(np.linalg.norm(v), 1e-9)
            elif ch.path == "scale":
                scl[ch.joint] = v
        return pos, rot, scl

    def sample(self, skeleton: Skeleton, t: float, loop: bool = True
               ) -> np.ndarray:
        """Sample local TRS at time t -> (J, 4, 4) local matrices."""
        return _compose_trs_batch(*self.sample_trs(skeleton, t, loop))

    def skinning_palette(self, skeleton: Skeleton, t: float,
                         loop: bool = True) -> np.ndarray:
        """(J, 4, 4) object-space skinning matrices = world(joint) @ invbind."""
        local = self.sample(skeleton, t, loop)
        world = np.zeros_like(local)
        for j in range(skeleton.num_joints):
            p = skeleton.parents[j]
            world[j] = local[j] if p < 0 else world[p] @ local[j]
        return (world @ skeleton.inverse_bind).astype(np.float32)


def rest_palette(skeleton: Skeleton) -> np.ndarray:
    """Identity skinning palette (bind pose)."""
    local = _compose_trs_batch(skeleton.rest_pos, skeleton.rest_rot,
                               skeleton.rest_scale)
    world = np.zeros_like(local)
    for j in range(skeleton.num_joints):
        p = skeleton.parents[j]
        world[j] = local[j] if p < 0 else world[p] @ local[j]
    return (world @ skeleton.inverse_bind).astype(np.float32)


def _sample_channel(ch: Channel, t: float) -> np.ndarray:
    times = ch.times
    cubic = ch.interpolation == "CUBICSPLINE"
    if len(times) == 0:
        raise ValueError("empty channel")
    if t <= times[0]:
        return ch.values[1] if cubic else ch.values[0]
    if t >= times[-1]:
        return ch.values[3 * (len(times) - 1) + 1] if cubic \
            else ch.values[-1]
    i = int(np.searchsorted(times, t) - 1)
    if ch.interpolation == "STEP":
        return ch.values[i]
    dt = max(times[i + 1] - times[i], 1e-9)
    f = (t - times[i]) / dt
    if cubic:
        # glTF CUBICSPLINE = cubic Hermite on [v_k, v_k+1] with scaled
        # out/in tangents (reference: AnimationClip.h cubic channels).
        vk = ch.values[3 * i + 1]
        bk = ch.values[3 * i + 2]            # out-tangent of key k
        vk1 = ch.values[3 * (i + 1) + 1]
        ak1 = ch.values[3 * (i + 1)]         # in-tangent of key k+1
        f2, f3 = f * f, f * f * f
        v = ((2 * f3 - 3 * f2 + 1) * vk + dt * (f3 - 2 * f2 + f) * bk
             + (-2 * f3 + 3 * f2) * vk1 + dt * (f3 - f2) * ak1)
        if ch.path == "rotation":
            v = v / max(np.linalg.norm(v), 1e-9)
        return v
    a, b = ch.values[i], ch.values[i + 1]
    if ch.path == "rotation":
        return np.asarray(math3d.quat_slerp(a, b, float(f)))
    return a * (1 - f) + f * b


def blend_trs(trs_a, trs_b, w: float):
    """Blend two joint-local TRS sets: lerp pos/scale, per-joint shortest-
    arc slerp for rotations (the two-clip Animation-controller mix)."""
    pa, ra, sa = trs_a
    pb, rb, sb = trs_b
    pos = pa * (1 - w) + pb * w
    scl = sa * (1 - w) + sb * w
    rot = np.stack([np.asarray(math3d.quat_slerp(ra[j], rb[j], w))
                    for j in range(len(ra))])
    return pos, rot, scl


def palette_from_trs(skeleton: Skeleton, trs) -> np.ndarray:
    """(J, 4, 4) skinning palette from joint-local TRS."""
    local = _compose_trs_batch(*trs)
    world = np.zeros_like(local)
    for j in range(skeleton.num_joints):
        p = skeleton.parents[j]
        world[j] = local[j] if p < 0 else world[p] @ local[j]
    return (world @ skeleton.inverse_bind).astype(np.float32)


def _compose_trs_batch(pos, rot, scl) -> np.ndarray:
    J = len(pos)
    out = np.zeros((J, 4, 4), np.float32)
    for j in range(J):
        out[j] = np.asarray(math3d.compose_trs(pos[j], rot[j], scl[j]))
    return out


class SkeletonRegistry:
    """Host registry of skeletons + playing clips (SkeletonManager analogue)."""

    def __init__(self):
        self.skeletons: List[Skeleton] = []
        self.clips: Dict[int, List[AnimationClip]] = {}
        self._playing: Dict[int, tuple] = {}   # skeleton_id -> (clip_idx, t0)

    def add(self, skeleton: Skeleton) -> int:
        self.skeletons.append(skeleton)
        return len(self.skeletons) - 1

    def add_clip(self, skeleton_id: int, clip: AnimationClip) -> int:
        self.clips.setdefault(skeleton_id, []).append(clip)
        return len(self.clips[skeleton_id]) - 1

    def play(self, skeleton_id: int, clip_idx: int = 0, t0: float = 0.0,
             fade: float = 0.0) -> None:
        """Start a clip; `fade` > 0 cross-fades from whatever was playing
        over that many seconds (controller-style transition)."""
        prev = self._playing.get(skeleton_id)
        self._playing[skeleton_id] = (clip_idx, t0, prev if fade > 0 else
                                      None, fade)

    def set_blend(self, skeleton_id: int, clip_a: int, clip_b: int,
                  weight: float) -> None:
        """Pin a static two-clip blend (e.g. walk/run by speed)."""
        self._playing[skeleton_id] = ("blend", clip_a, clip_b,
                                      float(weight))

    def palette(self, skeleton_id: int, t: float) -> np.ndarray:
        sk = self.skeletons[skeleton_id]
        playing = self._playing.get(skeleton_id)
        clips = self.clips.get(skeleton_id)
        if playing is None or not clips:
            return rest_palette(sk)
        if playing[0] == "blend":
            _, ca, cb, w = playing
            trs = blend_trs(clips[ca].sample_trs(sk, t),
                            clips[cb].sample_trs(sk, t), w)
            return palette_from_trs(sk, trs)
        clip_idx, t0, prev, fade = playing
        trs = clips[clip_idx].sample_trs(sk, t - t0)
        if prev is not None and fade > 0 and (t - t0) < fade:
            # Cross-fade: the previous state keeps advancing on its own
            # timeline while the new clip ramps in.
            w = max(0.0, min(1.0, (t - t0) / fade))
            if prev[0] == "blend":
                _, ca, cb, bw = prev
                prev_trs = blend_trs(clips[ca].sample_trs(sk, t),
                                     clips[cb].sample_trs(sk, t), bw)
            else:
                prev_trs = clips[prev[0]].sample_trs(sk, t - prev[1])
            trs = blend_trs(prev_trs, trs, w)
        return palette_from_trs(sk, trs)


# ---------------------------------------------------------------------------
# Rigid node-TRS animation (FBX AnimationStack / Assimp aiNodeAnim analogue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeTrack:
    """Animated TRS channels of one scene entity (Channel.joint unused)."""
    entity: int
    channels: List[Channel]


@dataclasses.dataclass
class NodeAnimation:
    """Rigid node animation: drives scene entities' Position/Rotation/Scale
    components — the consumption path for FBX AnimationCurveNode stacks
    (reference: Assimp aiNodeAnim import, AssimpLoader.cpp:240-400; joint
    clips go through SkeletonRegistry instead)."""
    name: str
    tracks: List[NodeTrack]

    @property
    def duration(self) -> float:
        return max((float(ch.times[-1]) for tr in self.tracks
                    for ch in tr.channels if len(ch.times)), default=0.0)

    def apply(self, scene, t: float, loop: bool = True) -> None:
        """Sample every track at time t and write the entities' TRS
        components (tagging them transform-dirty); the caller runs
        scene.propagate_transforms() once afterwards."""
        from ..scene.components import (Position, Rotation, Scale,
                                        TAG_TRANSFORM_DIRTY)
        dur = self.duration
        if loop and dur > 0:
            t = t % dur
        for tr in self.tracks:
            for ch in tr.channels:
                v = _sample_channel(ch, t)
                if ch.path == "translation":
                    scene.world.set(tr.entity, Position(v))
                elif ch.path == "rotation":
                    q = v / max(np.linalg.norm(v), 1e-9)
                    scene.world.set(tr.entity, Rotation(q))
                elif ch.path == "scale":
                    scene.world.set(tr.entity, Scale(v))
            scene.world.add_tag(tr.entity, TAG_TRANSFORM_DIRTY)
