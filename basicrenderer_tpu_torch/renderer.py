"""Top-level Renderer: the user-facing orchestration class.

Port of basicrenderer_tpu/renderer.py (reference: BasicRenderer/include/
Renderer.h:73-89 — Initialize/OnResize/Update/Render/SetCurrentScene/
SetEnvironment):

- `Initialize` -> the constructor: settings, registries, the frame
  function cache and, on the card, one build of every kernel library
  (utils/cuda_build.build_all, keyed by source hash in `_build/`: the
  counterpart of the reference's shader artifact cache).
- `Update`     -> host-side scene sync: propagate transforms, snapshot
  object matrices and lights into the scene buffers (SceneRenderBridge),
  inline or, with `enableSceneOverlap`, on a worker thread.
- `Render`     -> the frame function of the current FrameConfig, fed by
  graph/temporal.TemporalState (TAA jitter, motion inputs, previous
  depth and history, the VSM page cache). On the card the call returns
  once its work is queued (the reference's frames in flight); reading an
  output synchronises.
- A structural settings change builds a new FrameConfig and frame
  function (the reference's render-graph rebuild, Renderer.cpp:1794).

Tensors live on `device` ("cuda" unless the caller names another).
Every setting of the JAX package's catalog reaches the FrameConfig as
there. The per-frame host work of the JAX Renderer is here too: the
geometry streamer's bring-up (enableStreaming: models/streaming.py over
the packed pages or a page-blob container) and the texture streamer's
(enableTextureStreaming: models/texstream.py over a strip container,
written once under the port's `_build/texstream` when none is given);
their feedback ticks are pipelined, one in flight each: a frame's
"touched_groups" / "tex_wanted" are copied to the host through
utils/readback.py and the streamer runs on its worker, and a completed
tick's tables are spliced into the scene buffers before the next frame
(a failed tick raises there). Skinning is switched on when a packed
instance is skinned, and its palette follows the animation clock; the
voxel pyramid is rebuilt when the lights, the object transforms or
voxelResolution change.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .graph.frame import FrameProgramCache
from .graph.framedata import (MAX_SHADOW_CUBE_SLOTS, MAX_SHADOW_SPOT_SLOTS,
                              FrameConfig, FrameParams, SceneBuffers)
from .graph.temporal import TemporalState
from .models.animation import SkeletonRegistry
from .models.materials import MaterialRegistry
from .models.mesh import MeshRegistry
from .models.pageblob import PageBlobContainer
from .models.streaming import GeometryStreamer
from .models.texprocess import ProcessedTextureCache
from .models.texstream import (TextureStreamContainer, TextureStreamer,
                               save_strip_container)
from .models.textures import TextureRegistry
from .models.voxels import static_level_offsets
from .scene.bridge import BridgeCapacities, SceneRenderBridge
from .scene.components import Light, LightType, Renderable
from .scene.scene import Scene
from .utils.cuda_build import BUILD_DIR
from .utils.readback import ReadbackManager
from .utils.settings import SettingsManager, make_default_settings
from .utils.telemetry import FrameTelemetry


def kernel_sources():
    """The CUDA sources of every kernel a frame may launch."""
    from .ops import lighting, raster, resolve, taa_warp, textures
    return [raster.SOURCE, lighting.SOURCE, textures.SOURCE, taa_warp.SOURCE,
            resolve.SOURCE]


class Renderer:
    def __init__(self, settings: Optional[SettingsManager] = None,
                 caps: Optional[BridgeCapacities] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from .utils.cuda_build import build_all
            build_all(kernel_sources())
        self.settings = settings or make_default_settings()
        self.meshes = MeshRegistry()
        self.materials = MaterialRegistry()
        self.skeletons = SkeletonRegistry()
        self.textures = TextureRegistry(processed_cache=ProcessedTextureCache(
            str(BUILD_DIR / "textures")))
        self.telemetry = FrameTelemetry()
        self._time = 0.0
        self.caps = caps or BridgeCapacities()
        self._programs = FrameProgramCache()
        self._scene: Optional[Scene] = None
        self._bridge: Optional[SceneRenderBridge] = None
        self._buffers: Optional[SceneBuffers] = None
        self._environment = None
        self._temporal: Optional[TemporalState] = None
        self._settings_generation = -1
        self._config: Optional[FrameConfig] = None
        self._readback = None
        # Streaming feedback: the streamers, their in-flight ticks and the
        # readback service that fetches the feedback and runs the ticks.
        self._streamer = None
        self._tex_streamer = None
        self._stream_future = None
        self._tex_future = None
        self._feedback: Optional[ReadbackManager] = None
        self._voxel_hash = None
        # Scene-update <-> render overlap (reference: the worker-thread
        # snapshot pipeline, Renderer.cpp:597-741, 1755-1769).
        self._update_pool = None
        self._update_future = None
        self._overlap = None   # committed (camera, objects, lights)

    # -- scene management --------------------------------------------------
    def set_current_scene(self, scene: Scene) -> None:
        self._scene = scene
        self._bridge = SceneRenderBridge(
            scene, self.meshes, self.materials, self.caps,
            skeletons=self.skeletons, textures=self.textures,
            tex_format=self.settings.get("textureFormat", "rgba8"))
        if self.settings.get("textureFormat") == "bc3" and \
                self.settings.get("enableTextureStreaming"):
            raise ValueError(
                "textureFormat=bc3 + enableTextureStreaming is not "
                "supported yet: the texstream container streams RGBA8 "
                "strip rows")
        if len(self.textures):
            self.settings.set("enableTextures", True)
        self._buffers = None  # force geometry re-upload
        # Virtualized geometry: the cluster path MUST run when any mesh
        # carries a LOD DAG (all levels are resident in the soup) or any
        # mesh is instanced more than once (geometry is shared; per-instance
        # cluster rows carry object/material — see bridge.pack_geometry).
        mesh_uses = {}
        for _e, (r,) in scene.world.query(Renderable):
            mesh_uses[r.mesh_id] = mesh_uses.get(r.mesh_id, 0) + 1
        if any(m.tri_cluster is not None for m in self.meshes.meshes) or \
                any(v > 1 for v in mesh_uses.values()):
            self.settings.set("enableClod", True)

    def set_environment(self, env) -> None:
        """Set the IBL environment (reference: Renderer::SetEnvironment,
        Renderer.h:84). Accepts a models.environment.Environment, an
        equirect (H, W, 3) array, or the string 'procedural' (the last two
        precomputed on the renderer's device)."""
        from .models.environment import Environment
        if isinstance(env, str):
            env = Environment.procedural(device=self.device)
        elif isinstance(env, np.ndarray):
            env = Environment.precompute(env, device=self.device)
        self._environment = env
        self.settings.set("enableIBL", True)
        self._buffers = None

    @property
    def scene(self) -> Scene:
        assert self._scene is not None, "call set_current_scene first"
        return self._scene

    # -- config ------------------------------------------------------------
    def _build_config(self) -> FrameConfig:
        s = self.settings
        w, h = s.get("renderResolution")
        mats = self.materials.materials
        return FrameConfig(
            width=w, height=h,
            tile_h=s.get("tileSize")[0], tile_w=s.get("tileSize")[1],
            max_pairs=s.get("maxTrianglePairs"),
            enable_shadows=s.get("enableShadows"),
            num_cascades=s.get("numShadowCascades"),
            shadow_resolution=s.get("shadowResolution"),
            enable_clustered=s.get("enableClusteredLighting"),
            max_lights_per_cluster=s.get("maxLightsPerCluster"),
            enable_ibl=s.get("enableIBL"),
            enable_textures=s.get("enableTextures", False),
            enable_texture_streaming=s.get("enableTextureStreaming", False),
            tex_format=s.get("textureFormat", "rgba8"),
            tex_channels=self._live_tex_channels(),
            enable_bloom=s.get("enableBloom"),
            enable_gtao=s.get("enableGTAO"),
            enable_ssr=s.get("enableSSR"),
            enable_taa=s.get("enableTAA") or s.get("upscaleMode") == "taa",
            output_width=(s.get("outputResolution")[0]
                          if s.get("upscaleMode") == "taa" else 0),
            output_height=(s.get("outputResolution")[1]
                           if s.get("upscaleMode") == "taa" else 0),
            enable_skinning=s.get("enableSkinning"),
            enable_oit=s.get("enableOIT"),
            oit_layers=s.get("oitLayers"),
            enable_alpha_mask=any(m.alpha_cutoff >= 0.0 for m in mats),
            mask_peels=s.get("maskPeels", 1),
            enable_vertex_tangents=s.get("vertexTangents", False),
            max_shadow_lights=self._count_shadow_spots(),
            max_shadow_cubes=self._count_shadow_points(),
            enable_coat=any(m.coat_weight > 0.0 for m in mats),
            enable_fuzz=any(m.fuzz_weight > 0.0 for m in mats),
            enable_sss=any(m.subsurface_weight > 0.0 for m in mats),
            enable_aniso=any(m.anisotropy_strength > 0.0 for m in mats),
            enable_transmission=any(m.transmission_weight > 0.0
                                    for m in mats),
            enable_energy_comp=s.get("enableEnergyCompensation", False),
            enable_auto_exposure=s.get("enableAutoExposure"),
            enable_vsm=s.get("enableVSM"),
            vsm_num_lights=s.get("vsmNumLights", 1),
            vsm_filter_taps=s.get("vsmFilterTaps", 1),
            vsm_rays=s.get("vsmRays", 0),
            vsm_ray_samples=s.get("vsmRaySamples", 3),
            vsm_slots=s.get("vsmSlots", 128),
            vsm_levels=s.get("vsmLevels", 6),
            enable_culling=s.get("enableFrustumCulling", True),
            enable_clod=s.get("enableClod"),
            enable_streaming=s.get("enableStreaming", False),
            streaming_priority=s.get("streamingPriorityMode", "max"),
            max_visible_clusters=s.get("maxVisibleClusters"),
            enable_occlusion=s.get("enableOcclusionCulling"),
            debug_view=s.get("debugView"),
            wireframe=s.get("wireframe", False),
            enable_reyes=s.get("enableReyes", False),
            reyes_tris=s.get("reyesTriBudget", 512),
            reyes_dice=s.get("reyesDiceRate", 4),
            reyes_px=s.get("reyesPixelThreshold", 48.0),
            reyes_split_tris=s.get("reyesSplitBudget", 0),
            reyes_split_factor=s.get("reyesSplitFactor", 4.0),
            enable_voxel_rt=s.get("enableVoxelRT", False),
            enable_rt_reflect=s.get("enableRTReflections", False),
            enable_voxel_fallback=s.get("enableVoxelFallback", False),
            voxel_n=s.get("voxelResolution", 64),
            voxel_sggx=s.get("voxelSGGX", False),
            voxel_level_offsets=static_level_offsets(
                s.get("voxelResolution", 64)),
        )

    def _count_lights(self, kind, cap: int) -> int:
        if self._scene is None:
            return 0
        n = sum(1 for _e, (light,) in self._scene.world.query(Light)
                if light.type == kind and light.cast_shadows)
        return min(n, cap)

    def _count_shadow_spots(self) -> int:
        """Shadow-casting spot lights (capped at 4 slots — each costs a
        shadow render + a full-screen shadowed shade)."""
        return self._count_lights(LightType.SPOT, MAX_SHADOW_SPOT_SLOTS)

    def _count_shadow_points(self) -> int:
        """Shadow-casting point lights (capped at 2 cubes — 6 face renders
        + a full-screen shadowed shade each)."""
        return self._count_lights(LightType.POINT, MAX_SHADOW_CUBE_SLOTS)

    def _live_tex_channels(self) -> tuple:
        """Channel samples the frame actually needs (unused ones cost
        nothing — they're dropped from the frame)."""
        ms = self.materials.materials
        chans = []
        if any(m.base_color_texture >= 0 for m in ms):
            chans.append("base")
        if any(m.normal_texture >= 0 for m in ms):
            chans.append("normal")
        if any(m.metallic_roughness_texture >= 0 for m in ms):
            chans.append("mr")
        if any(m.emissive_texture >= 0 for m in ms):
            chans.append("emissive")
        return tuple(chans) or ("base",)

    def current_config(self) -> FrameConfig:
        if self._config is None or \
                self.settings.generation != self._settings_generation:
            self._config = self._build_config()
            self._settings_generation = self.settings.generation
        return self._config

    def on_resize(self, width: int, height: int) -> None:
        self.settings.set("renderResolution", (width, height))

    # -- frame loop --------------------------------------------------------
    def update(self, dt: float = 1.0 / 60.0) -> None:
        """Host-side per-frame work (reference Renderer::Update,
        Renderer.cpp:1724): transforms and the buffer snapshot.

        With `enableSceneOverlap` on, the scene sync for frame N runs on a
        worker thread WHILE frame N-1's device work executes (the
        reference's ScheduleSceneUpdateTask / CommitCompletedSceneSnapshot
        pipeline, Renderer.cpp:597-741): this call commits the snapshot
        the worker produced last frame and schedules the next one, so the
        main thread pays only commit + dispatch. Contract (same as the
        reference's deferred-edit protocol): between update() calls, scene
        edits must go through `scene.world.defer(...)` — the worker
        flushes them at task start; direct edits race the worker."""
        assert self._bridge is not None
        if not self.settings.get("enableSceneOverlap", False):
            self._overlap = None
            fut = self._update_future
            if fut is not None:        # toggle flipped off mid-run: drain
                fut.result()
                self._update_future = None
            self._update_sync(dt)
            return
        if self._update_future is None or self._buffers is None:
            self._update_sync(dt)      # bootstrap frame runs inline
        else:
            self.telemetry.begin_frame()
            self._time += dt
            with self.telemetry.stage("scene_commit"):
                fields, self._overlap = self._update_future.result()
                self._buffers = dataclasses.replace(self._buffers, **fields)
            self._post_snapshot_update()
        if self._update_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._update_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="scene-update")
        cfg = self.current_config()
        self._update_future = self._update_pool.submit(
            self._scene_update_task, self._time + dt, cfg.width / cfg.height)

    def _scene_update_task(self, t_anim: float, aspect: float):
        """Worker-thread scene sync for the NEXT frame: deferred-edit
        flush, transform propagation, the dynamic fields uploaded (a plain
        synchronous copy on the default stream, ordered before every later
        launch), and the camera, objects and lights render() will use (so
        the main thread never reads the world while the next propagation
        runs)."""
        self.scene.world.flush_deferred()
        self.scene.propagate_transforms()
        objects = self._bridge.snapshot_objects()
        lights, num_lights, num_dir = self._bridge.snapshot_lights()
        mats, nmats, bounds, ovalid = objects

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)
        fields = dict(
            joint_palette=t(self._bridge.snapshot_joint_palette(t_anim)),
            object_mats=t(mats), object_normal_mats=t(nmats),
            object_bounds=t(bounds), object_valid=t(ovalid),
            lights=t(lights), num_lights=t(num_lights, np.int32),
            num_dir_lights=t(num_dir, np.int32),
        )
        cam = self.scene.camera_matrices(aspect=aspect)
        return fields, (cam, tuple(a.copy() for a in objects), lights.copy())

    def _update_sync(self, dt: float) -> None:
        """The synchronous update path (also the overlap bootstrap)."""
        self.telemetry.begin_frame()
        self._time += dt
        with self.telemetry.stage("scene_update"):
            self.scene.world.flush_deferred()
            self.scene.propagate_transforms()
        if self._buffers is None:
            env = self._environment
            if env is not None:
                self._buffers = self._bridge.build_scene_buffers(
                    env_sh=env.sh, env_specular=env.spec_mips,
                    device=self.device)
            else:
                self._buffers = self._bridge.build_scene_buffers(
                    device=self.device)
        else:
            self._buffers = self._bridge.update_dynamic(self._buffers,
                                                        self._time)
        self._post_snapshot_update()

    def _replace_buffers(self, **fields) -> None:
        self._buffers = dataclasses.replace(self._buffers, **fields)

    def _post_snapshot_update(self) -> None:
        """Main-thread per-frame work on the committed snapshot (no worker
        in flight, so reading the scene here is race-free): the streamers'
        bring-up, skinning's auto-enable and the voxel rebuild. The VSM
        page invalidation of moved objects and changed lights is
        graph/temporal's, done when render() takes the frame's inputs."""
        s = self.settings
        # Geometry streaming: page pool + feedback loop.
        if s.get("enableStreaming", False) and \
                self._bridge.packed is not None and self._streamer is None:
            container = None
            cpath = s.get("streamingContainer", "")
            if cpath:
                container = PageBlobContainer(cpath)
            self._streamer = GeometryStreamer(
                self._bridge.packed, self.caps.max_groups,
                s.get("streamingSlots"), container=container,
                device=self.device)
            sv, sdq, gs, gr = self._streamer.update(
                np.zeros(self.caps.max_groups, bool))
            self._replace_buffers(cluster_verts=sv, cluster_dequant=sdq,
                                  geom_slot=gs, group_resident=gr)
        # Texture streaming: disk container + feedback streamer. Without a
        # container path the registry's atlas is written once under the
        # port's build directory (keyed by its hash): the memmapped file
        # is the streaming source either way.
        if s.get("enableTextureStreaming", False) and len(self.textures) \
                and self._tex_streamer is None:
            cpath = s.get("textureStreamContainer", "")
            if not cpath:
                strips_np, flags_np = self.textures.strip_pyramid()
                h = hashlib.sha1(np.asarray(strips_np).tobytes())
                cdir = BUILD_DIR / "texstream"
                cdir.mkdir(parents=True, exist_ok=True)
                cpath = str(cdir / (h.hexdigest()[:16] + ".brts"))
                if not os.path.exists(cpath):
                    save_strip_container(cpath, np.asarray(strips_np),
                                         np.asarray(flags_np),
                                         self.textures.resolution)
            self._tex_streamer = TextureStreamer(
                TextureStreamContainer(cpath),
                fine_row_budget=s.get("textureFineRowBudget"),
                device=self.device)
            self._replace_buffers(tex_strips=self._tex_streamer.strips,
                                  tex_flags=self._tex_streamer.flags_device())
        # Skinning switches on when any packed instance is skinned.
        if self._bridge.packed and self._bridge.packed.skin_instances:
            s.set("enableSkinning", True)
        # Voxel ray tier: (re)build the radiance pyramid when it is on and
        # the lights or object transforms it baked are stale (the
        # reference's BLAS/TLAS refresh, Renderer.cpp:2001-2007).
        if s.get("enableVoxelRT", False) or \
                s.get("enableVoxelFallback", False):
            mats, _n, _b, _v = self._bridge.snapshot_objects()
            lights, _, _ = self._bridge.snapshot_lights()
            vh = hash((lights.tobytes(), mats.tobytes(),
                       s.get("voxelResolution", 64)))
            if vh != self._voxel_hash:
                self._bridge.build_voxel_scene(n=s.get("voxelResolution", 64))
                self._voxel_hash = vh
                self._replace_buffers(
                    **self._bridge._voxel_fields(self.device))

    def render(self) -> Dict[str, Any]:
        """Run the frame function (reference Renderer::Render,
        Renderer.cpp:1935). Returns the output dict of tensors; on the card
        its work may still be running."""
        assert self._buffers is not None, "call update() first"
        config = self.current_config()
        if self._temporal is None:
            self._temporal = TemporalState(config, device=self.device)
        temporal = self._temporal
        temporal.config = config
        temporal.params = self._frame_params()
        camera = objects = lights = None
        if self._overlap is not None:
            # Overlap mode: the NEXT frame's propagation may be running on
            # the worker — use what it captured at commit time instead of
            # reading the live world.
            camera, objects, lights = self._overlap
        view, params, kwargs = temporal.inputs(
            self.scene, self._bridge, camera=camera, objects=objects,
            lights=lights)
        frame_fn = self._programs.get(config)
        self._splice_ticks(config)
        with self.telemetry.stage("dispatch"):
            out = frame_fn(self._buffers, view, params, **kwargs)
        self._submit_ticks(config, out)
        self.telemetry.record_frame_outputs(out)
        self.telemetry.end_frame()
        temporal.carry(out)
        return out

    # -- streaming feedback ticks -------------------------------------------
    def _splice_ticks(self, config: FrameConfig) -> None:
        """Splice the tables of each COMPLETED feedback tick into the scene
        buffers (a tick that loaded nothing returns None; a failed tick
        raises here, as fut.result() does in the JAX package)."""
        if config.enable_texture_streaming and self._tex_future is not None \
                and self._tex_future.done():
            fut, self._tex_future = self._tex_future, None
            res = fut.result()
            if res is not None:
                self._replace_buffers(tex_strips=res[0], tex_flags=res[1])
        if config.enable_streaming and self._stream_future is not None \
                and self._stream_future.done():
            fut, self._stream_future = self._stream_future, None
            res = fut.result()
            if res is not None:
                sv, sdq, gs, gr = res
                self._replace_buffers(cluster_verts=sv, cluster_dequant=sdq,
                                      geom_slot=gs, group_resident=gr)

    def _submit_ticks(self, config: FrameConfig, out) -> None:
        """Start a feedback tick per streamer with none in flight: the
        frame's feedback is copied to the host without blocking this
        thread, and the streamer's update runs on the readback worker
        (ticks land every ~copy-latency frames, the reference's
        frames-in-flight feedback cadence, CLodStreamingSystem.cpp:
        1091-1195)."""
        if self._feedback is None:
            self._feedback = ReadbackManager(max_in_flight=2)
        if config.enable_streaming and self._streamer is not None \
                and self._stream_future is None \
                and out.get("touched_groups") is not None:
            self._stream_future = self._feedback.request(
                out["touched_groups"], post=self._stream_tick)
        if config.enable_texture_streaming and self._tex_streamer is not None \
                and self._tex_future is None \
                and out.get("tex_wanted") is not None:
            self._tex_future = self._feedback.request(
                out["tex_wanted"], post=self._tex_tick)

    def _stream_tick(self, touched: np.ndarray):
        """Worker-side geometry tick: the page pool's update; new device
        tables only when residency changed."""
        st = self._streamer
        loads0, ev0 = st.loads, st.evictions
        res = st.update(touched)
        if st.loads == loads0 and st.evictions == ev0:
            return None
        return res

    def _tex_tick(self, wanted: np.ndarray):
        st = self._tex_streamer
        loads0 = st.loads
        res = st.update(wanted)
        if st.loads == loads0:
            return None
        return res

    def render_to_numpy(self) -> np.ndarray:
        """Render + sync: returns the (H, W, 3) uint8 image."""
        return self.render()["image"].cpu().numpy()

    def render_async(self, keys=("image",)):
        """Render + async readback (reference: ReadbackManager's fenced
        path): queues the frame, stages the device-to-host copies, and
        returns a concurrent.futures.Future resolving to {key: np.ndarray}
        on the readback worker — the caller's thread never blocks on the
        fetch. At most 3 readbacks are in flight (frames-in-flight
        backpressure); results resolve in request order."""
        out = self.render()
        if self._readback is None:
            from .utils.readback import ReadbackManager
            self._readback = ReadbackManager(max_in_flight=3)
        return self._readback.request({k: out[k] for k in keys if k in out})

    def _frame_params(self) -> FrameParams:
        s = self.settings

        def f(name):
            return torch.tensor(float(s.get(name)), dtype=torch.float32,
                                device=self.device)
        return FrameParams(
            exposure=f("exposure"), bloom_intensity=f("bloomIntensity"),
            bloom_threshold=f("bloomThreshold"),
            ibl_intensity=f("iblIntensity"), shadow_bias=f("shadowBias"),
            sky_intensity=f("skyIntensity"), taa_blend=f("taaBlend"),
            gtao_radius=f("gtaoRadius"), gtao_intensity=f("gtaoIntensity"),
            clod_error_px=f("clodErrorPx"),
            frame_index=torch.tensor(0, dtype=torch.int32,
                                     device=self.device),
            light_size=float(s.get("lightSize", 0.03)),
        )
