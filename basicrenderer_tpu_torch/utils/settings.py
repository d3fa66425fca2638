"""Typed runtime settings registry with change subscriptions.

Host-only copy of basicrenderer_tpu/utils/settings.py (the reference's
SettingsManager, BasicRenderer/include/Managers/Singletons/
SettingsManager.h:13-90, and the ~120 `registerSetting` calls in
Renderer.cpp:1108-1463); the catalog is the JAX package's, name for name.

Settings that change the frame *structure* (pass toggles, capacities,
resolutions) are structural: changing one bumps `generation`, and the
Renderer builds a new FrameConfig and frame function (the reference's
render-graph rebuild on toggle, Renderer.cpp:1794-1800). Settings that
only change *values* (exposure, light intensity) flow into FrameParams
and never rebuild anything. Each setting declares which kind it is.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Setting:
    name: str
    value: Any
    dtype: type
    structural: bool  # True -> a new FrameConfig on change
    description: str = ""


class SettingsManager:
    """Thread-safe typed key/value registry with subscriptions."""

    def __init__(self):
        self._settings: Dict[str, Setting] = {}
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}
        self._lock = threading.RLock()
        self._generation = 0  # bumps on structural changes

    # -- registration ------------------------------------------------------
    def register(self, name: str, default: Any, *, structural: bool = False,
                 description: str = "") -> None:
        with self._lock:
            if name in self._settings:
                return
            self._settings[name] = Setting(name, default, type(default), structural, description)

    def registered(self, name: str) -> bool:
        return name in self._settings

    # -- access ------------------------------------------------------------
    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            s = self._settings.get(name)
            return s.value if s is not None else default

    def __getitem__(self, name: str) -> Any:
        return self._settings[name].value

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            s = self._settings.get(name)
            if s is None:
                # The reference's typed registry rejects unknown keys at the
                # template layer (SettingsManager.h:13-90); auto-registering
                # here silently creates dead settings on typos.
                raise KeyError(
                    f"unknown setting {name!r} — settings must be declared "
                    f"with register() before set()")
            if s.value == value:
                return
            s.value = value
            if s.structural:
                self._generation += 1
            for cb in self._subs.get(name, []):
                cb(value)

    def subscribe(self, name: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(name, []).append(callback)

    @property
    def generation(self) -> int:
        """Monotone counter of structural changes; the renderer compares this
        against the generation its compiled frame program was built at."""
        return self._generation

    # -- structural snapshot ----------------------------------------------
    def structural_key(self) -> tuple:
        """Hashable tuple of all structural settings (what a FrameConfig is
        built from)."""
        with self._lock:
            return tuple(sorted(
                (s.name, s.value) for s in self._settings.values() if s.structural
            ))

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {k: s.value for k, s in self._settings.items()}

    # -- persistence (reference keeps settings live-editable via the UI;
    #    we expose JSON load/save for headless configs) --------------------
    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    def load_json(self, path: str) -> None:
        import logging
        with open(path) as f:
            for k, v in json.load(f).items():
                if not self.registered(k):
                    # Stale keys from older configs must not resurrect as
                    # dead settings — skip loudly instead.
                    logging.getLogger(__name__).warning(
                        "settings: skipping unknown key %r from %s", k, path)
                    continue
                self.set(k, v)


def make_default_settings() -> SettingsManager:
    """Registers the renderer's settings catalog: the JAX package's, the
    subset of the reference's ~120 settings that its frame program has
    (reference: Renderer.cpp:1108-1463). Settings of passes the port does
    not have yet are registered too; the Renderer refuses them when on."""
    s = SettingsManager()
    # Structural (recompile frame program on change)
    s.register("renderResolution", (1280, 720), structural=True)
    s.register("outputResolution", (1280, 720), structural=True)
    s.register("tileSize", (32, 128), structural=True,
               description="raster framebuffer tile (rows, cols); cols=128 matches TPU lanes")
    s.register("enableShadows", True, structural=True)
    s.register("enableVSM", False, structural=True, description="virtual shadow maps")
    s.register("vsmNumLights", 1, structural=True,
               description="VSM'd directional lights (independent caches)")
    s.register("vsmFilterTaps", 1, structural=True,
               description="1=point, 4=2x2 bilinear visibility filter")
    s.register("vsmRays", 0, structural=True,
               description="SMRT rays (0=off); penumbrae via params.light_size")
    s.register("vsmRaySamples", 3, structural=True,
               description="march samples per SMRT ray")
    s.register("vsmSlots", 128, structural=True,
               description="physical VSM pages in the pool")
    s.register("vsmLevels", 6, structural=True,
               description="VSM clipmap levels")
    s.register("numShadowCascades", 4, structural=True)
    s.register("shadowResolution", 1024, structural=True)
    s.register("enableClusteredLighting", True, structural=True)
    # (the reference's froxel grid was redesigned into per-raster-tile
    # light lists — see ops/lighting.py; no grid setting exists)
    s.register("maxLightsPerCluster", 64, structural=True)
    s.register("enableIBL", True, structural=True)
    s.register("enableTextures", False, structural=True)
    s.register("enableGTAO", False, structural=True)
    s.register("enableSSR", False, structural=True)
    s.register("enableRTReflections", False, structural=True,
               description="triangle-accurate ray-traced reflections over "
                           "the resident cluster cut (SSR-miss consumer; "
                           "reference: CLodRayTracingSystem)")
    s.register("enableVoxelRT", False, structural=True,
               description="ray-traced reflection fallback over the scene "
                           "voxel pyramid (SSR-miss consumer; reference: "
                           "CLodRayTracingSystem)")
    s.register("enableVoxelFallback", False, structural=True,
               description="voxel LOD fallback: march primary rays where "
                           "the cut/residency left holes (reference: "
                           "VoxelGroupBuilder)")
    s.register("voxelResolution", 64, structural=True,
               description="voxel pyramid level-0 edge cells")
    s.register("voxelSGGX", False, structural=True,
               description="anisotropic SGGX occlusion in voxel cone traces")
    s.register("textureFormat", "rgba8", structural=True,
               description="atlas-at-rest format: rgba8 | bc3 (BC3 "
                           "blocks, 4x smaller; decoded in the sampler)")
    s.register("enableTextureStreaming", False, structural=True,
               description="mip-granular texture residency streamed from "
                           "a disk container by sampler feedback")
    s.register("textureStreamContainer", "", structural=True)
    s.register("textureFineRowBudget", 1 << 14, structural=True)
    s.register("enableReyes", False, structural=True,
               description="Reyes micro-tessellation: dice + displace "
                           "large near triangles (reference: Reyes*.cpp)")
    s.register("reyesTriBudget", 512, structural=True)
    s.register("reyesDiceRate", 4, structural=True,
               description="micro-grid subdivisions per parent edge")
    s.register("reyesPixelThreshold", 48.0, structural=True)
    s.register("reyesSplitBudget", 0, structural=True,
               description="split-stage parent budget (0 = dice only)")
    s.register("reyesSplitFactor", 4.0, structural=True,
               description="split threshold = factor * pixel threshold")
    s.register("enableSceneOverlap", False,
               description="pipeline scene sync on a worker thread: frame "
                           "N's transforms/snapshot run during frame N-1's "
                           "device work (reference: Renderer.cpp:597-741); "
                           "between-frame edits must use world.defer")
    s.register("enableEnergyCompensation", False, structural=True,
               description="Kulla-Conty GGX multi-scatter compensation via "
                           "the fitted directional-albedo polynomial "
                           "(ops/brdf_energy.py; reference: OpenPBR energy "
                           "LUTs, ShaderBuffers.h:139-361)")
    s.register("enableBloom", True, structural=True)
    s.register("enableTAA", False, structural=True)
    s.register("enableOIT", False, structural=True)
    s.register("maskPeels", 1, structural=True,
               description="alpha-MASK depth layers (2 = masked-behind-"
                           "masked)")
    s.register("vertexTangents", False, structural=True,
               description="mikktspace vertex tangent frames for normal "
                           "maps (exact on mirrored/atlased UVs)")
    s.register("oitLayers", 4, structural=True, description="K-buffer depth layers")
    s.register("enableAutoExposure", False, structural=True)
    s.register("enableSkinning", False, structural=True)
    s.register("enableFrustumCulling", True, structural=True)
    s.register("enableOcclusionCulling", False, structural=True,
               description="two-phase HZB occlusion culling (object granular)")
    # (the reference's per-meshlet AS cone/frustum culling has no separate
    # switch here: the cluster cut + frustum mask IS meshlet culling — see
    # ops/clod.select_cluster_cut)
    s.register("wireframe", False, structural=True,
               description="overlay triangle edges (vis-buffer edge detect)")
    s.register("debugView", "none", structural=True)
    s.register("enableClod", False, structural=True,
               description="cluster-LOD (virtualized geometry) cut selection")
    s.register("maxVisibleClusters", 2048, structural=True,
               description="visible-cluster list capacity (reference budget 30M, Renderer.cpp:2494)")
    s.register("maxTrianglePairs", 1 << 20, structural=True,
               description="tile-binning (tile,tri) pair capacity")
    s.register("upscaleMode", "none", structural=True, description="none|taa")
    s.register("enableStreaming", False, structural=True,
               description="geometry page streaming (models/streaming.py)")
    s.register("streamingPriorityMode", "max", structural=True,
               description="feedback priority aggregation: max | sum "
                           "(reference: CLodPriorityMode, "
                           "CLodCommon.h:50-53)")
    s.register("streamingSlots", 1024, structural=True,
               description="geometry page pool capacity")
    s.register("streamingContainer", "", structural=True,
               description="disk page-blob container path ('' = host RAM; "
                           "see models/pageblob.py)")
    # Value-only (traced; no recompile)
    s.register("exposure", 1.0)
    s.register("bloomIntensity", 0.04)
    s.register("bloomThreshold", 1.0)
    s.register("gtaoRadius", 0.5)
    s.register("gtaoIntensity", 1.0)
    s.register("shadowBias", 0.0015)
    s.register("iblIntensity", 1.0)
    s.register("taaBlend", 0.1)
    s.register("skyIntensity", 1.0)
    s.register("clodErrorPx", 1.0, description="LOD cut screen-space error (px)")
    s.register("lightSize", 0.03,
               description="sun angular-radius tangent (SMRT penumbra width)")
    return s
