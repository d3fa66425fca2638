"""A one-off check of ROADMAP Queue 3's F2 (the city's geometry streaming
never settles): bench.py's streaming row (`_bench_streaming`: the city,
its capacities and settings, a 6144-page pool) through the JAX package's
Renderer and through the port's (device="cpu"), at a small render size,
with synchronous feedback ticks: after each frame the script waits for
that frame's tick to finish (it reads the Renderers' private
`_stream_future` and `_streamer`), so the next frame splices it, in both
packages. Prints the page loads and evictions after each tick of each
package and whether they agree. Minutes of CPU, from the repo's root:

    python -m tools.f2_streaming_ticks [frames [width height]]
"""

import importlib
import sys
import time

import numpy as np

SETTINGS = dict(tileSize=(32, 128), maxTrianglePairs=1 << 18,
                enableClod=True, maxVisibleClusters=3072,
                enableClusteredLighting=True, enableOcclusionCulling=True,
                enableIBL=True, enableTextures=True, enableVSM=True,
                enableGTAO=True, enableBloom=True, enableTAA=True,
                enableAutoExposure=True, enableSSR=True,
                enableStreaming=True, streamingSlots=6144)   # bench.py:113-133
CAPS = dict(max_vertices=1 << 22, max_triangles=1 << 22, max_objects=512,
            max_materials=64, max_lights=1024 + 8, max_clusters=1 << 16,
            max_geom_clusters=1 << 15, max_groups=1 << 13)  # bench.py:103-106


def ticks(root, frames, size):
    """[(loads, evictions, resident groups)] after each synchronous tick
    of `root`'s Renderer over the city."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    caps = mod("scene.bridge").BridgeCapacities(**CAPS)
    kw = {"device": "cpu"} if root.endswith("_torch") else {}
    r = mod("renderer").Renderer(caps=caps, **kw)
    built = mod("models.city").load_city(
        lod=True, textures=r.textures, num_point_lights=1000 - 12,
        registries=(r.meshes, r.materials, r.skeletons))
    for k, v in dict(SETTINGS, renderResolution=size).items():
        r.settings.set(k, v)
    r.set_current_scene(built.scene)
    out = []
    for _ in range(frames):
        r.update()
        r.render()
        if r._stream_future is not None:
            r._stream_future.result()    # the tick ends before the next frame
        st = r._streamer
        out.append((int(st.loads), int(st.evictions),
                    int(st.resident_groups)))
    return out


def main(argv):
    frames = int(argv[0]) if argv else 60
    size = (int(argv[1]), int(argv[2])) if len(argv) > 2 else (256, 128)
    import jax
    jax.config.update("jax_platforms", "cpu")
    runs = {}
    for root in ("basicrenderer_tpu", "basicrenderer_tpu_torch"):
        t0 = time.perf_counter()
        runs[root] = ticks(root, frames, size)
        print(f"{root}: {frames} frames at {size[0]}x{size[1]} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    j, p = runs["basicrenderer_tpu"], runs["basicrenderer_tpu_torch"]
    for i, (a, b) in enumerate(zip(j, p)):
        print(f"tick {i}: jax loads/evictions/resident {a}, port {b}"
              + ("" if a == b else "  DIFFER"))
    loads = [x[0] for x in p]
    quiet = next((i for i in range(12, len(loads))
                  if loads[i] == loads[i - 12]), None)
    print(f"equal at every tick: {j == p}; port loads per tick "
          f"{np.diff([0] + loads).tolist()}; 12 ticks without a load "
          f"first ending at tick {quiet}")


if __name__ == "__main__":
    main(sys.argv[1:])
