"""Offline cluster-LOD cache builder CLI.

Port of basicrenderer_tpu/tools/clod_cache.py (reference: the
CLodCacheTool offline executable, BasicRenderer/CLodCacheTool/main.cpp —
pre-builds CLod artifacts so app startup skips the expensive QEM
pipeline), over the port's cache (models/clusters.CACHE_DIR, under the
package's `_build/`). Usage:

    python -m basicrenderer_tpu_torch.tools.clod_cache build a.glb b.obj ...
    python -m basicrenderer_tpu_torch.tools.clod_cache info

`build` loads each model with the port's importer, runs the native LOD
builder on every mesh, and leaves the content-hash .npz artifacts in the
cache directory; a later Renderer run loads them instantly. `info` lists
the cache.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _build(paths):
    from ..models import clusters
    from ..models.animation import SkeletonRegistry
    from ..models.importers import load_model
    from ..models.materials import MaterialRegistry
    from ..models.mesh import MeshRegistry
    from ..models.textures import TextureRegistry
    from ..scene.scene import Scene

    total = 0
    for path in paths:
        meshes = MeshRegistry()
        mats = MaterialRegistry()
        sc = Scene()
        load_model(path, sc, meshes, mats, skeletons=SkeletonRegistry(),
                   textures=TextureRegistry())
        for i, mesh in enumerate(meshes.meshes):
            t0 = time.time()
            cl = clusters.build_cluster_lod(mesh)
            total += 1
            print(f"{path}[{i}] {mesh.name or 'mesh'}: "
                  f"{mesh.num_triangles} tris -> {cl.num_clusters} clusters"
                  f" / {cl.num_levels} levels ({time.time() - t0:.1f}s)",
                  flush=True)
    print(f"built {total} LOD artifact(s) into {clusters.CACHE_DIR}")


def _info():
    from ..models import clusters
    d = clusters.CACHE_DIR
    if not os.path.isdir(d):
        print(f"cache empty ({d})")
        return
    files = sorted(os.listdir(d))
    total = 0
    for f in files:
        p = os.path.join(d, f)
        sz = os.path.getsize(p)
        total += sz
        print(f"{f}  {sz / 1e6:.1f} MB")
    print(f"{len(files)} artifact(s), {total / 1e6:.1f} MB "
          f"(schema v{clusters.CACHE_SCHEMA})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="clod_cache")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="pre-build LOD artifacts for models")
    b.add_argument("models", nargs="+")
    sub.add_parser("info", help="list the cache")
    args = ap.parse_args(argv)
    if args.cmd == "build":
        _build(args.models)
    else:
        _info()
    return 0


if __name__ == "__main__":
    sys.exit(main())
