"""The port imports torch and never jax, directly or through another
module: import every module of basicrenderer_tpu_torch in a fresh
interpreter and check that no jax module and no module of the JAX package
was loaded; and the scripts that drive it on the card import neither jax
nor the JAX package."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import basicrenderer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))),
                  "jax_package": sorted(m for m in sys.modules
                                        if m.split(".")[0] == "basicrenderer_tpu"),
                  "tf32": [__import__("torch").backends.cuda.matmul.allow_tf32,
                           __import__("torch").backends.cudnn.allow_tf32]}))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for mod in ("graph.frame", "graph.framedata", "graph.temporal", "ops.raster",
                "ops.raster_setup", "ops.shade", "ops.culling", "ops.clod",
                "ops.lighting", "ops.textures", "ops.shadows", "ops.post",
                "ops.motion", "ops.taa_warp", "ops.ssr", "ops.ibl",
                "models.environment", "models.texprocess", "ops.vsm",
                "ops.oit", "ops.resolve",
                "models.clusters", "models.pageblob", "models.scenes",
                "models.textures", "scene.bridge", "interop",
                "utils.cuda_build", "models.importers", "models.city",
                "models.animation", "utils.taskpool", "ops.reyes",
                "renderer", "utils.settings", "utils.telemetry",
                "utils.readback", "utils.profiling", "utils.camera",
                "utils.input", "utils.ui_server", "utils.png",
                "tools.clod_cache", "tools.showcase", "models.streaming",
                "models.texstream", "models.voxels", "ops.voxel_rt",
                "ops.rt_reflect", "ops.skinning", "models.crate_codec",
                "models.usdc", "models.usd", "models.fbx", "models.nif",
                "models.meshformats", "utils.http_resolver",
                "tools.format_fixtures", "parallel.tile_sharding"):
        assert f"basicrenderer_tpu_torch.{mod}" in out["modules"], mod
    assert out["jax"] == []
    assert out["jax_package"] == []
    assert out["tf32"] == [False, False]


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/checkout_turns.py"])
def test_card_scripts_never_import_jax(script):
    """The card scripts import neither jax nor the JAX package, at top
    level or inside a function (they import inside functions so that a
    missing card fails before any import)."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    roots = {name.split(".")[0] for name in names}
    assert "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "basicrenderer_tpu"}, roots
