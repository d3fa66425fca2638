"""The port's importers (models/importers.py, models/animation.py) against
the JAX package's.

The glTF and OBJ cases of tests/test_importers.py (the red triangle, the
fan-triangulated OBJ quad, the unknown format, the PNG-textured quad), a
skinned and animated glTF (matrix and TRS nodes, a two-joint skin,
LINEAR / STEP / CUBICSPLINE channels, KHR material extensions) and
bench.py's city (assets/city.glb, without the LOD build) are imported by
both packages from the same file. Mesh arrays, material fields, texture
ids, registry layers (images, flags, alpha cutoffs, strip pyramids),
skeletons, clips and their samples, and every entity's components must be
equal: both packages run the same numpy code. The other formats are
held to the JAX package in tests/test_torch_formats.py, through the same
helpers.
"""

import base64
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from tests.test_importers import _write_textured_gltf, _write_triangle_gltf

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITY = os.path.join(REPO, "assets", "city.glb")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _import(root, path, tex_res=None):
    """Import `path` through `root`'s load_model into fresh registries:
    (scene, meshes, materials, skeletons, textures, load_model's result)."""
    sc = _mod(root, "scene.scene").Scene()
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    skel = _mod(root, "models.animation").SkeletonRegistry()
    tex = (_mod(root, "models.textures").TextureRegistry(resolution=tex_res)
           if tex_res else None)
    out = _mod(root, "models.importers").load_model(path, sc, meshes, mats,
                                                    skel, textures=tex)
    sc.propagate_transforms()
    return sc, meshes, mats, skel, tex, out


def _equal(a, b, what):
    """Field-by-field equality of two dataclass instances (or values) from
    the two packages."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{k}]")
    elif type(a).__module__.startswith(JAX_PKG):      # a plain class
        assert type(a).__name__ == type(b).__name__, what
        _equal(sorted(vars(a).items()), sorted(vars(b).items()), what)
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def _worlds_equal(jsc, psc):
    """Every component store of the two scenes' worlds: the same entities
    with equal values, and the same tags."""
    jst = {t.__name__: s for t, s in jsc.world._stores.items()}
    pst = {t.__name__: s for t, s in psc.world._stores.items()}
    assert set(jst) == set(pst)
    for name in jst:
        assert set(jst[name]) == set(pst[name]), name
        for eid in jst[name]:
            _equal(jst[name][eid], pst[name][eid], f"{name}[{eid}]")
    assert jsc.world._tags == psc.world._tags


def _assert_imports_equal(j, p):
    jsc, jm, jmat, jsk, jtex, jout = j
    psc, pm, pmat, psk, ptex, pout = p
    _equal(jm.meshes, pm.meshes, "meshes")
    _equal(jmat.materials, pmat.materials, "materials")
    _equal(jsk.skeletons, psk.skeletons, "skeletons")
    assert sorted(jsk.clips) == sorted(psk.clips)
    for k in jsk.clips:
        _equal(jsk.clips[k], psk.clips[k], f"clips[{k}]")
    _worlds_equal(jsc, psc)
    if isinstance(jout, dict):
        assert jout["nodes"] == pout["nodes"]
        _equal(jout["clips"], pout["clips"], "result clips")
    else:
        assert jout == pout
    if jtex is not None:
        _equal(jtex.images, ptex.images, "texture images")
        assert jtex.srgb == ptex.srgb
        assert jtex.alpha_cutoffs == ptex.alpha_cutoffs
        for fmt in ("rgba8", "bc3"):
            _equal(jtex.strip_pyramid(fmt=fmt), ptex.strip_pyramid(fmt=fmt),
                   f"strip pyramid {fmt}")


def _write_quad_obj(path, normals=True):
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n")
        if normals:
            f.write("vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n")
        else:
            f.write("f 1/1 2/2 3/3 4/4\n")


def _write_skinned_gltf(path):
    """Two joints under a matrix root, a skinned quad strip with JOINTS_0
    / WEIGHTS_0, and one animation with a LINEAR rotation, a STEP
    translation and a CUBICSPLINE scale channel; a material with the KHR
    transmission, volume, IOR, clearcoat and sheen extensions."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                    [0, 2, 0], [1, 2, 0]], np.float32)
    joints = np.array([[0, 0, 0, 0]] * 2 + [[0, 1, 0, 0]] * 2
                      + [[1, 0, 0, 0]] * 2, np.uint8)
    weights = np.array([[1, 0, 0, 0]] * 2 + [[0.5, 0.5, 0, 0]] * 2
                       + [[1, 0, 0, 0]] * 2, np.float32)
    idx = np.array([0, 1, 2, 2, 1, 3, 2, 3, 4, 4, 3, 5], np.uint16)
    inv_bind = np.stack([np.eye(4, dtype=np.float32),
                         np.eye(4, dtype=np.float32)])
    inv_bind[1, 3, 1] = -1.0            # column-major: translation (0, -1, 0)
    t_rot = np.array([0.0, 0.5, 1.0], np.float32)
    v_rot = np.array([[0, 0, 0, 1], [0, 0, 0.3826834, 0.9238795],
                      [0, 0, 0.7071068, 0.7071068]], np.float32)
    t_step = np.array([0.0, 0.6], np.float32)
    v_step = np.array([[0, 1, 0], [0.2, 1.1, 0]], np.float32)
    t_cub = np.array([0.0, 1.0], np.float32)
    v_cub = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0, 0],
                      [0, 0.5, 0], [1.5, 1.2, 1], [0, 0, 0]], np.float32)
    arrays = [pos, joints, weights, idx, inv_bind.reshape(2, 16), t_rot,
              v_rot, t_step, v_step, t_cub, v_cub]
    blob, views = b"", []
    for a in arrays:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        blob += a.tobytes()
        blob += b"\0" * (-len(blob) % 4)
    acc = [
        (5126, 6, "VEC3"), (5121, 6, "VEC4"), (5126, 6, "VEC4"),
        (5123, 12, "SCALAR"), (5126, 2, "MAT4"), (5126, 3, "SCALAR"),
        (5126, 3, "VEC4"), (5126, 2, "SCALAR"), (5126, 2, "VEC3"),
        (5126, 2, "SCALAR"), (5126, 6, "VEC3")]
    root = np.eye(4, dtype=np.float32)
    root[:3, :3] = [[0, -2, 0], [2, 0, 0], [0, 0, 2]]   # rot 90 about z, x2
    root[:3, 3] = [0.5, -1.0, 2.0]
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"name": "root", "matrix": root.T.reshape(-1).tolist(),
             "children": [1, 3]},
            {"name": "hip", "translation": [0, 0, 0], "children": [2]},
            {"name": "knee", "translation": [0, 1, 0],
             "rotation": [0, 0, 0.0998334, 0.9950042], "scale": [1, 1.5, 1]},
            {"name": "body", "mesh": 0, "skin": 0}],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": 4}],
        "meshes": [{"name": "strip", "primitives": [{
            "attributes": {"POSITION": 0, "JOINTS_0": 1, "WEIGHTS_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{
            "name": "coated", "doubleSided": True,
            "pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 1],
                                     "metallicFactor": 0.3,
                                     "roughnessFactor": 0.45},
            "emissiveFactor": [0.1, 0, 0.05],
            "extensions": {
                "KHR_materials_ior": {"ior": 1.33},
                "KHR_materials_transmission": {"transmissionFactor": 0.7},
                "KHR_materials_volume": {"attenuationColor": [0.9, 0.8, 0.7],
                                         "attenuationDistance": 2.5},
                "KHR_materials_clearcoat": {"clearcoatFactor": 0.6,
                                            "clearcoatRoughnessFactor": 0.1},
                "KHR_materials_sheen": {"sheenColorFactor": [0.3, 0.2, 0.1],
                                        "sheenRoughnessFactor": 0.4}}}],
        "animations": [{"name": "bend", "samplers": [
            {"input": 5, "output": 6, "interpolation": "LINEAR"},
            {"input": 7, "output": 8, "interpolation": "STEP"},
            {"input": 9, "output": 10, "interpolation": "CUBICSPLINE"}],
            "channels": [
                {"sampler": 0, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 2, "path": "translation"}},
                {"sampler": 2, "target": {"node": 1, "path": "scale"}},
                {"sampler": 0, "target": {"node": 3, "path": "rotation"}}]}],
        "accessors": [{"bufferView": k, "componentType": c, "count": n,
                       "type": t} for k, (c, n, t) in enumerate(acc)],
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
    }
    with open(path, "w") as f:
        json.dump(gltf, f)


@pytest.mark.parametrize("case", ["triangle", "textured", "skinned",
                                  "obj", "obj_no_normals"])
def test_small_imports_match_jax(tmp_path, case):
    if case == "triangle":
        path = str(tmp_path / "tri.gltf")
        _write_triangle_gltf(path)
    elif case == "textured":
        path = str(tmp_path / "texquad.gltf")
        _write_textured_gltf(path)
    elif case == "skinned":
        path = str(tmp_path / "skinned.gltf")
        _write_skinned_gltf(path)
    else:
        path = str(tmp_path / "quad.obj")
        _write_quad_obj(path, normals=case == "obj")
    tex_res = 8 if case == "textured" else None
    j = _import(JAX_PKG, path, tex_res)
    p = _import(PORT_PKG, path, tex_res)
    _assert_imports_equal(j, p)
    meshes, mats, tex = p[1], p[2], p[4]
    if case == "triangle":
        assert len(meshes) == 1 and len(mats) == 2
        m = mats.get(1)
        assert abs(m.base_color[0] - 0.9) < 1e-6 and m.roughness == 0.9
    elif case == "textured":
        assert len(tex) == 1 and mats.get(1).base_color_texture == 0
        assert tex.srgb[0] is True
        img = tex.images[0]
        assert img[4, 1, 0] > 0.9 and img[4, 1, 2] < 0.1
        assert img[4, 6, 2] > 0.9 and img[4, 6, 0] < 0.1
    elif case.startswith("obj"):
        mesh = meshes.get(0)
        assert mesh.num_triangles == 2
        assert np.allclose(np.abs(mesh.normals[:, 2]), 1.0)


def test_skinned_clip_samples_match_jax(tmp_path):
    """The imported clip sampled through each package's animation module
    (slerp, step, cubic Hermite, TRS composition, palettes, blends and a
    cross-fade) at times inside, between and past the keys."""
    path = str(tmp_path / "skinned.gltf")
    _write_skinned_gltf(path)
    (_, _, _, jsk, _, jout), (_, _, _, psk, _, pout) = (
        _import(JAX_PKG, path), _import(PORT_PKG, path))
    assert len(pout["clips"]) == 1 and len(pout["clips"][0].channels) == 3
    jclip, pclip = jout["clips"][0], pout["clips"][0]
    jsk0, psk0 = jsk.skeletons[0], psk.skeletons[0]
    assert pclip.duration == jclip.duration == 1.0
    for t in (0.0, 0.2, 0.5, 0.6, 0.77, 1.0, 1.3):
        for a, b in zip(jclip.sample_trs(jsk0, t), pclip.sample_trs(psk0, t)):
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-7)
        np.testing.assert_allclose(pclip.skinning_palette(psk0, t),
                                   jclip.skinning_palette(jsk0, t),
                                   rtol=0, atol=1e-6)
    ja, pa = (_mod(r, "models.animation") for r in (JAX_PKG, PORT_PKG))
    np.testing.assert_allclose(pa.rest_palette(psk0), ja.rest_palette(jsk0),
                               rtol=0, atol=1e-6)
    for reg in (jsk, psk):
        reg.add_clip(0, reg.clips[0][0])
        reg.play(0, 0, t0=0.0)
        reg.play(0, 1, t0=0.4, fade=0.5)
    np.testing.assert_allclose(psk.palette(0, 0.6), jsk.palette(0, 0.6),
                               rtol=0, atol=1e-6)
    for reg in (jsk, psk):
        reg.set_blend(0, 0, 1, 0.3)
    np.testing.assert_allclose(psk.palette(0, 0.45), jsk.palette(0, 0.45),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def city_imports():
    """assets/city.glb through both importers, textures at bench.py's 256."""
    return _import(JAX_PKG, CITY, 256), _import(PORT_PKG, CITY, 256)


def test_city_import_matches_jax(city_imports):
    j, p = city_imports
    _assert_imports_equal(j, p)
    meshes, mats, tex = p[1], p[2], p[4]
    assert len(meshes) == 24 and len(mats) == 12      # 11 + the default
    assert len(tex) == 10
    assert sum(len(m.indices) for m in meshes.meshes) == 905_572
    leaf = [m for m in mats.materials if m.name == "leaf"][0]
    assert leaf.alpha_cutoff == 0.5 and leaf.double_sided
    assert tex.alpha_cutoffs[leaf.base_color_texture] == 0.5
    assert sum(c >= 0 for c in tex.alpha_cutoffs) == 1


def test_city_scene_matches_jax():
    """load_city without the LOD build: the same scene, lights and camera,
    and 2,438,472 instanced triangles, in both packages."""
    jb = _mod(JAX_PKG, "models.city").load_city(lod=False, textures=None,
                                                 num_point_lights=988)
    pb = _mod(PORT_PKG, "models.city").load_city(lod=False, textures=None,
                                                  num_point_lights=988)
    assert pb.num_triangles == jb.num_triangles == 2_438_472
    _equal(jb.meshes.meshes, pb.meshes.meshes, "meshes")
    _equal(jb.materials.materials, pb.materials.materials, "materials")
    _worlds_equal(jb.scene, pb.scene)


def test_unknown_format_raises(tmp_path):
    p = str(tmp_path / "x.xyz123")
    open(p, "w").write("")
    with pytest.raises(ValueError, match="unsupported"):
        _import(PORT_PKG, p)
