"""The port's FBX, USD (USDA, USDC, USDZ), NIF, PLY, STL and DAE importers
and its USDC, USDZ and NIF writers against the JAX package's.

- Imports: every fixture of tests/test_fbx.py, test_usd.py, test_usdc.py,
  test_nif.py and test_meshformats.py (its PLY and STL bytes), the fixtures of
  basicrenderer_tpu_torch/tools/format_fixtures.py (the scenes
  chip_smoke.py renders on the card: a textured binary FBX, USDA, modern
  and legacy USDC, USDZ, a textured NIF, binary PLY and STL, DAE) and a
  few more forms (ASCII STL, a DAE polylist with a matrix node, a .usd of
  either kind, an ASCII layer in a USDZ), each imported by both packages'
  load_model from the same bytes: mesh arrays, material fields, texture
  ids and images, skeletons, clips and every entity's components equal
  (tests/test_torch_importers.py::_assert_imports_equal), and load_model's
  results equal.
- Readers: the crate prims of test_usdc.py's compressed and value-kind
  stages, the ASCII FBX trees and the de-stripped NIF strips are equal;
  the error paths (NIF garbage and version gate, a future crate, a .usdc
  that is no crate, a USDZ without a layer, an FBX without Objects, a
  file that is no PLY) raise the same exception type and message.
- Writers: save_usdc (modern and legacy), save_usdz, export_meshes_usdc
  and write_nif write the same bytes as the JAX package's for the same
  input, with the native LZ4 codec loaded on both sides.
- Routing: load_model sends a .usd crate to load_usdc and a .usd text to
  load_usda; utils/http_resolver passes a local path through, fetches a
  URL once (through a stubbed urlopen) and answers it from its cache after.
- One 128x128 soup frame of the USDC fixture scene in both packages: vis
  equal, image RMSE <= 1.0 (0-255).
"""

import importlib
import io
import os
import struct
import zipfile

import numpy as np
import jax
import pytest

from tests import test_fbx, test_nif, test_usd, test_usdc
from tests.test_torch_crate_codec import wait_for_jax_lz4
from tests.test_torch_importers import (JAX_PKG, PORT_PKG, _assert_imports_equal,
                                        _equal, _import, _mod)
from basicrenderer_tpu_torch.tools import format_fixtures as ff


# --------------------------------------------------------------------------
# Fixture writers: name -> (tmp_path -> (path, texture resolution or None))
# --------------------------------------------------------------------------

def _text(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p), None


def _bytes(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p), None


def _ascii_fbx(order):
    return test_fbx.ASCII_FBX7.replace("{MAT_A}", order[0]).replace(
        "{MAT_B}", order[1])


def _jax_usdc(tmp_path, name, **kw):
    from basicrenderer_tpu.models.usdc import save_usdc
    p = str(tmp_path / name)
    save_usdc(p, test_usdc._quad_prims(), **kw)
    return p, None


def _jax_usdz(tmp_path):
    from basicrenderer_tpu.models.usdc import save_usdz
    p = str(tmp_path / "scene.usdz")
    save_usdz(p, test_usdc._quad_prims())
    return p, None


def _usdz_ascii(tmp_path):
    p = str(tmp_path / "ascii.usdz")
    with zipfile.ZipFile(p, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr("stage.usda", test_usd.USDA)
    return p, None


def _jax_export(tmp_path):
    from basicrenderer_tpu.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu.models.mesh import MeshData, MeshRegistry
    from basicrenderer_tpu.models.usdc import export_meshes_usdc
    meshes, mats = MeshRegistry(), MaterialRegistry()
    meshes.add(MeshData(
        positions=np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        normals=np.asarray([[0, 0, 1]] * 3, np.float32),
        uvs=np.asarray([[0, 0], [1, 0], [0, 1]], np.float32),
        indices=np.asarray([[0, 1, 2]], np.int32)))
    mats.add(Material(base_color=np.asarray([0.2, 0.5, 0.7, 1], np.float32),
                      metallic=0.3, roughness=0.6,
                      emissive=np.asarray([0.1, 0, 0], np.float32)))
    M = np.eye(4)
    M[:3, 3] = [2.0, 0.5, -1.0]
    M[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    p = str(tmp_path / "export.usdc")
    export_meshes_usdc(p, meshes, mats, instances=[(0, 1, M), (0, 0, np.eye(4))])
    return p, None


def _nif(tmp_path, name, shapes, **kw):
    from basicrenderer_tpu.models.nif import write_nif
    p = str(tmp_path / name)
    write_nif(p, shapes, **kw)
    return p, None


def _quad_shape(**kw):
    v, t, n, uv = test_nif._quad()
    return dict(vertices=v, triangles=t, normals=n, uvs=uv, **kw)


def _ply_vertex_list():
    hdr = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
           b"property float x\nproperty float y\nproperty float z\n"
           b"property list uchar float texcoord\nelement face 1\n"
           b"property list uchar int vertex_indices\nend_header\n")
    body = b"".join(struct.pack("<fff", *p) + struct.pack("<B", 2)
                    + struct.pack("<ff", 0.5, 0.5)
                    for p in [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
    return hdr + body + struct.pack("<B", 3) + struct.pack("<iii", 0, 1, 2)


def _ply_face_extra_list():
    hdr = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
           b"property float x\nproperty float y\nproperty float z\n"
           b"element face 1\nproperty list uchar int vertex_indices\n"
           b"property list uchar float texcoord\nend_header\n")
    body = b"".join(struct.pack("<fff", *p)
                    for p in [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
    return (hdr + body + struct.pack("<B", 3) + struct.pack("<iii", 0, 1, 2)
            + struct.pack("<B", 6) + struct.pack("<6f", *([0.25] * 6)))


PLY_ASCII = ("ply\nformat ascii 1.0\nelement vertex 4\n"
             "property float x\nproperty float y\nproperty float z\n"
             "element face 1\nproperty list uchar int vertex_indices\n"
             "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
STL_BINARY = (b"\x00" * 80 + struct.pack("<I", 1)
              + struct.pack("<12f", 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0)
              + b"\x00\x00")
STL_ASCII = ("solid t\n facet normal 0 0 1\n  outer loop\n   vertex 0 0 0\n"
             "   vertex 1 0 0\n   vertex 0 1 0\n  endloop\n endfacet\n"
             " facet normal 0 0 1\n  outer loop\n   vertex 1 0 0\n"
             "   vertex 1 1 0\n   vertex 0 1 0\n  endloop\n endfacet\n"
             "endsolid t\n")
DAE_POLYLIST = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
<library_effects><effect id="fx"><profile_COMMON><technique sid="c"><phong>
<diffuse><color>0.2 0.6 0.3 1</color></diffuse></phong></technique>
</profile_COMMON></effect></library_effects>
<library_materials><material id="m" name="green"><instance_effect url="#fx"/>
</material></library_materials>
<library_geometries><geometry id="g"><mesh>
<source id="p"><float_array id="pa" count="15">0 0 0 1 0 0 1 1 0 0 1 0 0.5 1.5 0
</float_array><technique_common><accessor source="#pa" count="5" stride="3"/>
</technique_common></source>
<vertices id="v"><input semantic="POSITION" source="#p"/></vertices>
<polylist material="s" count="2"><input semantic="VERTEX" source="#v" offset="0"/>
<vcount>4 3</vcount><p>0 1 2 3 3 2 4</p></polylist></mesh></geometry>
</library_geometries>
<library_visual_scenes><visual_scene id="s1"><node name="outer">
<matrix>1 0 0 2 0 1 0 0 0 0 1 -1 0 0 0 1</matrix><node name="inner">
<scale>2 2 2</scale><rotate>0 0 1 45</rotate>
<instance_geometry url="#g"><bind_material><technique_common>
<instance_material symbol="s" target="#m"/></technique_common></bind_material>
</instance_geometry></node></node></visual_scene></library_visual_scenes>
</COLLADA>
"""


def _port_fixture(name, tex_res=None):
    def write(tmp_path):
        return ff.write_fixture(name, str(tmp_path)), tex_res
    return write


CASES = {
    "fbx_ascii": lambda t: _text(t, "scene.fbx", _ascii_fbx(("200", "201"))),
    "fbx_ascii_reordered": lambda t: _text(t, "scene.fbx",
                                           _ascii_fbx(("201", "200"))),
    "fbx_binary": lambda t: _bytes(t, "tri.fbx", test_fbx._build_binary_fbx()),
    "fbx_anim": lambda t: _text(t, "anim.fbx", test_fbx.ASCII_FBX_ANIM),
    "fbx_fixture": _port_fixture("fbx", 16),
    "usda": lambda t: _text(t, "scene.usda", test_usd.USDA),
    "usd_text": lambda t: _text(t, "scene.usd", test_usd.USDA),
    "usda_fixture": _port_fixture("usda"),
    "usdc_modern": lambda t: _jax_usdc(t, "scene.usdc"),
    "usdc_legacy": lambda t: _jax_usdc(t, "legacy.usdc", version=(0, 0, 1)),
    "usd_crate": lambda t: _jax_usdc(t, "crate.usd"),
    "usdz": _jax_usdz,
    "usdz_ascii": _usdz_ascii,
    "usdc_export": _jax_export,
    "usdc_fixture": _port_fixture("usdc"),
    "usdc_legacy_fixture": _port_fixture("usdc_legacy"),
    "usdz_fixture": _port_fixture("usdz"),
    "nif_roundtrip": lambda t: _nif(t, "m.nif", [_quad_shape(
        name="Quad", translation=(1, 2, 3), glossiness=500.0)]),
    "nif_unknown_block": lambda t: _nif(t, "u.nif", [_quad_shape(name="Quad")],
                                        extra_unknown_block=True),
    "nif_two_shapes": lambda t: _nif(t, "two.nif", [
        _quad_shape(name="A"),
        dict(_quad_shape(name="B", translation=(0, 5, 0)),
             vertices=test_nif._quad()[0] + 2.0)]),
    "nif_fixture": _port_fixture("nif", 16),
    "ply_vertex_list": lambda t: _bytes(t, "tri.ply", _ply_vertex_list()),
    "ply_face_extra_list": lambda t: _bytes(t, "tri2.ply",
                                            _ply_face_extra_list()),
    "ply_ascii": lambda t: _text(t, "quad.ply", PLY_ASCII),
    "ply_fixture": _port_fixture("ply"),
    "stl_binary": lambda t: _bytes(t, "t.stl", STL_BINARY),
    "stl_ascii": lambda t: _text(t, "a.stl", STL_ASCII),
    "stl_fixture": _port_fixture("stl"),
    "dae_fixture": _port_fixture("dae"),
    "dae_polylist": lambda t: _text(t, "poly.dae", DAE_POLYLIST),
}


def _equal_out(jout, pout):
    """load_model's results: entity lists, or dicts of them and clips."""
    if isinstance(jout, dict):
        assert sorted(jout) == sorted(pout)
        for k in jout:
            _equal(jout[k], pout[k], f"result {k}")
    else:
        assert jout == pout


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_jax(tmp_path, case):
    path, tex_res = CASES[case](tmp_path)
    j = _import(JAX_PKG, path, tex_res)
    p = _import(PORT_PKG, path, tex_res)
    _assert_imports_equal(j[:5] + (None,), p[:5] + (None,))
    _equal_out(j[5], p[5])
    meshes, mats, tex = p[1], p[2], p[4]
    assert len(meshes) >= 1 and all(m.num_triangles > 0
                                    for m in meshes.meshes)
    if tex_res:
        assert len(tex) == 1 and tex.srgb[0] is True
        assert sum(m.base_color_texture == 0 for m in mats.materials) == 1


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------

def _prims_equal(jprims, pprims):
    assert [(q.path, q.type_name) for q in jprims] == \
        [(q.path, q.type_name) for q in pprims]
    for a, b in zip(jprims, pprims):
        assert a.rels == b.rels, a.path
        assert sorted(a.attrs) == sorted(b.attrs), a.path
        for k, v in a.attrs.items():
            w = b.attrs[k]
            assert type(v) is type(w), (a.path, k)
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype, (a.path, k)
                np.testing.assert_array_equal(v, w, err_msg=f"{a.path}.{k}")
            else:
                assert v == w, (a.path, k)


def _compressed_prims(usdc):
    rng = np.random.default_rng(3)
    return [usdc.UsdPrim("/W", "Xform"), usdc.UsdPrim("/W/m", "Mesh", attrs={
        "faceVertexIndices": np.repeat(np.arange(300, dtype=np.int32), 3),
        "f_int": np.arange(100, dtype=np.float32),
        "f_lut": np.tile(np.asarray([0.25, 0.5, 1.0], np.float32), 40),
        "f_raw": rng.normal(size=64).astype(np.float32),
        "points": rng.normal(size=(32, 3)).astype(np.float32),
        "wide": np.arange(20, dtype=np.int64) * (1 << 33)})]


def _value_prims(usdc):
    return [usdc.UsdPrim("/P", "Xform", attrs={
        "f_inline": 0.25, "f_double": 0.1, "i_small": 7, "i_big": -3,
        "tok": "hello", "tokvec": ["a", "b", "c"], "flag": True,
        "arr1": np.asarray([1.5, 2.5], np.float32),
        "arr3": np.asarray([[1, 2, 3]], np.float32),
        "arri": np.asarray([4, 5, 6], np.int32)})]


def _convert(prims, root):
    """The same prims as `root`'s UsdPrim instances."""
    P = _mod(root, "models.usdc").UsdPrim
    return [P(q.path, q.type_name, attrs=dict(q.attrs), rels=dict(q.rels))
            for q in prims]


PRIM_SETS = {
    "quad": lambda u: _convert(test_usdc._quad_prims(), u.__name__.rsplit(
        ".", 2)[0]),
    "compressed": _compressed_prims,
    "values": _value_prims,
    "fixture": lambda u: _convert(ff.usd_prims(), u.__name__.rsplit(".", 2)[0]),
}


@pytest.mark.parametrize("version", [(0, 8, 0), (0, 0, 1)],
                         ids=["modern", "legacy"])
@pytest.mark.parametrize("prims", sorted(PRIM_SETS))
def test_crate_writer_and_reader_match_jax(tmp_path, prims, version):
    """The same prims written by each package's save_usdc: identical
    bytes; each package's read_usdc of them: equal prims."""
    wait_for_jax_lz4()
    data = []
    for root in (JAX_PKG, PORT_PKG):
        u = _mod(root, "models.usdc")
        p = str(tmp_path / f"{root}.usdc")
        u.save_usdc(p, PRIM_SETS[prims](u), version=version)
        data.append(open(p, "rb").read())
    assert data[0] == data[1]
    assert tuple(data[0][8:11]) == version
    jr, pr = (_mod(r, "models.usdc").read_usdc(data[0])
              for r in (JAX_PKG, PORT_PKG))
    _prims_equal(jr, pr)


def test_usdz_and_export_write_the_same_bytes(tmp_path, monkeypatch):
    wait_for_jax_lz4()
    monkeypatch.setattr(zipfile.time, "time", lambda: 1.7e9)  # zip dates
    out = {}
    for root in (JAX_PKG, PORT_PKG):
        u = _mod(root, "models.usdc")
        p = str(tmp_path / f"{root}.usdz")
        u.save_usdz(p, _convert(ff.usd_prims(), root))
        out[root, "usdz"] = open(p, "rb").read()
        meshes = _mod(root, "models.mesh").MeshRegistry()
        mats = _mod(root, "models.materials").MaterialRegistry()
        from tests.test_torch_importers import _write_triangle_gltf
        g = str(tmp_path / "tri.gltf")
        _write_triangle_gltf(g)
        sc = _mod(root, "scene.scene").Scene()
        _mod(root, "models.importers").load_model(g, sc, meshes, mats)
        meshes.add(_mod(root, "models.procedural").make_cube(0.5))
        p = str(tmp_path / f"{root}.usdc")
        u.export_meshes_usdc(p, meshes, mats, instances=[
            (0, 1, np.diag([2.0, 1, 1, 1])), (1, 0, np.eye(4)),
            (1, 1, np.eye(4) + np.eye(4, k=3))])
        out[root, "export"] = open(p, "rb").read()
    for kind in ("usdz", "export"):
        assert out[JAX_PKG, kind] == out[PORT_PKG, kind], kind
    with zipfile.ZipFile(io.BytesIO(out[PORT_PKG, "usdz"])) as z:
        assert z.namelist() == ["stage.usdc"]
        assert z.read("stage.usdc")[:8] == b"PXR-USDC"


NIF_WRITES = {
    "roundtrip": ([_quad_shape(name="Quad", translation=(1, 2, 3),
                               glossiness=500.0)], {}),
    "unknown_block": ([_quad_shape(name="Quad")],
                      dict(extra_unknown_block=True)),
    "two_shapes": ([_quad_shape(name="A"), _quad_shape(
        name="B", translation=(0, 5, 0), rotation=np.asarray(
            [[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32), scale=2.0,
        textures=["a.dds", "a_n.dds"], alpha=0.5,
        emissive=(0.1, 0.2, 0.3))], dict(root_name="Root")),
}


@pytest.mark.parametrize("case", sorted(NIF_WRITES) + ["fixture"])
def test_write_nif_writes_the_same_bytes(tmp_path, case):
    data = []
    for root in (JAX_PKG, PORT_PKG):
        p = str(tmp_path / f"{root}.nif")
        if case == "fixture":
            (tmp_path / root).mkdir()
            p = str(tmp_path / root / "fixture.nif")
            if root == PORT_PKG:
                ff.write_nif_fixture(p)
            else:
                from basicrenderer_tpu.models.nif import write_nif
                write_nif(p, [dict(name=n, vertices=v, triangles=i,
                                   normals=nn, uvs=uv, translation=off,
                                   glossiness=80.0,
                                   textures=(["checker.png", ""]
                                             if n == "ground" else []))
                              for n, v, nn, uv, i, off, _c in ff._shapes()])
        else:
            shapes, kw = NIF_WRITES[case]
            _mod(root, "models.nif").write_nif(p, shapes, **kw)
        data.append(open(p, "rb").read())
    assert data[0] == data[1]


def _fbx_trees_equal(a, b, where="root"):
    assert a.name == b.name, where
    assert len(a.props) == len(b.props), where
    for x, y in zip(a.props, b.props):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=where)
        else:
            assert type(x) is type(y) and x == y, where
    assert len(a.children) == len(b.children), where
    for k, (x, y) in enumerate(zip(a.children, b.children)):
        _fbx_trees_equal(x, y, f"{where}/{x.name}[{k}]")


@pytest.mark.parametrize("text", ["geometry", "anim"])
def test_fbx_ascii_parser_matches_jax(text):
    src = (_ascii_fbx(("200", "201")) if text == "geometry"
           else test_fbx.ASCII_FBX_ANIM)
    jt, pt = (_mod(r, "models.fbx")._read_ascii(src) for r in (JAX_PKG, PORT_PKG))
    _fbx_trees_equal(jt, pt)


def test_fbx_binary_parser_matches_jax(tmp_path):
    path = ff.write_fixture("fbx", str(tmp_path))
    data = open(path, "rb").read()
    (jt, jv), (pt, pv) = (_mod(r, "models.fbx")._read_binary(data)
                          for r in (JAX_PKG, PORT_PKG))
    assert jv == pv == 7400
    _fbx_trees_equal(jt, pt)


def test_nif_strips_match_jax():
    from basicrenderer_tpu_torch.models import nif as pnif
    w = pnif._W()
    w.i32(0)
    w.u16(4)
    w.u8(0)
    w.u8(0)
    w.u8(1)
    w.f32s(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                    np.float32).reshape(-1))
    w.u16(0)
    w.u32(0)
    w.u8(0)
    w.f32s(np.zeros(3, np.float32))
    w.f32(1.0)
    w.u8(0)
    w.u16(0)
    w.i32(-1)
    w.u16(2)
    w.u16(1)
    w.u16(6)
    w.u8(1)
    w.u16s(np.array([0, 1, 2, 3, 3, 3], np.uint16))
    jg, pg = (_mod(r, "models.nif")._read_tri_strips_data(
        _mod(r, "models.nif")._R(bytes(w.b)), []) for r in (JAX_PKG, PORT_PKG))
    np.testing.assert_array_equal(pg.triangles, [[0, 1, 2], [1, 3, 2]])
    _equal(jg, pg, "strips")


ERRORS = {
    "nif_garbage": ("bad.nif", b"not a nif at all\n\x00\x00"),
    "nif_version": ("old.nif", b"NetImmerse File Format, Version 4.0.0.2\n"
                    + (0x04000002).to_bytes(4, "little") + b"\x01"
                    + b"\x00" * 16),
    "usdc_future": ("new.usdc", b"PXR-USDC" + bytes([0, 10, 0]) + bytes(77)),
    "usdc_not_crate": ("text.usdc", b"#usda 1.0\n"),
    "usdz_no_layer": ("empty.usdz", None),
    "fbx_no_objects": ("empty.fbx", b"; FBX 7.4.0 project file\n"
                       b"FBXHeaderExtension:  {\n\tFBXVersion: 7400\n}\n"),
    "ply_garbage": ("bad.ply", b"not a ply\n"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_paths_match_jax(tmp_path, case):
    name, data = ERRORS[case]
    p = tmp_path / name
    if data is None:
        with zipfile.ZipFile(p, "w") as z:
            z.writestr("readme.txt", "no layer")
    else:
        p.write_bytes(data)
    errs = []
    for root in (JAX_PKG, PORT_PKG):
        with pytest.raises(Exception) as ei:
            _import(root, str(p))
        errs.append(ei.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert str(errs[0]) == str(errs[1])
    assert isinstance(errs[1], ValueError)


# --------------------------------------------------------------------------
# Routing and the resolver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["crate", "text"])
def test_usd_extension_is_sniffed(tmp_path, monkeypatch, kind):
    from basicrenderer_tpu_torch.models import usd, usdc
    called = []
    monkeypatch.setattr(usdc, "load_usdc",
                        lambda *a, **k: called.append("usdc") or [])
    monkeypatch.setattr(usd, "load_usda",
                        lambda *a, **k: called.append("usda") or [])
    path = (_jax_usdc(tmp_path, "s.usd")[0] if kind == "crate"
            else _text(tmp_path, "s.usd", test_usd.USDA)[0])
    _import(PORT_PKG, path)
    assert called == ["usdc" if kind == "crate" else "usda"]


def test_http_resolver_local_and_cached(tmp_path, monkeypatch):
    import urllib.request
    from basicrenderer_tpu.utils import http_resolver as jres
    from basicrenderer_tpu_torch.utils import http_resolver as pres

    fetched = []

    def fake_urlopen(uri, timeout):
        fetched.append(uri)
        return io.BytesIO(b"glTF")

    def no_network(*a, **k):
        raise AssertionError("the resolver reached for the network")
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    local = str(tmp_path / "model.glb")
    assert pres.resolve(local) == local
    assert pres.CACHE_DIR.replace("\\", "/").endswith(
        "basicrenderer_tpu_torch/_build/assets")
    url = "https://example.invalid/assets/city.glb?v=2"
    monkeypatch.setattr(pres, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jres, "CACHE_DIR", str(tmp_path / "jax"))
    # The first call fetches (through the stub) into each cache ...
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    got = pres.resolve(url), jres.resolve(url)
    assert fetched == [url, url]
    # ... the second is a cache hit that never opens the URL.
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    assert (pres.resolve(url), jres.resolve(url)) == got
    assert got[0] == str(tmp_path / "port" / os.path.basename(got[1]))
    assert got[0].endswith(".glb") and open(got[0], "rb").read() == b"glTF"


# --------------------------------------------------------------------------
# A frame of an imported scene
# --------------------------------------------------------------------------

def _fixture_frame(root, path):
    """128x128 soup frame of `path` (the USDC fixture) through `root`'s
    load_model, bridge and frame function."""
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    meshes = m("models.mesh").MeshRegistry()
    mats = m("models.materials").MaterialRegistry()
    sc = m("scene.scene").Scene()
    m("models.importers").load_model(path, sc, meshes, mats)
    sc.create_directional_light(direction=(-0.4, -1.0, -0.3), intensity=3.0)
    sc.set_camera(**ff.CAMERA)
    sc.propagate_transforms()
    bridge_mod = m("scene.bridge")
    caps = bridge_mod.BridgeCapacities(max_vertices=256, max_triangles=256,
                                       max_objects=8, max_materials=8,
                                       max_lights=4)
    bridge = bridge_mod.SceneRenderBridge(sc, meshes, mats, caps)
    fd = m("graph.framedata")
    cfg = fd.FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                         max_pairs=1 << 12, use_pallas_raster=False)
    view = sc.camera_matrices(aspect=1.0)
    fn = m("graph.frame").build_frame_fn(cfg)
    if root == JAX_PKG:
        out = jax.jit(fn)(bridge.build_scene_buffers(), fd.make_view(*view),
                          fd.FrameParams.default())
        return {k: np.asarray(out[k]) for k in ("vis", "image")}
    out = fn(bridge.build_scene_buffers(device="cpu"),
             fd.make_view(*view, device="cpu"), fd.FrameParams.default("cpu"))
    return {k: out[k].numpy() for k in ("vis", "image")}


def test_imported_usdc_frame_matches_jax(tmp_path):
    path = ff.write_fixture("usdc", str(tmp_path))
    j, p = (_fixture_frame(r, path) for r in (JAX_PKG, PORT_PKG))
    np.testing.assert_array_equal(p["vis"], j["vis"])
    assert 0.1 < (p["vis"] > 0).mean() < 0.9
    err = float(np.sqrt(np.mean((p["image"].astype(np.float32)
                                 - j["image"].astype(np.float32)) ** 2)))
    assert err <= 1.0, err
