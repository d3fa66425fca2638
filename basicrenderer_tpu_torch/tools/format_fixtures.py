"""Small scenes in every file format the importers read, written from
scratch (numpy, struct and the port's own writers): a ground quad and a
cube, with a material each, in

    fbx          binary FBX 7.4 (the record layout of tests/test_fbx.py's
                 fixture), the ground textured with a PNG checker
    usda         ASCII USD
    usdc         crate 0.8.0 (compressed sections), save_usdc
    usdc_legacy  crate 0.0.1 (plain sections), save_usdc
    usdz         a zip holding the 0.8.0 crate, save_usdz
    nif          a two-shape NIF, write_nif, the ground textured
    ply          binary little-endian PLY (one merged mesh)
    stl          binary STL (one merged mesh)
    dae          Collada with effects, materials and node transforms

`write_fixture(name, directory)` writes one and returns its path;
`fixture_scene(path, meshes, materials, textures)` imports it through
models.importers.load_model into a Scene with the camera and light that
frame it. chip_smoke.py renders each card against CPU; the tests import
each through both packages.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

FORMATS = ("fbx", "usda", "usdc", "usdc_legacy", "usdz", "nif", "ply", "stl",
           "dae")
EXTENSIONS = {"usdc_legacy": "usdc"}
CAMERA = dict(position=(3.0, 2.5, 4.0), target=(0.0, 0.3, 0.0))
CUBE_OFFSET = (0.3, 0.5, -0.2)
GROUND_COLOR = (0.7, 0.7, 0.65)
CUBE_COLOR = (0.8, 0.15, 0.1)


def _shapes():
    """[(name, positions, normals, uvs, indices, offset, color)] of the
    ground (4 x 4 at y = 0) and the unit cube."""
    from ..models import procedural
    g, c = procedural.make_plane(4.0, 1), procedural.make_cube(1.0)
    return [("ground", g.positions, g.normals, g.uvs, g.indices,
             (0.0, 0.0, 0.0), GROUND_COLOR),
            ("cube", c.positions, c.normals, c.uvs, c.indices, CUBE_OFFSET,
             CUBE_COLOR)]


def _merged():
    """Both shapes in one mesh, offsets applied (the single-mesh formats)."""
    pos, nrm, idx, base = [], [], [], 0
    for _n, p, n, _uv, i, off, _c in _shapes():
        pos.append(p + np.asarray(off, np.float32))
        nrm.append(n)
        idx.append(i + base)
        base += len(p)
    return (np.concatenate(pos).astype(np.float32),
            np.concatenate(nrm).astype(np.float32),
            np.concatenate(idx).astype(np.int32))


def checker_png(path: str, n: int = 16, cell: int = 4) -> None:
    from ..utils.png import write_png
    yy, xx = np.mgrid[0:n, 0:n]
    on = ((yy // cell + xx // cell) % 2).astype(bool)
    img = np.where(on[..., None], [230, 220, 60], [40, 90, 200])
    write_png(path, img.astype(np.uint8))


# --------------------------------------------------------------------------
# FBX (binary 7.4: 13-byte record headers)
# --------------------------------------------------------------------------

def _fbx_prop(v) -> bytes:
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    t = {np.dtype(np.int32): b"i", np.dtype(np.float64): b"d"}[v.dtype]
    comp = zlib.compress(v.tobytes())
    return t + struct.pack("<III", v.size, 1, len(comp)) + comp


def _fbx_node(name: str, props: list, children=()):
    """A record writer taking its absolute offset (the end offset is in
    the header)."""
    def build(offset: int) -> bytes:
        nb = name.encode()
        pb = b"".join(_fbx_prop(p) for p in props)
        inner = offset + 13 + len(nb) + len(pb)
        body = b""
        for fn in children:
            body += fn(inner + len(body))
        term = b"\x00" * 13 if children else b""
        end = inner + len(body) + len(term)
        return (struct.pack("<III", end, len(props), len(pb)) + bytes([len(nb)])
                + nb + pb + body + term)
    return build


def _fbx_p70(**vals):
    return _fbx_node("Properties70", [], [
        _fbx_node("P", [k.replace("_", " "), k.replace("_", " "), "", "A"]
                  + [float(x) for x in v]) for k, v in vals.items()])


def _fbx_geometry(oid: int, name: str, pos, idx, uvs=None, normals=None):
    pvi = np.asarray(idx, np.int32).copy()
    pvi[:, 2] = ~pvi[:, 2]
    kids = [_fbx_node("Vertices", [np.asarray(pos, np.float64).reshape(-1)]),
            _fbx_node("PolygonVertexIndex", [pvi.reshape(-1)])]
    corners = np.asarray(idx).reshape(-1)
    if normals is not None:
        kids.append(_fbx_node("LayerElementNormal", [0], [
            _fbx_node("MappingInformationType", ["ByPolygonVertex"]),
            _fbx_node("ReferenceInformationType", ["Direct"]),
            _fbx_node("Normals", [np.asarray(normals, np.float64)[corners]
                                  .reshape(-1)])]))
    if uvs is not None:
        uv = np.asarray(uvs, np.float64)[corners]
        uv[:, 1] = 1.0 - uv[:, 1]          # FBX's V points up
        kids.append(_fbx_node("LayerElementUV", [0], [
            _fbx_node("MappingInformationType", ["ByPolygonVertex"]),
            _fbx_node("ReferenceInformationType", ["Direct"]),
            _fbx_node("UV", [uv.reshape(-1)])]))
    return _fbx_node("Geometry", [oid, f"Geometry::{name}\x00\x01Geometry",
                                  "Mesh"], kids)


def write_fbx(path: str) -> str:
    """Binary FBX: the ground (checker-textured through an OP link to its
    material's DiffuseColor) and the cube (Lcl Translation / Rotation)."""
    (_g, gp, _gn, guv, gi, _go, gc), (_c, cp, cn, _cuv, ci, co, cc) = _shapes()
    checker_png(os.path.join(os.path.dirname(path), "checker.png"))
    objects = _fbx_node("Objects", [], [
        _fbx_geometry(140, "ground", gp, gi, uvs=guv),
        _fbx_node("Model", [100, "Model::ground\x00\x01Model", "Mesh"],
                  [_fbx_node("Version", [232])]),
        _fbx_geometry(141, "cube", cp, ci, normals=cn),
        _fbx_node("Model", [101, "Model::cube\x00\x01Model", "Mesh"], [
            _fbx_node("Version", [232]),
            _fbx_p70(Lcl_Translation=co, Lcl_Rotation=(0.0, 30.0, 0.0))]),
        _fbx_node("Material", [200, "Material::checker\x00\x01Material", ""],
                  [_fbx_p70(DiffuseColor=gc)]),
        _fbx_node("Material", [201, "Material::red\x00\x01Material", ""],
                  [_fbx_p70(DiffuseColor=cc, Shininess=(60.0,))]),
        _fbx_node("Texture", [300, "Texture::checker\x00\x01Texture", ""],
                  [_fbx_node("RelativeFilename", ["checker.png"])]),
    ])
    conns = _fbx_node("Connections", [], [
        _fbx_node("C", ["OO", 140, 100]), _fbx_node("C", ["OO", 200, 100]),
        _fbx_node("C", ["OO", 141, 101]), _fbx_node("C", ["OO", 201, 101]),
        _fbx_node("C", ["OP", 300, 200, "DiffuseColor"])])
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    out += objects(len(out))
    out += conns(len(out))
    out += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(out)
    return path


# --------------------------------------------------------------------------
# USD: ASCII, crate (modern and legacy) and USDZ
# --------------------------------------------------------------------------

def _tuples(a) -> str:
    return ", ".join("(" + ", ".join(f"{float(x):g}" for x in row) + ")"
                     for row in np.asarray(a).reshape(len(a), -1))


def write_usda(path: str) -> str:
    body = []
    for name, p, _n, uv, i, off, col in _shapes():
        body.append(f'''
    def Material "{name}_mat"
    {{
        def Shader "pbr"
        {{
            uniform token info:id = "UsdPreviewSurface"
            color3f inputs:diffuseColor = ({col[0]:g}, {col[1]:g}, {col[2]:g})
            float inputs:metallic = 0.0
            float inputs:roughness = 0.5
        }}
    }}

    def Xform "{name}X"
    {{
        double3 xformOp:translate = ({off[0]:g}, {off[1]:g}, {off[2]:g})
        uniform token[] xformOpOrder = ["xformOp:translate"]

        def Mesh "{name}"
        {{
            point3f[] points = [{_tuples(p)}]
            int[] faceVertexIndices = [{", ".join(str(int(x)) for x in np.asarray(i).reshape(-1))}]
            int[] faceVertexCounts = [{", ".join("3" for _ in range(len(i)))}]
            texCoord2f[] primvars:st = [{_tuples(uv)}]
            rel material:binding = </World/{name}_mat>
        }}
    }}''')
    text = ('#usda 1.0\n(\n    defaultPrim = "World"\n    metersPerUnit = 1\n)'
            '\n\ndef Xform "World"\n{' + "\n".join(body) + "\n}\n")
    with open(path, "w") as f:
        f.write(text)
    return path


def usd_prims() -> list:
    """The crate fixtures' stage: a material and a Mesh prim per shape,
    each mesh placed by its xformOp:transform."""
    from ..models.usdc import UsdPrim
    prims = [UsdPrim("/World", "Xform")]
    for name, p, n, uv, i, off, col in _shapes():
        M = np.eye(4)
        M[3, :3] = off                  # row-vector form on disk
        prims.append(UsdPrim(f"/World/{name}_mat", "Material", attrs={
            "inputs:diffuseColor": np.asarray([col], np.float32),
            "inputs:metallic": 0.0, "inputs:roughness": 0.5}))
        prims.append(UsdPrim(f"/World/{name}", "Mesh", attrs={
            "points": np.asarray(p, np.float32),
            "faceVertexIndices": np.asarray(i, np.int32).reshape(-1),
            "faceVertexCounts": np.full(len(i), 3, np.int32),
            "normals": np.asarray(n, np.float32),
            "primvars:st": np.asarray(uv, np.float32),
            "xformOp:transform": M,
        }, rels={"material:binding": f"/World/{name}_mat"}))
    return prims


# --------------------------------------------------------------------------
# NIF, PLY, STL, DAE
# --------------------------------------------------------------------------

def write_nif_fixture(path: str) -> str:
    """Two NiTriShapes under the root; the ground's texture set names
    checker.png as its diffuse map."""
    from ..models.nif import write_nif
    checker_png(os.path.join(os.path.dirname(path), "checker.png"))
    write_nif(path, [dict(name=name, vertices=p, triangles=i, normals=n,
                          uvs=uv, translation=off, glossiness=80.0,
                          textures=["checker.png", ""] if name == "ground"
                          else [])
                     for name, p, n, uv, i, off, _c in _shapes()])
    return path


def write_ply(path: str) -> str:
    """Binary PLY: x/y/z, nx/ny/nz and red/green/blue (uchar) per vertex,
    a vertex_indices list per face."""
    pos, nrm, idx = _merged()
    rgb = np.tile(np.asarray([200, 120, 60], np.uint8), (len(pos), 1))
    hdr = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pos)}\n"
           "property float x\nproperty float y\nproperty float z\n"
           "property float nx\nproperty float ny\nproperty float nz\n"
           "property uchar red\nproperty uchar green\nproperty uchar blue\n"
           f"element face {len(idx)}\n"
           "property list uchar int vertex_indices\nend_header\n").encode()
    vdt = np.dtype([("p", "<f4", 3), ("n", "<f4", 3), ("c", "u1", 3)])
    verts = np.zeros(len(pos), vdt)
    verts["p"], verts["n"], verts["c"] = pos, nrm, rgb
    fdt = np.dtype([("k", "u1"), ("i", "<i4", 3)])
    faces = np.zeros(len(idx), fdt)
    faces["k"], faces["i"] = 3, idx
    with open(path, "wb") as f:
        f.write(hdr + verts.tobytes() + faces.tobytes())
    return path


def write_stl(path: str) -> str:
    """Binary STL: one record (face normal, three corners) per triangle."""
    pos, _nrm, idx = _merged()
    tri = pos[idx]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    rec = np.zeros(len(idx), np.dtype([("f", "<f4", 12), ("a", "<u2")]))
    rec["f"] = np.concatenate([fn, tri.reshape(-1, 9)], 1)
    with open(path, "wb") as f:
        f.write(b"\x00" * 80 + struct.pack("<I", len(idx)) + rec.tobytes())
    return path


def write_dae(path: str) -> str:
    """Collada 1.4: per shape an effect (diffuse colour), a material, a
    geometry (POSITION / NORMAL / TEXCOORD sources, indexed triangles) and
    a visual-scene node with a translate and a rotate."""
    effects, mats, geoms, nodes = [], [], [], []
    for name, p, n, uv, i, off, col in _shapes():
        def src(sid, a, params):
            a = np.asarray(a).reshape(len(a), -1)
            return (f'<source id="{sid}"><float_array id="{sid}-a" count='
                    f'"{a.size}">{" ".join(f"{float(x):g}" for x in a.reshape(-1))}'
                    f'</float_array><technique_common><accessor source="#{sid}-a"'
                    f' count="{len(a)}" stride="{a.shape[1]}">'
                    + "".join(f'<param name="{q}" type="float"/>' for q in params)
                    + "</accessor></technique_common></source>")
        ii = np.repeat(np.asarray(i).reshape(-1, 1), 3, axis=1).reshape(-1)
        effects.append(f'<effect id="{name}-fx"><profile_COMMON><technique '
                       f'sid="common"><lambert><diffuse><color>{col[0]:g} '
                       f'{col[1]:g} {col[2]:g} 1</color></diffuse></lambert>'
                       '</technique></profile_COMMON></effect>')
        mats.append(f'<material id="{name}-mat" name="{name}"><instance_effect'
                    f' url="#{name}-fx"/></material>')
        geoms.append(
            f'<geometry id="{name}-geo" name="{name}"><mesh>'
            + src(f"{name}-pos", p, "XYZ") + src(f"{name}-nrm", n, "XYZ")
            + src(f"{name}-uv", uv, "ST")
            + f'<vertices id="{name}-vtx"><input semantic="POSITION" '
            f'source="#{name}-pos"/></vertices><triangles material="sym" '
            f'count="{len(i)}"><input semantic="VERTEX" source="#{name}-vtx" '
            f'offset="0"/><input semantic="NORMAL" source="#{name}-nrm" '
            f'offset="1"/><input semantic="TEXCOORD" source="#{name}-uv" '
            f'offset="2"/><p>{" ".join(str(int(x)) for x in ii)}</p>'
            '</triangles></mesh></geometry>')
        nodes.append(f'<node id="{name}-node" name="{name}"><translate>'
                     f'{off[0]:g} {off[1]:g} {off[2]:g}</translate><rotate>0 1 0'
                     f' {20 if name == "cube" else 0}</rotate><instance_geometry'
                     f' url="#{name}-geo"><bind_material><technique_common>'
                     f'<instance_material symbol="sym" target="#{name}-mat"/>'
                     '</technique_common></bind_material></instance_geometry>'
                     '</node>')
    text = ('<?xml version="1.0" encoding="utf-8"?>\n<COLLADA xmlns="http://'
            'www.collada.org/2005/11/COLLADASchema" version="1.4.1">'
            f'<library_effects>{"".join(effects)}</library_effects>'
            f'<library_materials>{"".join(mats)}</library_materials>'
            f'<library_geometries>{"".join(geoms)}</library_geometries>'
            '<library_visual_scenes><visual_scene id="scene">'
            f'{"".join(nodes)}</visual_scene></library_visual_scenes>'
            '<scene><instance_visual_scene url="#scene"/></scene></COLLADA>\n')
    with open(path, "w") as f:
        f.write(text)
    return path


def write_fixture(name: str, directory: str) -> str:
    """Write fixture `name` (one of FORMATS) into `directory`; its path."""
    from ..models import usdc
    path = os.path.join(directory, f"{name}.{EXTENSIONS.get(name, name)}")
    if name == "fbx":
        return write_fbx(path)
    if name == "usda":
        return write_usda(path)
    if name == "usdc":
        usdc.save_usdc(path, usd_prims())
    elif name == "usdc_legacy":
        usdc.save_usdc(path, usd_prims(), version=(0, 0, 1))
    elif name == "usdz":
        usdc.save_usdz(path, usd_prims())
    elif name == "nif":
        return write_nif_fixture(path)
    elif name == "ply":
        return write_ply(path)
    elif name == "stl":
        return write_stl(path)
    elif name == "dae":
        return write_dae(path)
    else:
        raise ValueError(f"unknown fixture {name!r} (known: {FORMATS})")
    return path


def fixture_scene(path: str, meshes, materials, textures=None,
                  skeletons=None) -> Tuple[object, object]:
    """Import `path` through load_model into a new Scene and add the
    directional light and the camera that frame the fixtures. Returns
    (scene, load_model's result)."""
    from ..models.importers import load_model
    from ..scene.scene import Scene
    sc = Scene()
    out = load_model(path, sc, meshes, materials, skeletons,
                     textures=textures)
    sc.create_directional_light(direction=(-0.4, -1.0, -0.3), intensity=3.0)
    sc.set_camera(**CAMERA)
    sc.propagate_transforms()
    return sc, out
