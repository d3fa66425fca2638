"""Breadth mesh formats: PLY, STL, Collada (.dae).

Port of basicrenderer_tpu/models/meshformats.py, copied with its
behaviour unchanged. Each loader is a from-scratch numpy reader of the
public format spec; all three land in the same MeshData/Material/Scene
registries as the glTF path, so everything downstream (cluster build,
raster, shading) is format-agnostic.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import numpy as np

from ..scene.scene import Scene
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry, compute_normals


# --------------------------------------------------------------------------
# PLY (ascii + binary_little_endian)
# --------------------------------------------------------------------------

_PLY_DTYPES = {
    "char": np.int8, "int8": np.int8, "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16, "ushort": np.uint16,
    "uint16": np.uint16, "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32, "float": np.float32,
    "float32": np.float32, "double": np.float64, "float64": np.float64,
}


def load_ply(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry,
             parent: Optional[int] = None) -> int:
    """Stanford PLY: vertex x/y/z (+nx/ny/nz, s/t or u/v, red/green/blue)
    and face vertex_indices lists, ascii or binary little-endian."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if data[:3] != b"ply" or end < 0:
        raise ValueError("not a PLY file")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = "ascii"
    elements: List[Tuple[str, int, list]] = []   # (name, count, props)
    for line in header:
        p = line.split()
        if not p:
            continue
        if p[0] == "format":
            fmt = p[1]
        elif p[0] == "element":
            elements.append((p[1], int(p[2]), []))
        elif p[0] == "property" and elements:
            if p[1] == "list":
                elements[-1][2].append(("list", p[2], p[3], p[4]))
            else:
                elements[-1][2].append(("scalar", p[1], p[2]))
    if fmt == "binary_big_endian":
        raise ValueError("big-endian PLY unsupported")

    vert_cols: Dict[str, np.ndarray] = {}
    face_lists: List[List[int]] = []
    if fmt == "ascii":
        toks = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                arr = np.array(toks[ti:ti + count * ncols],
                               np.float64).reshape(count, ncols)
                ti += count * ncols
                for ci, pr in enumerate(props):
                    vert_cols[pr[-1]] = arr[:, ci]
            elif name == "face":
                for _ in range(count):
                    n = int(toks[ti]); ti += 1
                    face_lists.append([int(x) for x in toks[ti:ti + n]])
                    ti += n
            else:       # skip unknown ascii elements conservatively
                for _ in range(count):
                    for pr in props:
                        if pr[0] == "list":
                            n = int(toks[ti]); ti += 1 + n
                        else:
                            ti += 1
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] == "scalar" for p in props):
                dt = np.dtype([(p[2], _PLY_DTYPES[p[1]].__name__)
                               for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                for p in props:
                    vert_cols[p[2]] = np.asarray(arr[p[2]], np.float64)
            else:
                # Generic row walk: vertex elements that contain list
                # properties still collect their scalar columns; the face
                # list is selected by PROPERTY NAME (vertex_indices), not
                # by whichever list happened to be read last.
                col_acc = ({p[-1]: [] for p in props if p[0] == "scalar"}
                           if name == "vertex" else None)
                for _ in range(count):
                    face_vals = None
                    for p in props:
                        if p[0] == "list":
                            cnt_t = _PLY_DTYPES[p[1]]
                            n = int(np.frombuffer(body, cnt_t, 1, off)[0])
                            off += cnt_t().itemsize
                            it = _PLY_DTYPES[p[2]]
                            vals = np.frombuffer(body, it, n, off)
                            off += it().itemsize * n
                            if p[-1] in ("vertex_indices", "vertex_index"):
                                face_vals = vals
                        else:
                            it = _PLY_DTYPES[p[1]]
                            if col_acc is not None:
                                col_acc[p[-1]].append(
                                    float(np.frombuffer(body, it, 1, off)[0]))
                            off += it().itemsize
                    if name == "face" and face_vals is not None:
                        face_lists.append([int(x) for x in face_vals])
                if col_acc:
                    for k, v in col_acc.items():
                        vert_cols[k] = np.asarray(v, np.float64)

    pos = np.stack([vert_cols[c] for c in ("x", "y", "z")], 1)
    nrm = (np.stack([vert_cols[c] for c in ("nx", "ny", "nz")], 1)
           if "nx" in vert_cols else None)
    uvk = ("s", "t") if "s" in vert_cols else (
        ("u", "v") if "u" in vert_cols else None)
    uv = (np.stack([vert_cols[uvk[0]], vert_cols[uvk[1]]], 1)
          if uvk else np.zeros((len(pos), 2)))
    tris = []
    for fl in face_lists:
        for k in range(1, len(fl) - 1):
            tris.append((fl[0], fl[k], fl[k + 1]))
    idx = np.asarray(tris, np.int32).reshape(-1, 3)
    md = MeshData(np.asarray(pos, np.float32),
                  np.asarray(nrm, np.float32) if nrm is not None
                  else np.zeros_like(pos, dtype=np.float32),
                  np.asarray(uv, np.float32), idx,
                  name=os.path.basename(path))
    if nrm is None:
        md.normals = compute_normals(md.positions, md.indices)
    mat = Material(name="ply_default")
    if "red" in vert_cols:     # average vertex color -> base color factor
        scale = 255.0 if vert_cols["red"].max() > 1.0 else 1.0
        mat.base_color = np.array([
            vert_cols["red"].mean() / scale,
            vert_cols["green"].mean() / scale,
            vert_cols["blue"].mean() / scale, 1.0], np.float32)
    return scene.create_renderable(meshes.add(md), materials.add(mat),
                                   parent=parent)


# --------------------------------------------------------------------------
# STL (ascii + binary)
# --------------------------------------------------------------------------

def load_stl(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry,
             parent: Optional[int] = None) -> int:
    with open(path, "rb") as f:
        data = f.read()
    is_ascii = data[:5] == b"solid" and b"facet" in data[:2048]
    if is_ascii:
        txt = data.decode("ascii", "replace")
        vs = re.findall(r"vertex\s+(\S+)\s+(\S+)\s+(\S+)", txt)
        ns = re.findall(r"facet\s+normal\s+(\S+)\s+(\S+)\s+(\S+)", txt)
        pos = np.asarray(vs, np.float32).reshape(-1, 3)
        nrm = np.repeat(np.asarray(ns, np.float32), 3, axis=0)
    else:
        ntri = struct.unpack_from("<I", data, 80)[0]
        rec = np.frombuffer(data, np.uint8, ntri * 50, 84).reshape(ntri, 50)
        f32 = rec[:, :48].copy().view(np.float32).reshape(ntri, 12)
        nrm = np.repeat(f32[:, 0:3], 3, axis=0)
        pos = f32[:, 3:12].reshape(-1, 3)
    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    md = MeshData(pos, nrm, np.zeros((len(pos), 2), np.float32), idx,
                  name=os.path.basename(path))
    return scene.create_renderable(meshes.add(md),
                                   materials.add(Material(name="stl")),
                                   parent=parent)


# --------------------------------------------------------------------------
# Collada .dae
# --------------------------------------------------------------------------

def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _dae_walk(elem) -> list:
    return [(c, _strip_ns(c.tag)) for c in elem]


def load_dae(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry,
             parent: Optional[int] = None) -> Dict[str, list]:
    """Collada: library_geometries triangles/polylist with VERTEX/NORMAL/
    TEXCOORD inputs, effect diffuse colors, visual_scene node TRS/matrix."""
    tree = ElementTree.parse(path)
    root = tree.getroot()

    def find_all(elem, name):
        return [c for c in elem.iter() if _strip_ns(c.tag) == name]

    # Effects -> diffuse color per effect id.
    effect_color: Dict[str, np.ndarray] = {}
    for eff in find_all(root, "effect"):
        eid = eff.get("id", "")
        for dif in find_all(eff, "diffuse"):
            col = find_all(dif, "color")
            if col:
                v = [float(x) for x in col[0].text.split()]
                effect_color[eid] = np.asarray((v + [1.0])[:4], np.float32)
    mat_for: Dict[str, int] = {}
    for m in find_all(root, "material"):
        mid = m.get("id", "")
        inst = find_all(m, "instance_effect")
        url = inst[0].get("url", "#")[1:] if inst else ""
        mat = Material(name=m.get("name", mid))
        if url in effect_color:
            mat.base_color = effect_color[url]
        mat_for[mid] = materials.add(mat)
    default_mat = materials.add(Material(name="dae_default"))

    # Geometries.
    geom_for: Dict[str, List[Tuple[str, MeshData]]] = {}
    for g in find_all(root, "geometry"):
        gid = g.get("id", "")
        out: List[Tuple[str, MeshData]] = []
        for mesh in find_all(g, "mesh"):
            sources = {}
            for s in find_all(mesh, "source"):
                fa = find_all(s, "float_array")
                acc = find_all(s, "accessor")
                if fa and acc:
                    stride = int(acc[0].get("stride", 1))
                    arr = np.asarray(fa[0].text.split(), np.float64)
                    sources[s.get("id", "")] = arr.reshape(-1, stride)
            vert_src = {}
            for v in find_all(mesh, "vertices"):
                for inp in find_all(v, "input"):
                    if inp.get("semantic") == "POSITION":
                        vert_src[v.get("id", "")] = inp.get("source",
                                                            "#")[1:]
            for prim in (find_all(mesh, "triangles")
                         + find_all(mesh, "polylist")):
                inputs = []
                for inp in find_all(prim, "input"):
                    sem = inp.get("semantic")
                    src = inp.get("source", "#")[1:]
                    if sem == "VERTEX":
                        src = vert_src.get(src, src)
                    inputs.append((sem, src, int(inp.get("offset", 0))))
                stride = max(i[2] for i in inputs) + 1
                p = find_all(prim, "p")
                if not p:
                    continue
                pidx = np.asarray(p[0].text.split(), np.int64)
                if _strip_ns(prim.tag) == "polylist":
                    vc = np.asarray(
                        find_all(prim, "vcount")[0].text.split(), np.int64)
                    # fan-triangulate
                    tris = []
                    off = 0
                    for n in vc:
                        base = pidx[off:off + n * stride].reshape(n, stride)
                        for k in range(1, n - 1):
                            tris += [base[0], base[k], base[k + 1]]
                        off += n * stride
                    corner = np.asarray(tris).reshape(-1, stride)
                else:
                    corner = pidx.reshape(-1, stride)
                pos = nrm = uv = None
                for sem, src, offi in inputs:
                    arr = sources.get(src)
                    if arr is None:
                        continue
                    vals = arr[np.clip(corner[:, offi], 0, len(arr) - 1)]
                    if sem == "VERTEX":
                        pos = vals[:, :3]
                    elif sem == "NORMAL":
                        nrm = vals[:, :3]
                    elif sem == "TEXCOORD":
                        uv = np.stack([vals[:, 0], 1.0 - vals[:, 1]], 1)
                if pos is None:
                    continue
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
                md = MeshData(np.asarray(pos, np.float32),
                              np.asarray(nrm, np.float32) if nrm is not None
                              else np.zeros((len(pos), 3), np.float32),
                              np.asarray(uv, np.float32) if uv is not None
                              else np.zeros((len(pos), 2), np.float32),
                              idx, name=gid)
                if nrm is None:
                    md.normals = compute_normals(md.positions, md.indices)
                out.append((prim.get("material", ""), md))
        geom_for[gid] = out

    # Visual scene nodes.
    created: List[int] = []
    top = scene.create_node(parent, name=os.path.basename(path))
    created.append(top)

    def node_trs(n):
        # Compose matrix/translate/rotate/scale children in order into TRS.
        M = np.eye(4)
        for c, tag in _dae_walk(n):
            if tag == "matrix":
                M = M @ np.asarray(c.text.split(), np.float64).reshape(4, 4)
            elif tag == "translate":
                T = np.eye(4); T[:3, 3] = [float(x) for x in c.text.split()]
                M = M @ T
            elif tag == "rotate":
                x, y, z, deg = [float(v) for v in c.text.split()]
                a = np.radians(deg)
                axis = np.asarray([x, y, z])
                axis = axis / (np.linalg.norm(axis) + 1e-12)
                K = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                R = np.eye(4)
                R[:3, :3] = (np.eye(3) + np.sin(a) * K
                             + (1 - np.cos(a)) * (K @ K))
                M = M @ R
            elif tag == "scale":
                S = np.diag([*[float(x) for x in c.text.split()], 1.0])
                M = M @ S
        t = M[:3, 3]
        s = np.linalg.norm(M[:3, :3], axis=0)
        R = M[:3, :3] / np.where(s > 1e-12, s, 1.0)
        from .importers import _mat_to_quat
        return t, _mat_to_quat(R), s

    def build(n, parent_entity):
        t, q, s = node_trs(n)
        ent = scene.create_node(parent_entity, position=t, rotation=q,
                                scale=s, name=n.get("name", ""))
        created.append(ent)
        for c, tag in _dae_walk(n):
            if tag == "instance_geometry":
                gid = c.get("url", "#")[1:]
                # material symbol -> material id binding
                binds = {im.get("symbol", ""): im.get("target", "#")[1:]
                         for im in find_all(c, "instance_material")}
                for sym, md in geom_for.get(gid, []):
                    mid = mat_for.get(binds.get(sym, sym), default_mat)
                    created.append(scene.create_renderable(
                        meshes.add(md), mid, parent=ent))
            elif tag == "node":
                build(c, ent)

    for vs in find_all(root, "visual_scene"):
        for c, tag in _dae_walk(vs):
            if tag == "node":
                build(c, top)
    return {"nodes": created}
