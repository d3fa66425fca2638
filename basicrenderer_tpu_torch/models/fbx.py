"""Autodesk FBX importer (binary FBX 7.x and ASCII FBX).

Port of basicrenderer_tpu/models/fbx.py, copied with its behaviour
unchanged (host numpy, struct and zlib; no external FBX SDK). Its imports
point at the port's own modules: scene.scene, models.materials,
models.mesh, models.texprocess (textures) and models.animation (clips).

* Binary: "Kaydara FBX Binary" node records — typed scalar properties
  (Y/C/I/F/D/L), zlib-deflated typed arrays (b/i/l/f/d), strings and raw
  blobs; 32-bit record headers before version 7500, 64-bit from 7500.
* ASCII: the `Name: v1, v2 { ... }` block grammar with `*N { a: ... }`
  arrays.

Extraction: node hierarchy with local TRS (Lcl Translation / Rotation /
Scaling + PreRotation, Euler-XYZ degrees), meshes split per material
(LayerElementMaterial ByPolygon), per-corner or per-vertex normals/UVs
through every Mapping/Reference mode combination, Phong material
constants mapped onto the PBR material (DiffuseColor -> base color,
Shininess -> roughness, EmissiveColor), and file textures connected via
OP links (DiffuseColor -> sRGB base color map, NormalMap/Bump -> linear
normal map).

AnimationStack/Layer/CurveNode/Curve stacks import as rigid node-TRS
clips (models.animation.NodeAnimation): component curves merge on the
union of key times, rotations compose Euler-XYZ with PreRotation exactly
like the static path. Not imported: skin deformers
(Deformer::Skin/Cluster) — node hierarchies animate, meshes bind rigidly
to their nodes.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.scene import Scene
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry, compute_normals

_BIN_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"b": np.uint8, b"i": np.int32, b"l": np.int64,
    b"f": np.float32, b"d": np.float64,
}
_SCALAR_FMT = {b"Y": "<h", b"C": "<b", b"I": "<i",
               b"F": "<f", b"D": "<d", b"L": "<q"}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list):
        self.name = name
        self.props = props
        self.children: List["FbxNode"] = []

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def prop_array(self, name: str) -> Optional[np.ndarray]:
        n = self.find(name)
        if n is None or not n.props:
            return None
        v = n.props[0]
        return np.asarray(v) if not np.isscalar(v) else np.asarray([v])

    def prop_str(self, name: str, default: str = "") -> str:
        n = self.find(name)
        return n.props[0] if n is not None and n.props else default


# --------------------------------------------------------------------------
# Binary parser
# --------------------------------------------------------------------------

def _read_binary(data: bytes) -> Tuple[FbxNode, int]:
    version = struct.unpack_from("<I", data, 23)[0]
    wide = version >= 7500
    hdr_fmt, hdr_len = ("<QQQB", 25) if wide else ("<IIIB", 13)
    root = FbxNode("", [])
    pos = 27

    def read_node(pos: int) -> Tuple[Optional[FbxNode], int]:
        end, nprops, _plen, nlen = struct.unpack_from(hdr_fmt, data, pos)
        pos += hdr_len
        if end == 0:                      # NULL terminator record
            return None, pos
        name = data[pos:pos + nlen].decode("ascii", "replace")
        pos += nlen
        props = []
        for _ in range(nprops):
            t = data[pos:pos + 1]
            pos += 1
            if t in _SCALAR_FMT:
                fmt = _SCALAR_FMT[t]
                props.append(struct.unpack_from(fmt, data, pos)[0])
                pos += struct.calcsize(fmt)
            elif t in _ARRAY_TYPES:
                alen, enc, clen = struct.unpack_from("<III", data, pos)
                pos += 12
                raw = data[pos:pos + clen]
                pos += clen
                if enc == 1:
                    raw = zlib.decompress(raw)
                props.append(np.frombuffer(raw, _ARRAY_TYPES[t], alen))
            elif t == b"S":
                slen = struct.unpack_from("<I", data, pos)[0]
                pos += 4
                props.append(data[pos:pos + slen].decode("utf-8", "replace"))
                pos += slen
            elif t == b"R":
                slen = struct.unpack_from("<I", data, pos)[0]
                pos += 4
                props.append(data[pos:pos + slen])
                pos += slen
            else:
                raise ValueError(f"unknown FBX property type {t!r}")
        node = FbxNode(name, props)
        while pos < end:
            child, pos = read_node(pos)
            if child is None:
                break
            node.children.append(child)
        return node, max(pos, end)

    while pos + hdr_len <= len(data):
        node, pos = read_node(pos)
        if node is None:
            break
        root.children.append(node)
    return root, version


# --------------------------------------------------------------------------
# ASCII parser (the same node tree out of the text grammar)
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r'"((?:[^"\\]|\\.)*)"|([A-Za-z_][\w:|.\- ]*?):|([{}])|'
    r'(\*?-?\d+\.?\d*(?:e[+-]?\d+)?)|(,)|(;[^\n]*)', re.IGNORECASE)


def _read_ascii(text: str) -> FbxNode:
    root = FbxNode("", [])
    stack = [root]
    cur: Optional[FbxNode] = None
    for m in _TOKEN_RE.finditer(text):
        string, key, brace, num, _comma, comment = m.groups()
        if comment is not None:
            continue
        if key is not None:
            if key == "a":
                # FBX 7.x array payload `*N { a: v, v, ... }`: fold the
                # values into the enclosing block node's props (cur is None
                # inside the block, so numbers append to stack[-1] which is
                # the array node itself).
                cur = None
                continue
            cur = FbxNode(key.strip(), [])
            stack[-1].children.append(cur)
        elif brace == "{":
            stack.append(cur if cur is not None else stack[-1])
            cur = None
        elif brace == "}":
            stack.pop()
            cur = None
        elif string is not None:
            tgt = cur if cur is not None else stack[-1]
            tgt.props.append(string.replace('\\"', '"'))
        elif num is not None:
            tgt = cur if cur is not None else stack[-1]
            if num.startswith("*"):       # array length marker: ignore,
                continue                  # elements follow inside { a: }
            v = float(num) if ("." in num or "e" in num.lower()) else int(num)
            tgt.props.append(v)
    # Collapse numeric prop runs into arrays for the nodes readers treat
    # as arrays (Vertices, PolygonVertexIndex, ...): binary parity.
    _ARRAY_NODES = {
        "Vertices", "PolygonVertexIndex", "Normals", "NormalsIndex",
        "UV", "UVIndex", "Materials", "Indexes", "Weights", "Edges",
        "KeyTime", "KeyValueFloat", "KeyAttrFlags", "KeyAttrDataFloat",
        "KeyAttrRefCount", "Matrix", "Transform", "TransformLink",
        "Colors", "ColorIndex", "Tangents", "TangentsIndex",
        "Binormals", "BinormalsIndex", "Smoothing", "Points",
    }

    def fold(n: FbxNode):
        numeric = n.props and all(
            np.isscalar(p) and not isinstance(p, str) for p in n.props)
        if numeric and (len(n.props) > 4 or n.name in _ARRAY_NODES):
            dt = (np.int64 if all(isinstance(p, (int, np.integer))
                                  for p in n.props) else np.float64)
            n.props = [np.asarray(n.props, dt)]
        for c in n.children:
            fold(c)
    fold(root)
    return root


# --------------------------------------------------------------------------
# Scene extraction
# --------------------------------------------------------------------------

def _props70(node: FbxNode) -> Dict[str, list]:
    """Properties70 P records -> {name: [values...]}."""
    out: Dict[str, list] = {}
    p70 = node.find("Properties70") or node.find("Properties60")
    if p70 is None:
        return out
    for p in p70.children:
        if p.props:
            out[str(p.props[0])] = p.props[4:] if len(p.props) > 4 else []
    return out


def _euler_xyz_deg_to_quat(rx: float, ry: float, rz: float) -> np.ndarray:
    """FBX eEulerXYZ: v' = Rz(Ry(Rx v)). Return xyzw quaternion."""
    hx, hy, hz = (np.radians(rx) / 2, np.radians(ry) / 2, np.radians(rz) / 2)
    cx, sx = np.cos(hx), np.sin(hx)
    cy, sy = np.cos(hy), np.sin(hy)
    cz, sz = np.cos(hz), np.sin(hz)
    # q = qz * qy * qx
    return np.array([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz], np.float32)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz], np.float32)


def _layer_values(geom: FbxNode, layer_name: str, data_name: str,
                  idx_name: str, width: int,
                  corner_to_vertex: np.ndarray,
                  corner_polygon: np.ndarray) -> Optional[np.ndarray]:
    """Resolve a LayerElement to one value row per polygon corner."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    vals = layer.prop_array(data_name)
    if vals is None:
        return None
    vals = np.asarray(vals, np.float64).reshape(-1, width)
    mapping = layer.prop_str("MappingInformationType", "ByPolygonVertex")
    ref = layer.prop_str("ReferenceInformationType", "Direct")
    if ref == "IndexToDirect":
        idx = layer.prop_array(idx_name)
        if idx is not None:
            idx = np.asarray(idx, np.int64)
            vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping == "ByPolygonVertex":
        return vals
    if mapping in ("ByVertex", "ByVertice", "ByControlPoint"):
        return vals[corner_to_vertex]
    if mapping == "ByPolygon":
        return vals[corner_polygon]
    if mapping == "AllSame":
        return np.broadcast_to(vals[:1], (len(corner_to_vertex), width))
    return None


def _extract_geometry(geom: FbxNode) -> Optional[dict]:
    verts = geom.prop_array("Vertices")
    pvi = geom.prop_array("PolygonVertexIndex")
    if verts is None or pvi is None:
        return None
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    pvi = np.asarray(pvi, np.int64)
    # Triangulate: negative index = (~i) ends the polygon. Fan-triangulate
    # each polygon (same as aiProcess_Triangulate on convex faces).
    corners: List[int] = []           # indices into the pvi corner stream
    corner_poly: List[int] = []
    poly_start, poly_id = 0, 0
    decoded = np.where(pvi < 0, ~pvi, pvi)
    for i, raw in enumerate(pvi):
        if raw < 0:
            n = i - poly_start + 1
            for k in range(1, n - 1):
                corners += [poly_start, poly_start + k, poly_start + k + 1]
                corner_poly += [poly_id] * 3
            poly_start = i + 1
            poly_id += 1
    corners = np.asarray(corners, np.int64)
    corner_poly_arr = np.asarray(corner_poly, np.int64)
    corner_to_vertex_full = decoded                 # per original corner
    ctv = decoded[corners]                          # per triangulated corner
    # Polygon id per ORIGINAL pvi corner (ByPolygon layer mapping needs it):
    # corner j belongs to polygon (#polygon-ends before j).
    ends = np.flatnonzero(pvi < 0)
    orig_corner_poly = np.searchsorted(ends, np.arange(len(pvi)),
                                       side="left").astype(np.int64)

    normals = _layer_values(geom, "LayerElementNormal", "Normals",
                            "NormalsIndex", 3,
                            corner_to_vertex_full, orig_corner_poly)
    # ByPolygon mapping for normals needs the ORIGINAL corner->polygon map:
    if normals is not None and len(normals) == len(pvi):
        normals = normals[corners]
    elif normals is not None and len(normals) == len(verts):
        normals = normals[ctv]

    uvs = None
    uvlayer = geom.find("LayerElementUV")
    if uvlayer is not None:
        vals = uvlayer.prop_array("UV")
        if vals is not None:
            vals = np.asarray(vals, np.float64).reshape(-1, 2)
            mapping = uvlayer.prop_str("MappingInformationType",
                                       "ByPolygonVertex")
            ref = uvlayer.prop_str("ReferenceInformationType", "Direct")
            if ref == "IndexToDirect":
                idx = uvlayer.prop_array("UVIndex")
                if idx is not None:
                    vals = vals[np.clip(np.asarray(idx, np.int64), 0,
                                        len(vals) - 1)]
            if mapping == "ByPolygonVertex":
                uvs = vals[corners]
            elif mapping in ("ByVertex", "ByControlPoint"):
                uvs = vals[ctv]

    # Per-polygon material ids -> per-triangle.
    tri_mat = np.zeros(len(corners) // 3, np.int64)
    matlayer = geom.find("LayerElementMaterial")
    if matlayer is not None:
        mids = matlayer.prop_array("Materials")
        mapping = matlayer.prop_str("MappingInformationType", "AllSame")
        if mids is not None and mapping == "ByPolygon":
            mids = np.asarray(mids, np.int64)
            tri_mat = mids[np.clip(corner_poly_arr[::3], 0, len(mids) - 1)]

    positions = verts[ctv]
    if normals is None or len(normals) != len(positions):
        normals = None
    if uvs is None or len(uvs) != len(positions):
        uvs = np.zeros((len(positions), 2), np.float64)
    # FBX UV origin is bottom-left; the sampler expects top-left (the
    # same V flip AssimpLoader applies via aiProcess_FlipUVs).
    uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=1)
    return {"positions": positions, "normals": normals, "uvs": uvs,
            "tri_mat": tri_mat, "control_points": verts,
            "corner_cp": ctv}


def _split_by_material(g: dict, name: str) -> List[Tuple[int, MeshData]]:
    """One MeshData per referenced material slot (glTF-primitive parity)."""
    out = []
    tri_mat = g["tri_mat"]
    for m in np.unique(tri_mat):
        sel = np.repeat(tri_mat == m, 3)
        pos = np.asarray(g["positions"][sel], np.float32)
        nrm = (np.asarray(g["normals"][sel], np.float32)
               if g["normals"] is not None else None)
        uv = np.asarray(g["uvs"][sel], np.float32)
        idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
        md = MeshData(pos, nrm if nrm is not None else np.zeros_like(pos),
                      uv, idx, name=f"{name}.{int(m)}" if m else name)
        if nrm is None:
            md.normals = compute_normals(md.positions, md.indices)
        cp = g["corner_cp"][sel]
        out.append((int(m), md, cp))
    return out


def _register_file_texture(path: str, registry, srgb: bool,
                           alpha_cutoff: float = -1.0) -> int:
    if registry is None or not path or not os.path.exists(path):
        return -1
    from .texprocess import process_for_registry
    with open(path, "rb") as f:
        data = f.read()
    img = process_for_registry(data, srgb, registry.resolution,
                               cache=registry.processed_cache)
    return -1 if img is None else registry.add(img, srgb=srgb,
                                               alpha_cutoff=alpha_cutoff)


def load_fbx(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry, skeletons=None,
             parent: Optional[int] = None, textures=None) -> Dict[str, list]:
    """Load binary or ASCII FBX into the scene (one renderable per
    mesh-material split, Assimp parity). Returns {"nodes": [...]}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_BIN_MAGIC)] == _BIN_MAGIC:
        root, _ver = _read_binary(data)
    else:
        root = _read_ascii(data.decode("utf-8", "replace"))
    base_dir = os.path.dirname(path)

    objects = root.find("Objects")
    conns = root.find("Connections")
    if objects is None:
        raise ValueError("FBX has no Objects section")

    # Index objects by id. ASCII FBX 6 has no ids; synthesize from order.
    by_id: Dict[int, FbxNode] = {}
    kind: Dict[int, str] = {}
    for i, node in enumerate(objects.children):
        oid = node.props[0] if node.props and isinstance(
            node.props[0], (int, np.integer)) else -(i + 1)
        by_id[int(oid)] = node
        kind[int(oid)] = node.name

    # Connections: child -> [parents] AND parent -> [children in file
    # order]. Slot order (e.g. LayerElementMaterial indices) is defined by
    # the per-model connection record order, so the ordered parent->children
    # map is authoritative for slot binding.
    oo_parents: Dict[int, List[int]] = {}
    oo_children: Dict[int, List[int]] = {}
    op_links: Dict[int, List[Tuple[int, str]]] = {}
    if conns is not None:
        for c in conns.find_all("C") + conns.find_all("Connect"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                cid, pid = int(c.props[1]), int(c.props[2])
                oo_parents.setdefault(cid, []).append(pid)
                oo_children.setdefault(pid, []).append(cid)
            elif len(c.props) >= 4 and c.props[0] == "OP":
                op_links.setdefault(int(c.props[1]), []).append(
                    (int(c.props[2]), str(c.props[3])))

    def children_of(pid: int, want: str) -> List[int]:
        return [cid for cid in oo_children.get(pid, [])
                if kind.get(cid) == want]

    # Materials.
    mat_id_for: Dict[int, int] = {}
    for oid, node in by_id.items():
        if node.name != "Material":
            continue
        p = _props70(node)
        diff = p.get("DiffuseColor", [0.8, 0.8, 0.8])[:3]
        emis = p.get("EmissiveColor", [0, 0, 0])[:3]
        emis_f = p.get("EmissiveFactor", [1.0])
        shin = float(p.get("Shininess", p.get("ShininessExponent",
                                              [20.0]))[0] or 1.0)
        # Blinn-Phong exponent -> GGX roughness (Assimp's specular-to-PBR
        # bridge): alpha = sqrt(2 / (shininess + 2)).
        rough = float(np.sqrt(2.0 / (max(shin, 1e-3) + 2.0)) ** 0.5)
        opacity = float(p.get("Opacity", [1.0])[0])
        mat = Material(
            name=str(node.props[1]).split("\x00")[0] if len(node.props) > 1
            else "fbx_mat",
            base_color=np.array([*diff, opacity], np.float32),
            roughness=min(max(rough, 0.04), 1.0),
            emissive=np.asarray(emis, np.float32)
            * float(emis_f[0] if emis_f else 1.0),
            alpha_blend=opacity < 0.999)
        # OP-linked file textures (Texture objects carry RelativeFilename).
        for tid, prop in [(t, pr) for t, prs in op_links.items()
                          for (tp, pr) in prs if tp == oid
                          for t in [t]]:
            tnode = by_id.get(tid)
            if tnode is None or tnode.name != "Texture":
                continue
            rel = tnode.prop_str("RelativeFilename",
                                 tnode.prop_str("FileName"))
            tex_path = os.path.join(base_dir, rel.replace("\\", "/"))
            if prop in ("DiffuseColor", "BaseColor"):
                mat.base_color_texture = _register_file_texture(
                    tex_path, textures, srgb=True)
            elif prop in ("NormalMap", "Bump"):
                mat.normal_texture = _register_file_texture(
                    tex_path, textures, srgb=False)
        mat_id_for[oid] = materials.add(mat)
    default_mat = materials.add(Material(name="fbx_default")) \
        if not mat_id_for else next(iter(mat_id_for.values()))

    # Geometry: extract + split per material slot.
    geom_for: Dict[int, List[Tuple[int, MeshData, np.ndarray]]] = {}
    for oid, node in by_id.items():
        if node.name != "Geometry" and not (
                node.name == "Model" and node.find("Vertices") is not None):
            continue
        g = _extract_geometry(node)
        if g is not None:
            geom_for[oid] = _split_by_material(
                g, str(node.props[1]).split("\x00")[0]
                if len(node.props) > 1 else "fbx_mesh")

    # Model nodes -> scene hierarchy.
    created: List[int] = []
    node_entity: Dict[int, int] = {}

    def model_trs(node: FbxNode):
        p = _props70(node)
        t = p.get("Lcl Translation", [0, 0, 0])[:3]
        r = p.get("Lcl Rotation", [0, 0, 0])[:3]
        s = p.get("Lcl Scaling", [1, 1, 1])[:3]
        q = _euler_xyz_deg_to_quat(*[float(x) for x in r])
        pre = p.get("PreRotation")
        if pre:
            q = _quat_mul(_euler_xyz_deg_to_quat(
                *[float(x) for x in pre[:3]]), q)
        return ([float(x) for x in t], q, [float(x) for x in s])

    model_ids = [oid for oid, n in by_id.items() if n.name == "Model"]

    def build(oid: int, parent_entity: Optional[int]):
        node = by_id[oid]
        t, q, s = model_trs(node)
        name = (str(node.props[1]).split("\x00")[0]
                if len(node.props) > 1 else "")
        ent = scene.create_node(parent_entity, position=t, rotation=q,
                                scale=s, name=name)
        node_entity[oid] = ent
        created.append(ent)
        # Attach geometry (old FBX6 embeds Vertices in the Model itself).
        geo_ids = children_of(oid, "Geometry")
        if oid in geom_for:
            geo_ids = [oid]
        slot_mats = [mat_id_for.get(m, default_mat)
                     for m in children_of(oid, "Material")]
        for gid in geo_ids:
            for slot, md, _cp in geom_for.get(gid, []):
                mid = meshes.add(md)
                mat = (slot_mats[slot] if slot < len(slot_mats)
                       else (slot_mats[0] if slot_mats else default_mat))
                e = scene.create_renderable(mid, mat, parent=ent)
                created.append(e)
        for cid in children_of(oid, "Model"):
            build(cid, ent)

    roots = [oid for oid in model_ids
             if not any(p in model_ids for p in oo_parents.get(oid, []))]
    top = scene.create_node(parent, name=os.path.basename(path))
    created.append(top)
    for oid in roots:
        build(oid, top)
    clips = _extract_node_animations(by_id, kind, op_links, oo_parents,
                                     node_entity, model_trs)
    return {"nodes": created, "clips": clips}


_KTIME = 46186158000.0      # FBX KTime ticks per second


def _extract_node_animations(by_id, kind, op_links, oo_parents,
                             node_entity, model_trs):
    """AnimationStack/Layer/CurveNode/Curve -> NodeAnimation clips
    (reference: Assimp's aiAnimation/aiNodeAnim extraction the reference
    consumes through AssimpLoader.cpp:240-400). Component curves
    (d|X/d|Y/d|Z, KeyTime ticks + KeyValueFloat) merge on the union of
    their key times; rotations are Euler-XYZ degrees composed with the
    model's PreRotation exactly like the static path (model_trs)."""
    from .animation import Channel, NodeAnimation, NodeTrack

    _PATHS = {"Lcl Translation": "translation",
              "Lcl Rotation": "rotation",
              "Lcl Scaling": "scale"}

    def curve_data(cnode):
        kt = cnode.prop_array("KeyTime")
        kv = cnode.prop_array("KeyValueFloat")
        if kt is None or kv is None or len(kt) == 0:
            return None
        n = min(len(kt), len(kv))
        return (np.asarray(kt[:n], np.float64) / _KTIME,
                np.asarray(kv[:n], np.float32))

    def stack_of(an_id):
        for lid in oo_parents.get(an_id, []):
            if kind.get(lid) == "AnimationLayer":
                for sid in oo_parents.get(lid, []):
                    if kind.get(sid) == "AnimationStack":
                        return sid
        return -1

    # (stack, entity) -> {path: channel}
    stacks: Dict[int, Dict[int, List]] = {}
    for an_id, node in by_id.items():
        if kind.get(an_id) != "AnimationCurveNode":
            continue
        # Component curves feeding this node (OP child->this, prop d|X..).
        comps: Dict[str, tuple] = {}
        for cid, links in op_links.items():
            if kind.get(cid) != "AnimationCurve":
                continue
            for (pid, prop) in links:
                if pid == an_id and prop.startswith("d|"):
                    cd = curve_data(by_id[cid])
                    if cd is not None:
                        comps[prop[2:3].upper()] = cd
        if not comps:
            continue
        defaults = _props70(node)
        for (mid, prop) in op_links.get(an_id, []):
            path = _PATHS.get(prop)
            ent = node_entity.get(mid)
            if path is None or ent is None:
                continue
            t_stat, q_stat, s_stat = model_trs(by_id[mid])
            static = {"translation": t_stat,
                      "rotation": _props70(by_id[mid]).get(
                          "Lcl Rotation", [0, 0, 0])[:3],
                      "scale": s_stat}[path]
            times = np.unique(np.concatenate(
                [c[0] for c in comps.values()]))
            cols = []
            for ax_i, ax in enumerate("XYZ"):
                if ax in comps:
                    ct, cv = comps[ax]
                    cols.append(np.interp(times, ct, cv))
                else:
                    d = defaults.get(f"d|{ax}", [static[ax_i]])
                    cols.append(np.full(times.shape,
                                        float(d[0]), np.float64))
            if path == "rotation":
                pre = _props70(by_id[mid]).get("PreRotation")
                qs = []
                for k in range(len(times)):
                    q = _euler_xyz_deg_to_quat(cols[0][k], cols[1][k],
                                               cols[2][k])
                    if pre:
                        q = _quat_mul(_euler_xyz_deg_to_quat(
                            *[float(x) for x in pre[:3]]), q)
                    # Hemisphere continuity so key-to-key lerp is short-arc.
                    if qs and float(np.dot(qs[-1], q)) < 0.0:
                        q = -q
                    qs.append(q)
                vals = np.asarray(qs, np.float32)
            else:
                vals = np.stack(cols, -1).astype(np.float32)
            ch = Channel(0, path, times.astype(np.float32), vals, "LINEAR")
            stacks.setdefault(stack_of(an_id), {}).setdefault(
                ent, []).append(ch)

    clips = []
    for sid, per_ent in stacks.items():
        snode = by_id.get(sid)
        name = (str(snode.props[1]).split("\x00")[0].split("::")[-1]
                if snode is not None and len(snode.props) > 1 else "fbx_anim")
        clips.append(NodeAnimation(name, [
            NodeTrack(ent, chans) for ent, chans in per_ent.items()]))
    return clips
