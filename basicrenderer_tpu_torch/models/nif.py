"""NetImmerse/Gamebryo (.nif) importer — self-contained binary reader.

Port of basicrenderer_tpu/models/nif.py, copied with its behaviour
unchanged (host numpy and struct). It parses the NIF container directly
into the port's Scene and registries: node hierarchy, tri geometry,
PBR-mapped materials, texture paths.

Format scope (the Skyrim-class Gamebryo stream):
- container version 20.2.0.7, user version 11/12, BS stream 83 (LE) —
  the header's per-block size table makes every UNKNOWN block skippable,
  so files with physics/animation/FX blocks still load their geometry;
- `NiNode`/`BSFadeNode`/`BSLeafAnimNode`... (any *Node listing children)
  -> scene nodes with TRS transforms;
- `NiTriShape` + `NiTriShapeData`, `NiTriStrips` + `NiTriStripsData`
  (strips are de-stripped) -> MeshData (positions/normals/uvs/triangles);
- `BSLightingShaderProperty` + `BSShaderTextureSet` -> Material
  (glossiness -> roughness, specular strength -> metallic-ish dielectric
  spec, emissive color/mult, diffuse + normal texture paths).

A matching `write_nif` emits the same subset, byte for byte what the JAX
package's writes.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.scene import Scene
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry

_VERSION = 0x14020007          # 20.2.0.7
_HDR = b"Gamebryo File Format, Version 20.2.0.7\n"


# --------------------------------------------------------------------------
# low-level stream
# --------------------------------------------------------------------------
class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, n: int) -> bytes:
        b = self.d[self.o:self.o + n]
        if len(b) < n:
            raise ValueError("truncated NIF stream")
        self.o += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u16(self):
        return struct.unpack("<H", self.take(2))[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def f32(self):
        return struct.unpack("<f", self.take(4))[0]

    def f32s(self, n):
        return np.frombuffer(self.take(4 * n), "<f4").astype(np.float32)

    def u16s(self, n):
        return np.frombuffer(self.take(2 * n), "<u2").astype(np.int32)

    def sized_string(self) -> str:
        n = self.u32()
        return self.take(n).decode("latin-1")

    def export_string(self) -> str:
        n = self.u8()
        return self.take(n).rstrip(b"\x00").decode("latin-1")

    def ref_list(self) -> List[int]:
        n = self.u32()
        return [self.i32() for _ in range(n)]


class _W:
    def __init__(self):
        self.b = bytearray()

    def raw(self, x):
        self.b += x

    def u8(self, v):
        self.b += struct.pack("<B", v)

    def u16(self, v):
        self.b += struct.pack("<H", v)

    def u32(self, v):
        self.b += struct.pack("<I", v)

    def i32(self, v):
        self.b += struct.pack("<i", v)

    def f32(self, v):
        self.b += struct.pack("<f", v)

    def f32s(self, a):
        self.b += np.asarray(a, "<f4").tobytes()

    def u16s(self, a):
        self.b += np.asarray(a, "<u2").tobytes()

    def sized_string(self, s):
        e = s.encode("latin-1")
        self.u32(len(e))
        self.raw(e)

    def export_string(self, s):
        e = s.encode("latin-1") + b"\x00"
        self.u8(len(e))
        self.raw(e)

    def ref_list(self, refs):
        self.u32(len(refs))
        for r in refs:
            self.i32(r)


# --------------------------------------------------------------------------
# block models (parsed subset)
# --------------------------------------------------------------------------
class NifNode:
    def __init__(self):
        self.name = ""
        self.translation = np.zeros(3, np.float32)
        self.rotation = np.eye(3, dtype=np.float32)
        self.scale = 1.0
        self.children: List[int] = []


class NifShape(NifNode):
    def __init__(self):
        super().__init__()
        self.data = -1
        self.skin = -1
        self.shader_property = -1
        self.alpha_property = -1


class NifGeomData:
    def __init__(self):
        self.vertices = np.zeros((0, 3), np.float32)
        self.normals: Optional[np.ndarray] = None
        self.uvs: Optional[np.ndarray] = None
        self.colors: Optional[np.ndarray] = None
        self.triangles = np.zeros((0, 3), np.int32)


class NifShader:
    def __init__(self):
        self.shader_type = 0
        self.emissive = np.zeros(3, np.float32)
        self.emissive_mult = 1.0
        self.alpha = 1.0
        self.glossiness = 80.0
        self.specular_color = np.ones(3, np.float32)
        self.specular_strength = 1.0
        self.texture_set = -1


class NifTextureSet:
    def __init__(self):
        self.textures: List[str] = []


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
def _read_av_object(r: _R, obj, strings: List[str]):
    ni = r.i32()
    obj.name = strings[ni] if 0 <= ni < len(strings) else ""
    r.ref_list()                      # extra data
    r.i32()                           # controller
    r.u32()                           # flags (BS stream >= 26: u32)
    obj.translation = r.f32s(3)
    obj.rotation = r.f32s(9).reshape(3, 3)
    obj.scale = r.f32()
    r.i32()                           # collision object


def _read_node(r: _R, strings) -> NifNode:
    n = NifNode()
    _read_av_object(r, n, strings)
    n.children = r.ref_list()
    r.ref_list()                      # effects
    return n


def _read_tri_shape(r: _R, strings) -> NifShape:
    s = NifShape()
    _read_av_object(r, s, strings)
    s.data = r.i32()
    s.skin = r.i32()
    nm = r.u32()                      # material data (20.2.0.7 layout)
    for _ in range(nm):
        r.i32()
    for _ in range(nm):
        r.i32()
    r.i32()                           # active material
    r.u8()                            # material needs update
    s.shader_property = r.i32()
    s.alpha_property = r.i32()
    return s


def _read_geom_common(r: _R) -> Tuple[NifGeomData, int]:
    """NiGeometryData prefix shared by NiTriShapeData/NiTriStripsData.
    Returns (data, bs_vector_flags)."""
    g = NifGeomData()
    r.i32()                           # group id
    nv = r.u16()
    r.u8()                            # keep flags
    r.u8()                            # compress flags
    if r.u8():                        # has vertices
        g.vertices = r.f32s(3 * nv).reshape(nv, 3)
    vflags = r.u16()                  # BS vector flags
    r.u32()                           # material CRC (20.2.0.7 / UV 12)
    if r.u8():                        # has normals
        g.normals = r.f32s(3 * nv).reshape(nv, 3)
        if vflags & 0x1000:           # tangent space present
            r.f32s(3 * nv)
            r.f32s(3 * nv)
    r.f32s(4)                         # center + radius
    if r.u8():                        # has vertex colors
        g.colors = r.f32s(4 * nv).reshape(nv, 4)
    n_uv = vflags & 63
    for k in range(n_uv):
        uv = r.f32s(2 * nv).reshape(nv, 2)
        if k == 0:
            g.uvs = uv
    r.u16()                           # consistency flags
    r.i32()                           # additional data
    return g, nv


def _read_tri_shape_data(r: _R, strings) -> NifGeomData:
    g, _nv = _read_geom_common(r)
    nt = r.u16()
    r.u32()                           # num triangle points
    if r.u8():                        # has triangles
        g.triangles = r.u16s(3 * nt).reshape(nt, 3)
    nmg = r.u16()                     # match groups
    for _ in range(nmg):
        c = r.u16()
        r.u16s(c)
    return g


def _read_tri_strips_data(r: _R, strings) -> NifGeomData:
    g, _nv = _read_geom_common(r)
    r.u16()                           # num triangles (derived)
    ns = r.u16()
    lens = [r.u16() for _ in range(ns)]
    tris = []
    if r.u8():                        # has points
        for L in lens:
            strip = r.u16s(L)
            for i in range(L - 2):
                a, b, c = strip[i], strip[i + 1], strip[i + 2]
                if a == b or b == c or a == c:
                    continue          # degenerate (strip stitching)
                tris.append((a, c, b) if i % 2 else (a, b, c))
    g.triangles = np.asarray(tris or np.zeros((0, 3)), np.int32)
    return g


def _read_lighting_shader(r: _R, strings, end: int) -> NifShader:
    s = NifShader()
    s.shader_type = r.u32()
    ni = r.i32()
    _ = strings[ni] if 0 <= ni < len(strings) else ""
    r.ref_list()                      # extra data
    r.i32()                           # controller
    r.u32()                           # shader flags 1
    r.u32()                           # shader flags 2
    r.f32s(2)                         # uv offset
    r.f32s(2)                         # uv scale
    s.texture_set = r.i32()
    s.emissive = r.f32s(3)
    s.emissive_mult = r.f32()
    r.u32()                           # texture clamp mode
    s.alpha = r.f32()
    r.f32()                           # refraction strength
    s.glossiness = r.f32()
    s.specular_color = r.f32s(3)
    s.specular_strength = r.f32()
    r.f32()                           # lighting effect 1
    r.f32()                           # lighting effect 2
    r.o = end                         # type-specific tail: skip via size
    return s


def _read_texture_set(r: _R, strings) -> NifTextureSet:
    t = NifTextureSet()
    n = r.u32()
    t.textures = [r.sized_string() for _ in range(n)]
    return t


_NODE_TYPES = {"NiNode", "BSFadeNode", "BSLeafAnimNode", "BSTreeNode",
               "BSOrderedNode", "NiBillboardNode", "NiSwitchNode"}

_PARSERS = {
    "NiTriShape": _read_tri_shape,
    "NiTriStrips": _read_tri_shape,
    "NiTriShapeData": _read_tri_shape_data,
    "NiTriStripsData": _read_tri_strips_data,
    "BSLightingShaderProperty": _read_lighting_shader,
    "BSShaderTextureSet": _read_texture_set,
}


def parse_nif(data: bytes):
    """Parse a binary NIF. Returns (blocks, block_types, roots) where
    blocks[i] is a parsed object or None (unknown/skipped block)."""
    nl = data.index(b"\n") + 1
    hdr = data[:nl]
    if b"Gamebryo File Format" not in hdr and \
            b"NetImmerse File Format" not in hdr:
        raise ValueError("not a NIF file")
    r = _R(data)
    r.o = nl
    version = r.u32()
    if version != _VERSION:
        raise ValueError(
            f"unsupported NIF version 0x{version:08x} (supported: 20.2.0.7)")
    if r.u8() != 1:
        raise ValueError("big-endian NIF not supported")
    user_version = r.u32()
    num_blocks = r.u32()
    if user_version >= 3:
        stream = r.u32()
        r.export_string()             # author
        if stream > 130:
            r.u32()
        r.export_string()             # process script
        r.export_string()             # export script
    n_types = r.u16()
    types = [r.sized_string() for _ in range(n_types)]
    tidx = [r.u16() & 0x7FFF for _ in range(num_blocks)]
    sizes = [r.u32() for _ in range(num_blocks)]
    n_str = r.u32()
    r.u32()                           # max string length
    strings = [r.sized_string() for _ in range(n_str)]
    n_groups = r.u32()
    for _ in range(n_groups):
        r.u32()

    blocks = []
    btypes = []
    for i in range(num_blocks):
        tname = types[tidx[i]]
        btypes.append(tname)
        end = r.o + sizes[i]
        obj = None
        try:
            if tname in _NODE_TYPES:
                obj = _read_node(r, strings)
            elif tname == "BSLightingShaderProperty":
                obj = _read_lighting_shader(r, strings, end)
            elif tname in _PARSERS:
                obj = _PARSERS[tname](r, strings)
        except (ValueError, struct.error, IndexError):
            obj = None                # malformed block: geometry-less skip
        r.o = end                     # size table: unknown blocks skip clean
        blocks.append(obj)

    n_roots = r.u32()
    roots = [r.i32() for _ in range(n_roots)]
    return blocks, btypes, roots


# --------------------------------------------------------------------------
# scene instantiation
# --------------------------------------------------------------------------
def _mat3_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> xyzw quaternion (Shepperd's method)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s], np.float32)
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, np.float32)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _roughness_from_glossiness(gloss: float) -> float:
    """Skyrim glossiness (Blinn exponent, ~10..1000) -> GGX roughness via
    the Beckmann alpha relation a = sqrt(2 / (gloss + 2))."""
    return float(np.clip(np.sqrt(2.0 / (max(gloss, 1.0) + 2.0)) ** 0.5,
                         0.03, 1.0))


def load_nif(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry, skeletons=None,
             parent: Optional[int] = None, textures=None) -> Dict[str, list]:
    """Load a binary .nif into the scene (one renderable per tri shape).

    Reference parity: NifLoader::LoadModel (NifLoader.cpp:12-40) — same
    outcome (scene nodes + meshes + materials), without the external
    BRNifly conversion subprocess.
    """
    with open(path, "rb") as f:
        data = f.read()
    blocks, btypes, roots = parse_nif(data)

    created: List[int] = []
    mat_cache: Dict[int, int] = {}

    def material_for(shape: NifShape) -> int:
        key = shape.shader_property
        if key in mat_cache:
            return mat_cache[key]
        mid = 0
        if 0 <= key < len(blocks) and isinstance(blocks[key], NifShader):
            from .fbx import _register_file_texture
            sh: NifShader = blocks[key]
            base_tex = normal_tex = -1
            if 0 <= sh.texture_set < len(blocks) and \
                    isinstance(blocks[sh.texture_set], NifTextureSet):
                ts: NifTextureSet = blocks[sh.texture_set]
                root = os.path.dirname(path)
                if len(ts.textures) > 0 and ts.textures[0]:
                    base_tex = _register_file_texture(
                        os.path.join(root, ts.textures[0].replace("\\", "/")),
                        textures, srgb=True)
                if len(ts.textures) > 1 and ts.textures[1]:
                    normal_tex = _register_file_texture(
                        os.path.join(root, ts.textures[1].replace("\\", "/")),
                        textures, srgb=False)
            mid = materials.add(Material(
                base_color=np.array([1.0, 1.0, 1.0, sh.alpha], np.float32),
                roughness=_roughness_from_glossiness(sh.glossiness),
                metallic=0.0,
                emissive=np.asarray(sh.emissive * sh.emissive_mult,
                                    np.float32),
                base_color_texture=base_tex,
                normal_texture=normal_tex,
                alpha_blend=sh.alpha < 0.999))
        else:
            mid = materials.add(Material(
                base_color=np.array([0.8, 0.8, 0.8, 1.0], np.float32),
                roughness=0.7))
        mat_cache[key] = mid
        return mid

    def build(idx: int, parent_entity):
        blk = blocks[idx] if 0 <= idx < len(blocks) else None
        if blk is None:
            return
        t = tuple(np.asarray(blk.translation, np.float32))
        q = tuple(_mat3_to_quat(np.asarray(blk.rotation, np.float32)))
        s = (blk.scale,) * 3
        if isinstance(blk, NifShape):
            g = blocks[blk.data] if 0 <= blk.data < len(blocks) else None
            if not isinstance(g, NifGeomData) or len(g.triangles) == 0:
                return
            nv = len(g.vertices)
            normals = g.normals
            if normals is None:
                normals = _face_normals(g.vertices, g.triangles)
            uvs = g.uvs if g.uvs is not None else np.zeros((nv, 2),
                                                           np.float32)
            mesh_id = meshes.add(MeshData(
                positions=g.vertices, normals=normals, uvs=uvs,
                indices=g.triangles, name=blk.name))
            e = scene.create_renderable(mesh_id, material_for(blk),
                                        parent=parent_entity, position=t,
                                        rotation=q, scale=s)
            created.append(e)
        elif isinstance(blk, NifNode):
            e = scene.create_node(parent_entity, position=t, rotation=q,
                                  scale=s, name=blk.name)
            created.append(e)
            for c in blk.children:
                build(c, e)

    top = scene.create_node(parent, name=os.path.basename(path))
    created.append(top)
    for ridx in roots:
        build(ridx, top)
    return {"entities": created}


def _face_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals when the file carries none."""
    n = np.zeros_like(verts)
    if len(tris):
        e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
        e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
        fn = np.cross(e1, e2)
        for k in range(3):
            np.add.at(n, tris[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


# --------------------------------------------------------------------------
# writer (fixture generator + export path)
# --------------------------------------------------------------------------
def write_nif(path: str, meshes: List[dict], root_name: str = "Scene",
              extra_unknown_block: bool = False):
    """Write a binary NIF (20.2.0.7 / UV 12 / stream 83) with a root
    NiNode and one NiTriShape (+Data, +BSLightingShaderProperty,
    +BSShaderTextureSet) per mesh dict:
      {name, vertices (V,3), triangles (T,3), normals?, uvs?,
       translation?, rotation? (3,3), scale?, glossiness?, textures?}
    """
    strings: List[str] = []

    def sid(s: str) -> int:
        if s not in strings:
            strings.append(s)
        return strings.index(s)

    btypes: List[str] = []
    blocks: List[Tuple[int, bytes]] = []   # (type index, payload)

    def tid(t: str) -> int:
        if t not in btypes:
            btypes.append(t)
        return btypes.index(t)

    root_children = []
    payloads: List[Tuple[str, _W]] = []

    def new_block(tname: str) -> _W:
        w = _W()
        payloads.append((tname, w))
        return w

    # Block ids are assigned in emit order: root=0, then per-mesh chains.
    next_id = 1
    root_name_id = sid(root_name)
    mesh_block_ids = []
    for m in meshes:
        shp = next_id
        data_id = next_id + 1
        shader_id = next_id + 2
        texset_id = next_id + 3
        next_id += 4
        mesh_block_ids.append((shp, data_id, shader_id, texset_id))
        root_children.append(shp)

    def av_object(w: _W, name_id: int, m: dict):
        w.i32(name_id)
        w.u32(0)                      # extra data
        w.i32(-1)                     # controller
        w.u32(14)                     # flags
        w.f32s(np.asarray(m.get("translation", (0, 0, 0)), np.float32))
        w.f32s(np.asarray(m.get("rotation", np.eye(3)),
                          np.float32).reshape(-1))
        w.f32(float(m.get("scale", 1.0)))
        w.i32(-1)                     # collision

    for m, (shp, data_id, shader_id, texset_id) in zip(meshes,
                                                       mesh_block_ids):
        name_id = sid(m.get("name", "Shape"))
        w = new_block("NiTriShape")
        av_object(w, name_id, m)
        w.i32(data_id)
        w.i32(-1)                     # skin
        w.u32(0)                      # num materials
        w.i32(-1)                     # active material
        w.u8(0)                       # needs update
        w.i32(shader_id)
        w.i32(-1)                     # alpha property

        v = np.asarray(m["vertices"], np.float32)
        t = np.asarray(m["triangles"], np.int32)
        nrm = m.get("normals")
        uv = m.get("uvs")
        w = new_block("NiTriShapeData")
        w.i32(0)                      # group id
        w.u16(len(v))
        w.u8(0)
        w.u8(0)
        w.u8(1)                       # has vertices
        w.f32s(v.reshape(-1))
        w.u16(1 if uv is not None else 0)   # BS vector flags (1 uv set)
        w.u32(0)                      # material CRC
        w.u8(1 if nrm is not None else 0)
        if nrm is not None:
            w.f32s(np.asarray(nrm, np.float32).reshape(-1))
        center = v.mean(axis=0) if len(v) else np.zeros(3)
        radius = float(np.linalg.norm(v - center, axis=1).max()) \
            if len(v) else 0.0
        w.f32s(np.asarray(center, np.float32))
        w.f32(radius)
        w.u8(0)                       # vertex colors
        if uv is not None:
            w.f32s(np.asarray(uv, np.float32).reshape(-1))
        w.u16(0)                      # consistency
        w.i32(-1)                     # additional data
        w.u16(len(t))
        w.u32(len(t) * 3)
        w.u8(1)                       # has triangles
        w.u16s(t.reshape(-1))
        w.u16(0)                      # match groups

        w = new_block("BSLightingShaderProperty")
        w.u32(0)                      # shader type: default
        w.i32(sid(m.get("name", "Shape") + ":shader"))
        w.u32(0)                      # extra data
        w.i32(-1)                     # controller
        w.u32(0x80400201)             # shader flags 1
        w.u32(0x00000081)             # shader flags 2
        w.f32s([0.0, 0.0])            # uv offset
        w.f32s([1.0, 1.0])            # uv scale
        w.i32(texset_id)
        w.f32s(np.asarray(m.get("emissive", (0, 0, 0)), np.float32))
        w.f32(float(m.get("emissive_mult", 1.0)))
        w.u32(3)                      # clamp mode
        w.f32(float(m.get("alpha", 1.0)))
        w.f32(0.0)                    # refraction
        w.f32(float(m.get("glossiness", 80.0)))
        w.f32s([1.0, 1.0, 1.0])      # specular color
        w.f32(float(m.get("specular_strength", 1.0)))
        w.f32(0.3)                    # lighting effect 1
        w.f32(2.0)                    # lighting effect 2

        w = new_block("BSShaderTextureSet")
        texs = list(m.get("textures", []))
        w.u32(max(len(texs), 2) if texs else 0)
        for i in range(max(len(texs), 2) if texs else 0):
            w.sized_string(texs[i] if i < len(texs) else "")

    # Root node LAST in payload list but FIRST block: build separately.
    rootw = _W()
    rootw.i32(root_name_id)
    rootw.u32(0)
    rootw.i32(-1)
    rootw.u32(14)
    rootw.f32s(np.zeros(3, np.float32))
    rootw.f32s(np.eye(3, dtype=np.float32).reshape(-1))
    rootw.f32(1.0)
    rootw.i32(-1)
    rootw.u32(len(root_children))
    for c in root_children:
        rootw.i32(c)
    rootw.u32(0)                      # effects

    ordered = [("NiNode", rootw)] + payloads
    if extra_unknown_block:
        # An unreferenced block of a type the reader does not know —
        # exercises the size-table skip path (real files carry physics/
        # animation blocks the importer must step over).
        uw = _W()
        uw.u32(0xDEADBEEF)
        uw.f32s(np.arange(7, dtype=np.float32))
        ordered.append(("bhkWeirdPhysicsBlob", uw))
    for tname, w in ordered:
        blocks.append((tid(tname), bytes(w.b)))

    out = _W()
    out.raw(_HDR)
    out.u32(_VERSION)
    out.u8(1)                         # little endian
    out.u32(12)                       # user version
    out.u32(len(blocks))
    out.u32(83)                       # BS stream
    out.export_string("basicrenderer_tpu")   # the JAX package's exporter name
    out.export_string("")
    out.export_string("")
    out.u16(len(btypes))
    for t in btypes:
        out.sized_string(t)
    for ti, _p in blocks:
        out.u16(ti)
    for _ti, p in blocks:
        out.u32(len(p))
    out.u32(len(strings))
    out.u32(max((len(s) for s in strings), default=0))
    for s in strings:
        out.sized_string(s)
    out.u32(0)                        # groups
    for _ti, p in blocks:
        out.raw(p)
    out.u32(1)                        # roots
    out.i32(0)
    with open(path, "wb") as f:
        f.write(bytes(out.b))
