"""Asset importers: glTF 2.0 (.gltf/.glb), Wavefront OBJ, and the dispatch
to every other format.

Port of basicrenderer_tpu/models/importers.py, copied with its
behaviour unchanged (host numpy, no external dependencies besides PIL
for PNG/JPEG). Loads geometry, PBR
metallic-roughness material factors and the KHR material extensions, the
node hierarchy (TRS or matrix), skins (inverse bind + joint hierarchy),
keyframe animations, and texture images (from file URIs, data URIs or GLB
buffer views) into the port's registries and Scene. Image decodes fan out
on the shared task pool (utils/taskpool.py) while texture ids are given
out in material order, so ids do not depend on the pool's timing. Colour
textures register sRGB; normal and metallic-roughness data register
linear; an alpha-MASK material's base colour registers with its cutoff
(coverage-preserving mips, models/textures.py).

`load_model` dispatches on the file extension as the JAX package does:
glTF and OBJ here; USD (.usda/.usd/.usdc, a crate sniffed by its magic,
and .usdz) in models/usd.py and models/usdc.py; FBX in models/fbx.py;
PLY, STL and DAE in models/meshformats.py; NIF in models/nif.py. An
unknown extension raises ValueError.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.scene import Scene
from .animation import AnimationClip, Channel, Skeleton, SkeletonRegistry
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}


def _read_glb(path: str) -> Tuple[dict, bytes]:
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError("not a GLB file")
        gltf = None
        binary = b""
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<II", hdr)
            data = f.read(clen)
            if ctype == 0x4E4F534A:          # JSON
                gltf = json.loads(data)
            elif ctype == 0x004E4942:        # BIN
                binary = data
        return gltf, binary


def _buffer_bytes(gltf: dict, idx: int, base_dir: str, glb_bin: bytes) -> bytes:
    buf = gltf["buffers"][idx]
    uri = buf.get("uri")
    if uri is None:
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


class _GltfReader:
    def __init__(self, gltf: dict, base_dir: str, glb_bin: bytes):
        self.gltf = gltf
        self.buffers = [
            _buffer_bytes(gltf, i, base_dir, glb_bin)
            for i in range(len(gltf.get("buffers", [])))]

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.gltf["accessors"][idx]
        view = self.gltf["bufferViews"][acc["bufferView"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        itemsize = np.dtype(dtype).itemsize * ncomp
        stride = view.get("byteStride", itemsize)
        off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        raw = self.buffers[view["buffer"]]
        if stride == itemsize:
            a = np.frombuffer(raw, dtype, count * ncomp, off)
        else:
            a = np.zeros((count, ncomp), dtype)
            for i in range(count):
                a[i] = np.frombuffer(raw, dtype, ncomp, off + i * stride)
        a = a.reshape(count, ncomp) if ncomp > 1 else a.reshape(count)
        if acc.get("normalized") and dtype in (np.uint8, np.uint16):
            a = a.astype(np.float32) / np.iinfo(dtype).max
        return np.array(a)


def _image_bytes(gltf: dict, rd: "_GltfReader", base_dir: str,
                 img_idx: int) -> Optional[bytes]:
    """Raw encoded bytes of gltf images[img_idx] (PNG/JPEG/DDS/HDR)."""
    img = gltf["images"][img_idx]
    uri = img.get("uri")
    if uri is not None:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        from urllib.parse import unquote
        with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
            return f.read()
    if "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        off = view.get("byteOffset", 0)
        return rd.buffers[view["buffer"]][off:off + view["byteLength"]]
    return None


class _TextureImporter:
    """glTF texture index -> TextureRegistry id, decoded lazily and cached
    per (texture, colorspace, masked) since a registry layer bakes its
    encoding and mip policy. Decode/resize rides texprocess (DDS + HDR
    support, processed-texture disk cache when the registry carries one)."""

    def __init__(self, gltf, rd, base_dir, registry):
        self.gltf, self.rd, self.base_dir = gltf, rd, base_dir
        self.registry = registry
        self.cache: Dict[Tuple[int, bool, bool], int] = {}
        self._futures: Dict[Tuple[int, bool], object] = {}

    def _decode(self, tex_idx: int, srgb: bool):
        from .texprocess import process_for_registry
        tex = self.gltf.get("textures", [])[tex_idx]
        src = tex.get("source", -1)
        data = None if src < 0 else _image_bytes(
            self.gltf, self.rd, self.base_dir, src)
        return None if data is None else process_for_registry(
            data, srgb, self.registry.resolution,
            cache=self.registry.processed_cache)

    def prefetch(self, usages) -> None:
        """Fan decode+resize+BC of every referenced image out onto the
        shared task pool (reference: TaskSchedulerManager import workers);
        registry ids still assign in deterministic material order in
        get()."""
        if self.registry is None:
            return
        from ..utils.taskpool import shared_pool
        for tex_idx, srgb in usages:
            fkey = (tex_idx, srgb)
            if tex_idx >= 0 and fkey not in self._futures:
                self._futures[fkey] = shared_pool().submit(
                    self._decode, tex_idx, srgb)

    def get(self, tex_idx: int, srgb: bool,
            alpha_cutoff: float = -1.0) -> int:
        if tex_idx < 0 or self.registry is None:
            return -1
        # Key on the actual cutoff: two MASK materials sharing a texture
        # with different alphaCutoff need distinct coverage-preserving mips.
        key = (tex_idx, srgb, alpha_cutoff)
        if key not in self.cache:
            fut = self._futures.get((tex_idx, srgb))
            img = fut.result() if fut is not None else self._decode(
                tex_idx, srgb)
            self.cache[key] = -1 if img is None else self.registry.add(
                img, srgb=srgb, alpha_cutoff=alpha_cutoff)
        return self.cache[key]


def load_gltf(path: str, scene: Scene, meshes: MeshRegistry,
              materials: MaterialRegistry,
              skeletons: Optional[SkeletonRegistry] = None,
              parent: Optional[int] = None,
              textures=None) -> Dict[str, list]:
    """Load a glTF file into the scene. Returns created entity/clip info.
    `textures`: a models.textures.TextureRegistry to decode images into
    (None skips image decode; materials keep factors only)."""
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, glb_bin = _read_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_bin = b""
    rd = _GltfReader(gltf, base_dir, glb_bin)
    tex_import = _TextureImporter(gltf, rd, base_dir, textures)

    # Materials. Decode all referenced images concurrently first.
    usages = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        usages += [
            (pbr.get("baseColorTexture", {}).get("index", -1), True),
            (m.get("normalTexture", {}).get("index", -1), False),
            (pbr.get("metallicRoughnessTexture", {}).get("index", -1), False),
            (m.get("emissiveTexture", {}).get("index", -1), True)]
    tex_import.prefetch(usages)
    mat_ids = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        mask_cutoff = (m.get("alphaCutoff", 0.5)
                       if m.get("alphaMode") == "MASK" else -1.0)
        mat = Material(
            name=m.get("name", ""),
            base_color=base,
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            emissive=np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32),
            normal_scale=float(m.get("normalTexture", {}).get("scale", 1.0)),
            double_sided=bool(m.get("doubleSided", False)),
            alpha_blend=m.get("alphaMode") == "BLEND",
            alpha_cutoff=mask_cutoff,
            base_color_texture=tex_import.get(
                pbr.get("baseColorTexture", {}).get("index", -1), True,
                alpha_cutoff=mask_cutoff),
            normal_texture=tex_import.get(
                m.get("normalTexture", {}).get("index", -1), False),
            metallic_roughness_texture=tex_import.get(
                pbr.get("metallicRoughnessTexture", {}).get("index", -1),
                False),
            emissive_texture=tex_import.get(
                m.get("emissiveTexture", {}).get("index", -1), True),
        )
        # OpenPBR-class extensions (reference: USD/Assimp material import
        # feeding PerMaterialOpenPBRCB, ShaderBuffers.h:277-334).
        ext = m.get("extensions", {})
        if "KHR_materials_ior" in ext:
            mat.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
        if "KHR_materials_transmission" in ext:
            mat.transmission_weight = float(
                ext["KHR_materials_transmission"].get(
                    "transmissionFactor", 0.0))
        if "KHR_materials_volume" in ext:
            vol = ext["KHR_materials_volume"]
            mat.transmission_color = np.asarray(
                vol.get("attenuationColor", [1, 1, 1]), np.float32)
            dist = vol.get("attenuationDistance", 0.0)
            if dist and np.isfinite(dist):
                mat.transmission_depth = float(dist)
        if "KHR_materials_anisotropy" in ext:
            an = ext["KHR_materials_anisotropy"]
            mat.anisotropy_strength = float(
                an.get("anisotropyStrength", 0.0))
            mat.anisotropy_rotation = float(
                an.get("anisotropyRotation", 0.0))
        if "KHR_materials_clearcoat" in ext:
            cc = ext["KHR_materials_clearcoat"]
            mat.coat_weight = float(cc.get("clearcoatFactor", 0.0))
            mat.coat_roughness = float(
                cc.get("clearcoatRoughnessFactor", 0.0))
        if "KHR_materials_sheen" in ext:
            sh = ext["KHR_materials_sheen"]
            mat.sheen_color = np.asarray(
                sh.get("sheenColorFactor", [0, 0, 0]), np.float32)
            mat.fuzz_roughness = float(sh.get("sheenRoughnessFactor", 0.5))
            mat.fuzz_weight = float(np.max(mat.sheen_color))
        mat_ids.append(materials.add(mat))
    if not mat_ids:
        mat_ids = [0]

    # Meshes (each primitive -> one MeshData).
    mesh_prims: List[List[Tuple[int, int]]] = []
    for gm in gltf.get("meshes", []):
        prims = []
        for prim in gm.get("primitives", []):
            attrs = prim["attributes"]
            pos = rd.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = rd.accessor(attrs["NORMAL"]).astype(np.float32) \
                if "NORMAL" in attrs else None
            uv = rd.accessor(attrs["TEXCOORD_0"]).astype(np.float32) \
                if "TEXCOORD_0" in attrs else None
            joints = rd.accessor(attrs["JOINTS_0"]).astype(np.int32) \
                if "JOINTS_0" in attrs else None
            weights = rd.accessor(attrs["WEIGHTS_0"]).astype(np.float32) \
                if "WEIGHTS_0" in attrs else None
            # Authored tangents win over the mikktspace recompute (glTF
            # mandates mikktspace-compatible TANGENT; MeshRegistry.add
            # derives them otherwise — models/mesh.compute_tangents).
            tang = rd.accessor(attrs["TANGENT"]).astype(np.float32) \
                if "TANGENT" in attrs else None
            if tang is not None and tang.shape[-1] != 4:
                tang = None
            if "indices" in prim:
                idx = rd.accessor(prim["indices"]).astype(np.int32).reshape(-1, 3)
            else:
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            md = MeshData(pos, nrm if nrm is not None else np.zeros_like(pos),
                          uv if uv is not None else np.zeros((len(pos), 2), np.float32),
                          idx, tangents=tang, joints=joints, weights=weights,
                          name=gm.get("name", ""))
            if nrm is None:
                from .mesh import compute_normals
                md.normals = compute_normals(md.positions, md.indices)
            mid = meshes.add(md)
            mat = mat_ids[prim["material"]] if "material" in prim else mat_ids[0]
            prims.append((mid, mat))
        mesh_prims.append(prims)

    # Skins.
    skin_ids = []
    node_trs = gltf.get("nodes", [])
    for skin in gltf.get("skins", []):
        joints = skin["joints"]
        inv_bind = rd.accessor(skin["inverseBindMatrices"]).reshape(-1, 4, 4) \
            .transpose(0, 2, 1).astype(np.float32) \
            if "inverseBindMatrices" in skin else \
            np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
        node_to_joint = {n: j for j, n in enumerate(joints)}
        parents = np.full(len(joints), -1, np.int32)
        for ni, node in enumerate(node_trs):
            for ch in node.get("children", []):
                if ch in node_to_joint and ni in node_to_joint:
                    parents[node_to_joint[ch]] = node_to_joint[ni]
        rest_pos = np.zeros((len(joints), 3), np.float32)
        rest_rot = np.tile(np.array([0, 0, 0, 1], np.float32), (len(joints), 1))
        rest_scale = np.ones((len(joints), 3), np.float32)
        for j, n in enumerate(joints):
            nd = node_trs[n]
            rest_pos[j] = nd.get("translation", [0, 0, 0])
            rest_rot[j] = nd.get("rotation", [0, 0, 0, 1])
            rest_scale[j] = nd.get("scale", [1, 1, 1])
        sk = Skeleton(parents, inv_bind, rest_pos, rest_rot, rest_scale)
        skin_ids.append(skeletons.add(sk) if skeletons else -1)

    # Nodes -> scene hierarchy.
    created: Dict[int, int] = {}

    def build_node(ni: int, parent_e: Optional[int]):
        nd = node_trs[ni]
        if "matrix" in nd:
            m = np.asarray(nd["matrix"], np.float32).reshape(4, 4).T
            t = m[:3, 3]
            # crude decomposition (no shear)
            s = np.linalg.norm(m[:3, :3], axis=0)
            r3 = m[:3, :3] / np.maximum(s, 1e-9)
            q = _mat_to_quat(r3)
            e = scene.create_node(parent_e, t, q, s, name=nd.get("name", ""))
        else:
            e = scene.create_node(
                parent_e, nd.get("translation", (0, 0, 0)),
                nd.get("rotation", (0, 0, 0, 1)), nd.get("scale", (1, 1, 1)),
                name=nd.get("name", ""))
        created[ni] = e
        if "mesh" in nd:
            sk = skin_ids[nd["skin"]] if "skin" in nd and skin_ids else -1
            for mid, mat in mesh_prims[nd["mesh"]]:
                scene.create_renderable(mid, mat, parent=e, skeleton_id=sk)
        for ch in nd.get("children", []):
            build_node(ch, e)

    roots = gltf.get("scenes", [{}])[gltf.get("scene", 0)].get("nodes", [])
    for r in roots:
        build_node(r, parent)

    # Animations.
    clips = []
    if skeletons is not None:
        for anim in gltf.get("animations", []):
            for skin_idx, skin in enumerate(gltf.get("skins", [])):
                node_to_joint = {n: j for j, n in enumerate(skin["joints"])}
                channels = []
                for ch in anim.get("channels", []):
                    tgt = ch["target"]
                    node = tgt.get("node")
                    if node not in node_to_joint:
                        continue
                    smp = anim["samplers"][ch["sampler"]]
                    times = rd.accessor(smp["input"]).astype(np.float32)
                    vals = rd.accessor(smp["output"]).astype(np.float32)
                    channels.append(Channel(
                        node_to_joint[node], tgt["path"], times, vals,
                        smp.get("interpolation", "LINEAR")))
                if channels and skin_ids[skin_idx] >= 0:
                    clip = AnimationClip(anim.get("name", "clip"), channels)
                    skeletons.add_clip(skin_ids[skin_idx], clip)
                    clips.append(clip)
    return {"clips": clips, "nodes": created}


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
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


def load_obj(path: str, scene: Scene, meshes: MeshRegistry,
             materials: MaterialRegistry,
             parent: Optional[int] = None) -> int:
    """Minimal OBJ loader (v/vn/vt/f, triangulated fans)."""
    vs, vns, vts = [], [], []
    corners = []   # (vi, ti, ni)
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                vs.append([float(x) for x in p[1:4]])
            elif p[0] == "vn":
                vns.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                vts.append([float(x) for x in p[1:3]])
            elif p[0] == "f":
                face = []
                for tok in p[1:]:
                    comp = (tok.split("/") + ["", ""])[:3]
                    vi = int(comp[0]) - 1
                    ti = int(comp[1]) - 1 if comp[1] else -1
                    ni = int(comp[2]) - 1 if comp[2] else -1
                    face.append((vi, ti, ni))
                for k in range(1, len(face) - 1):
                    corners += [face[0], face[k], face[k + 1]]
    n = len(corners)
    pos = np.array([vs[c[0]] for c in corners], np.float32)
    uv = np.array([vts[c[1]] if c[1] >= 0 else (0, 0) for c in corners],
                  np.float32)
    if vns and all(c[2] >= 0 for c in corners):
        nrm = np.array([vns[c[2]] for c in corners], np.float32)
    else:
        from .mesh import compute_normals
        nrm = None
    idx = np.arange(n, dtype=np.int32).reshape(-1, 3)
    md = MeshData(pos, nrm if nrm is not None else np.zeros_like(pos), uv, idx,
                  name=os.path.basename(path))
    if nrm is None:
        from .mesh import compute_normals
        md.normals = compute_normals(md.positions, md.indices)
    mid = meshes.add(md)
    return scene.create_renderable(mid, 0, parent=parent)


def load_model(path: str, scene: Scene, meshes: MeshRegistry,
               materials: MaterialRegistry,
               skeletons: Optional[SkeletonRegistry] = None,
               parent: Optional[int] = None, textures=None):
    """Format dispatch (reference: ModelLoader.cpp:14-45)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        return load_gltf(path, scene, meshes, materials, skeletons, parent,
                         textures=textures)
    if ext == ".obj":
        return load_obj(path, scene, meshes, materials, parent)
    if ext == ".usdz":
        from .usdc import load_usdz
        return load_usdz(path, scene, meshes, materials, parent)
    if ext in (".usda", ".usd", ".usdc"):
        # .usd can be either ASCII or crate: sniff the magic.
        with open(path, "rb") as f:
            head = f.read(8)
        if head == b"PXR-USDC":
            from .usdc import load_usdc
            return load_usdc(path, scene, meshes, materials, parent)
        from .usd import load_usda
        return load_usda(path, scene, meshes, materials, parent)
    if ext == ".fbx":
        from .fbx import load_fbx
        return load_fbx(path, scene, meshes, materials, skeletons, parent,
                        textures=textures)
    if ext == ".dae":
        from .meshformats import load_dae
        return load_dae(path, scene, meshes, materials, parent)
    if ext == ".ply":
        from .meshformats import load_ply
        return load_ply(path, scene, meshes, materials, parent)
    if ext == ".stl":
        from .meshformats import load_stl
        return load_stl(path, scene, meshes, materials, parent)
    if ext == ".nif":
        from .nif import load_nif
        return load_nif(path, scene, meshes, materials, skeletons, parent,
                        textures=textures)
    raise ValueError(f"unsupported model format: {ext} (supported: .gltf, "
                     ".glb, .obj, .usda, .usdc, .usdz, .fbx, .dae, .ply, "
                     ".stl, .nif)")

