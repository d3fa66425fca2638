"""Minimal USD (.usda ASCII) importer: Mesh prims, transforms, materials.

Port of basicrenderer_tpu/models/usd.py, copied with its behaviour
unchanged. A self-contained parser for the ASCII subset that mesh
interchange uses — `def Xform/Mesh` prim trees, `points`,
`faceVertexIndices`/`faceVertexCounts` (triangulated by fan), `normals`,
`primvars:st`, `xformOp:translate/scale/rotateXYZ/transform`, and
`UsdPreviewSurface` materials (diffuseColor, metallic, roughness,
emissiveColor) bound via `material:binding`. Binary crates and .usdz
packages go through models/usdc.py.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np

from ..scene.scene import Scene
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry, compute_normals


class _Prim:
    def __init__(self, kind: str, name: str):
        self.kind = kind
        self.name = name
        self.attrs: Dict[str, str] = {}
        self.children: List["_Prim"] = []


def _parse_usda(text: str) -> List[_Prim]:
    """Brace-tracking block parser: builds the prim tree; each prim's
    DIRECT body text (attribute lines, child bodies excluded) accumulates
    in attrs['__body__'] for lazy decoding."""
    prim_re = re.compile(r'(?:def|over)\s+(\w+)\s+"([^"]+)"[^{]*\{')
    root: List[_Prim] = []
    stack: List[_Prim] = []   # (prim) — every stack entry owns one '{'
    pos = 0
    n = len(text)
    while pos < n:
        m = prim_re.search(text, pos)
        close = text.find("}", pos)
        opener = text.find("{", pos)
        # A plain '{' (dictionary/variantSet) before any prim def: treat
        # as an anonymous block belonging to the current prim.
        next_struct = min(x for x in (m.start() if m else n,
                                      close if close != -1 else n,
                                      opener if opener != -1 else n))
        seg = text[pos:next_struct]
        if stack:
            stack[-1].attrs["__body__"] = stack[-1].attrs.get("__body__", "") + seg
        if next_struct == n:
            break
        if m and next_struct == m.start():
            prim = _Prim(m.group(1), m.group(2))
            (stack[-1].children if stack else root).append(prim)
            stack.append(prim)
            pos = m.end()
        elif next_struct == opener:
            # Anonymous block: attach its contents to the SAME prim.
            if stack:
                stack.append(stack[-1])
            else:
                stack.append(_Prim("__anon__", ""))
            pos = opener + 1
        else:
            if stack:
                stack.pop()
            pos = close + 1
    return root


_NUMS = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _floats(s: str) -> np.ndarray:
    return np.asarray([float(x) for x in _NUMS.findall(s)], np.float64)


def _attr_block(body: str, name: str) -> Optional[str]:
    """Raw value text of `... name = [...]` or `name = (...)`/scalar."""
    m = re.search(re.escape(name) + r"\s*=\s*", body)
    if not m:
        return None
    rest = body[m.end():]
    if rest.lstrip().startswith("["):
        i = rest.index("[")
        depth = 0
        for j in range(i, len(rest)):
            if rest[j] == "[":
                depth += 1
            elif rest[j] == "]":
                depth -= 1
                if depth == 0:
                    return rest[i:j + 1]
    return rest.splitlines()[0]


def _prim_xform(body: str) -> np.ndarray:
    """Compose xformOps into a 4x4 (row-vector-on-right convention)."""
    M = np.eye(4)
    t = _attr_block(body, "xformOp:translate")
    s = _attr_block(body, "xformOp:scale")
    rot = _attr_block(body, "xformOp:rotateXYZ")
    mat = _attr_block(body, "xformOp:transform")
    if mat is not None:
        v = _floats(mat)
        if len(v) >= 16:
            M = v[:16].reshape(4, 4).T   # usd stores row-major row-vectors
            return M
    if s is not None and len(_floats(s)) >= 3:
        v = _floats(s)[:3]
        M = M @ np.diag([v[0], v[1], v[2], 1.0])
    if rot is not None and len(_floats(rot)) >= 3:
        rx, ry, rz = np.radians(_floats(rot)[:3])
        for axis, ang in (([1, 0, 0], rx), ([0, 1, 0], ry), ([0, 0, 1], rz)):
            c, si = math.cos(ang), math.sin(ang)
            x, y, z = axis
            R = np.eye(4)
            K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float64)
            R[:3, :3] = np.eye(3) + si * K + (1 - c) * (K @ K)
            M = R @ M
    if t is not None and len(_floats(t)) >= 3:
        T = np.eye(4)
        T[:3, 3] = _floats(t)[:3]
        M = T @ M
    return M


def _find_materials(roots: List[_Prim]) -> Dict[str, Material]:
    """path -> Material for every Material prim (UsdPreviewSurface)."""
    out: Dict[str, Material] = {}

    def walk(prim: _Prim, path: str):
        p = f"{path}/{prim.name}"
        if prim.kind == "Material":
            body = prim.attrs.get("__body__", "")
            for ch in prim.children:
                body += ch.attrs.get("__body__", "")
            mat = Material(name=prim.name)
            dc = _attr_block(body, "inputs:diffuseColor")
            if dc is not None and len(_floats(dc)) >= 3:
                mat.base_color = np.asarray(
                    list(_floats(dc)[:3]) + [1.0], np.float32)
            for key, attr in (("inputs:metallic", "metallic"),
                              ("inputs:roughness", "roughness"),
                              ("inputs:opacityThreshold", "alpha_cutoff")):
                v = _attr_block(body, key)
                if v is not None and len(_floats(v)) >= 1:
                    setattr(mat, attr, float(_floats(v)[0]))
            ec = _attr_block(body, "inputs:emissiveColor")
            if ec is not None and len(_floats(ec)) >= 3:
                mat.emissive = _floats(ec)[:3].astype(np.float32)
            out[p] = mat
        for ch in prim.children:
            walk(ch, p)

    for r in roots:
        walk(r, "")
    return out


def load_usda(path: str, scene: Scene, meshes: MeshRegistry,
              materials: MaterialRegistry, parent: Optional[int] = None
              ) -> List[int]:
    """Load a .usda stage into the scene. Returns created entities."""
    if path.endswith((".usdc", ".usdz")):
        raise ValueError("binary USD: use models.usdc.load_usdc/load_usdz "
                         "(importers.load_model dispatches automatically)")
    with open(path) as f:
        text = f.read()
    roots = _parse_usda(text)
    mats = _find_materials(roots)
    mat_ids: Dict[str, int] = {}
    created: List[int] = []

    def mat_id_for(binding: Optional[str]) -> int:
        if binding is None:
            return 0
        if binding not in mat_ids:
            m = mats.get(binding)
            mat_ids[binding] = materials.add(m) if m is not None else 0
        return mat_ids[binding]

    def walk(prim: _Prim, parent_e: Optional[int], path: str):
        p = f"{path}/{prim.name}"
        body = prim.attrs.get("__body__", "")
        if prim.kind in ("Xform", "Scope", "Mesh"):
            M = _prim_xform(body)
            t = M[:3, 3]
            s = np.linalg.norm(M[:3, :3], axis=0)
            r3 = M[:3, :3] / np.maximum(s, 1e-12)
            from .importers import _mat_to_quat
            e = scene.create_node(parent_e, tuple(t), tuple(_mat_to_quat(r3)),
                                  tuple(s), name=prim.name)
            created.append(e)
        else:
            e = parent_e
        if prim.kind == "Mesh":
            pts = _attr_block(body, "point3f[] points") or \
                _attr_block(body, "points")
            idx = _attr_block(body, "faceVertexIndices")
            cnt = _attr_block(body, "faceVertexCounts")
            if pts and idx and cnt:
                P = _floats(pts).reshape(-1, 3).astype(np.float32)
                I = _floats(idx).astype(np.int32)
                C = _floats(cnt).astype(np.int32)
                tris = []
                o = 0
                for c in C:
                    c = int(c)
                    for k in range(1, c - 1):   # fan triangulation
                        tris.append((I[o], I[o + k], I[o + k + 1]))
                    o += c
                T = np.asarray(tris, np.int32).reshape(-1, 3)
                nrm_s = _attr_block(body, "normals")
                uv_s = _attr_block(body, "primvars:st")
                uv = np.zeros((len(P), 2), np.float32)
                if uv_s is not None:
                    st = _floats(uv_s).reshape(-1, 2).astype(np.float32)
                    if len(st) == len(P):
                        uv = st
                if nrm_s is not None:
                    nr = _floats(nrm_s).reshape(-1, 3).astype(np.float32)
                    nrm = nr if len(nr) == len(P) else compute_normals(P, T)
                else:
                    nrm = compute_normals(P, T)
                md = MeshData(P, nrm, uv, T, name=prim.name)
                mid = meshes.add(md)
                b = re.search(r'material:binding\s*=\s*<([^>]+)>', body)
                scene.create_renderable(mid, mat_id_for(b.group(1) if b
                                                        else None), parent=e)
        for ch in prim.children:
            walk(ch, e, p)

    for r in roots:
        walk(r, parent, "")
    return created
