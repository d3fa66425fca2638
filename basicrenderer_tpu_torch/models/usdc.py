"""Binary USD crate (.usdc) reader + writer, and .usdz (zip) packaging.

Port of basicrenderer_tpu/models/usdc.py, copied with its behaviour
unchanged: the same bytes written, the same stage read. A self-contained
implementation of the crate CONTAINER format (no USD SDK) — bootstrap
header, table-of-contents, TOKENS / STRINGS / FIELDS / FIELDSETS / PATHS /
SPECS sections, 64-bit ValueRep encoding (type | array/inline/compressed
bits | 48-bit payload), and the path-tree encoding.

Two section generations are supported:

- **legacy (0.0.1)**: plain uncompressed sections.
- **modern (0.4.0 — 0.9.x)**: what every pxr build since USD 19.x
  writes — TOKENS as an lz4 blob, FIELDS/FIELDSETS/PATHS/SPECS as
  delta+lz4 compressed integer streams (models/crate_codec.py), array
  values optionally compressed (ints: delta codec; floats: 'i' integer
  or 't' lookup-table form), 64-bit array sizes from 0.7.0. The writer
  emits version 0.8.0 by default.

Value model: each prim is a Spec (SpecType Prim) whose fieldset carries
``specifier`` and ``typeName``; each attribute is its own Spec (SpecType
Attribute) at ``<prim>.<name>`` with a ``default`` field; relationships
(``material:binding``) are Specs (SpecType Relationship) with a
``targetPaths`` path-list-op field. This mirrors how SdfData lays out a
flattened stage, which is what the scene builder below consumes.
"""

from __future__ import annotations

import dataclasses
import struct
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..scene.scene import Scene
from . import crate_codec as cc
from .materials import Material, MaterialRegistry
from .mesh import MeshData, MeshRegistry, compute_normals

MAGIC = b"PXR-USDC"
_BOOTSTRAP = 88          # magic(8) + version(8) + tocOffset(8) + reserved(64)

# --- ValueRep type enums (the crate data-type table; ids must match what
# pxr writes so real .usdc files decode) ----------------------------------
T_BOOL, T_UCHAR, T_INT, T_UINT, T_INT64, T_UINT64 = 1, 2, 3, 4, 5, 6
T_HALF, T_FLOAT, T_DOUBLE, T_STRING, T_TOKEN, T_ASSET = 7, 8, 9, 10, 11, 12
T_QUATD, T_QUATF, T_QUATH = 13, 14, 15
T_VEC2D, T_VEC2F, T_VEC2H, T_VEC2I = 16, 17, 18, 19
T_VEC3D, T_VEC3F, T_VEC3H, T_VEC3I = 20, 21, 22, 23
T_VEC4D, T_VEC4F, T_VEC4H, T_VEC4I = 24, 25, 26, 27
T_MATRIX2D, T_MATRIX3D, T_MATRIX4D = 28, 29, 30
T_DICTIONARY = 31
T_TOKEN_LIST_OP, T_STRING_LIST_OP, T_PATH_LIST_OP = 32, 33, 34
T_REFERENCE_LIST_OP, T_INT_LIST_OP = 35, 36
T_PATH_VECTOR, T_TOKEN_VECTOR = 40, 41
T_SPECIFIER, T_PERMISSION, T_VARIABILITY = 42, 43, 44
T_VARIANT_SELECTION_MAP, T_TIME_SAMPLES, T_PAYLOAD = 45, 46, 47
T_DOUBLE_VECTOR, T_LAYER_OFFSET_VECTOR, T_STRING_VECTOR = 48, 49, 50
T_VALUE_BLOCK, T_VALUE = 51, 52

_ARRAY_BIT = 1 << 63
_INLINE_BIT = 1 << 62
_COMPRESSED_BIT = 1 << 61
_PAYLOAD_MASK = (1 << 48) - 1

# SpecTypes (SdfSpecType values)
SPEC_ATTRIBUTE, SPEC_PRIM, SPEC_PSEUDO_ROOT, SPEC_RELATIONSHIP = 1, 6, 7, 8

# Specifier enum
SPECIFIER_DEF, SPECIFIER_OVER, SPECIFIER_CLASS = 0, 1, 2

# SdfListOp header flag bits (crate serialization).
_LISTOP_EXPLICIT = 1 << 0
_LISTOP_HAS_EXPLICIT = 1 << 1
_LISTOP_HAS_ADDED = 1 << 2
_LISTOP_HAS_DELETED = 1 << 3
_LISTOP_HAS_ORDERED = 1 << 4
_LISTOP_HAS_PREPENDED = 1 << 5
_LISTOP_HAS_APPENDED = 1 << 6

_ARRAY_DTYPES = {
    T_UCHAR: (np.uint8, 1), T_INT: (np.int32, 1), T_UINT: (np.uint32, 1),
    T_INT64: (np.int64, 1), T_UINT64: (np.uint64, 1),
    T_HALF: (np.float16, 1), T_FLOAT: (np.float32, 1),
    T_DOUBLE: (np.float64, 1),
    T_VEC2F: (np.float32, 2), T_VEC3F: (np.float32, 3),
    T_VEC4F: (np.float32, 4),
    T_VEC2D: (np.float64, 2), T_VEC3D: (np.float64, 3),
    T_VEC4D: (np.float64, 4),
    T_VEC2I: (np.int32, 2), T_VEC3I: (np.int32, 3), T_VEC4I: (np.int32, 4),
    T_VEC2H: (np.float16, 2), T_VEC3H: (np.float16, 3),
    T_VEC4H: (np.float16, 4),
    T_QUATF: (np.float32, 4), T_QUATD: (np.float64, 4),
    T_MATRIX4D: (np.float64, 16), T_MATRIX3D: (np.float64, 9),
    T_MATRIX2D: (np.float64, 4),
}
# Scalar int/float array types eligible for the compressed-array forms.
_COMPRESSIBLE_INTS = {T_INT: False, T_UINT: False,
                      T_INT64: True, T_UINT64: True}   # -> wide codec flag
_COMPRESSIBLE_FLOATS = (T_FLOAT, T_DOUBLE)


@dataclasses.dataclass
class UsdPrim:
    """Writer-side prim description: a typed prim plus typed attributes.

    attrs values: float / int / str(token) / np.ndarray (shape (N,),
    (N,2), (N,3), (N,4) float32 or (N,) int32, or (4,4) float64 matrix)
    / list[str] (token vector). rels values: target path strings.
    """
    path: str                      # e.g. "/World/quad"
    type_name: str                 # "Xform" | "Mesh" | "Material" | ...
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    rels: Dict[str, str] = dataclasses.field(default_factory=dict)


# =========================================================================
# Writer
# =========================================================================

class _CrateWriter:
    def __init__(self, modern: bool = True):
        self.modern = modern           # emit 0.8.0 compressed-array forms
        self.tokens: List[str] = [""]
        self._tok_ix: Dict[str, int] = {"": 0}
        self.fields: List[Tuple[int, int]] = []        # (tokenIndex, rep)
        self._field_ix: Dict[Tuple[int, int], int] = {}
        self.fieldsets: List[int] = []                 # flat, 0xFFFFFFFF ends
        self.specs: List[Tuple[int, int, int]] = []    # (path, fset, type)
        self.body = bytearray()                        # value heap

    def token(self, s: str) -> int:
        if s not in self._tok_ix:
            self._tok_ix[s] = len(self.tokens)
            self.tokens.append(s)
        return self._tok_ix[s]

    def _heap(self, raw: bytes) -> int:
        # 8-align value payloads so doubles read back aligned.
        while len(self.body) % 8:
            self.body.append(0)
        off = _BOOTSTRAP + len(self.body)
        self.body += raw
        return off

    def rep_for(self, v: object) -> int:
        if isinstance(v, bool):
            return (T_BOOL << 48) | _INLINE_BIT | int(v)
        if isinstance(v, int):
            if -(1 << 31) <= v < (1 << 31):
                # Inline ints carry two's complement in the low 32 bits.
                return (T_INT << 48) | _INLINE_BIT | (v & 0xFFFFFFFF)
            return (T_INT64 << 48) | self._heap(struct.pack("<q", v))
        if isinstance(v, float):
            bits = struct.unpack("<I", struct.pack("<f", np.float32(v)))[0]
            if struct.unpack("<f", struct.pack("<f", np.float32(v)))[0] == v:
                return (T_FLOAT << 48) | _INLINE_BIT | bits
            return (T_DOUBLE << 48) | self._heap(struct.pack("<d", v))
        if isinstance(v, str):
            return (T_TOKEN << 48) | _INLINE_BIT | self.token(v)
        if isinstance(v, (list, tuple)) and all(isinstance(x, str) for x in v):
            raw = struct.pack("<Q", len(v)) + b"".join(
                struct.pack("<I", self.token(x)) for x in v)
            return (T_TOKEN_VECTOR << 48) | self._heap(raw)
        if isinstance(v, np.ndarray):
            if v.shape == (4, 4) and v.dtype == np.float64:
                return (T_MATRIX4D << 48) | self._heap(v.tobytes())
            t = self._array_type(v)
            n = v.shape[0]
            if self.modern:
                rep = self._compressed_array_rep(t, v, n)
                if rep is not None:
                    return rep
            raw = struct.pack("<Q", n) + np.ascontiguousarray(v).tobytes()
            return (t << 48) | _ARRAY_BIT | self._heap(raw)
        raise TypeError(f"unsupported crate value: {type(v)}")

    def _compressed_array_rep(self, t: int, v: np.ndarray,
                              n: int) -> Optional[int]:
        """The 0.5.0/0.6.0 compressed scalar-array forms when profitable
        (same policy as pxr: only 1-lane int/float arrays of >=16 elems)."""
        if v.ndim != 1 or n < 16:
            return None
        if t in _COMPRESSIBLE_INTS:
            blob = cc.compress_ints(v, wide=_COMPRESSIBLE_INTS[t])
            raw = struct.pack("<QQ", n, len(blob)) + blob
            return (t << 48) | _ARRAY_BIT | _COMPRESSED_BIT | self._heap(raw)
        if t in _COMPRESSIBLE_FLOATS:
            as_int = v.astype(np.int32)
            if np.array_equal(as_int.astype(v.dtype), v):
                blob = cc.compress_ints(as_int)
                raw = struct.pack("<Q", n) + b"i" \
                    + struct.pack("<Q", len(blob)) + blob
                return ((t << 48) | _ARRAY_BIT | _COMPRESSED_BIT
                        | self._heap(raw))
            lut, inv = np.unique(v, return_inverse=True)
            if len(lut) <= min(n // 4, 1 << 12):
                blob = cc.compress_ints(inv.astype(np.int32))
                raw = (struct.pack("<Q", n) + b"t"
                       + struct.pack("<I", len(lut))
                       + np.ascontiguousarray(lut).tobytes()
                       + struct.pack("<Q", len(blob)) + blob)
                return ((t << 48) | _ARRAY_BIT | _COMPRESSED_BIT
                        | self._heap(raw))
        return None

    @staticmethod
    def _array_type(v: np.ndarray) -> int:
        lanes = 1 if v.ndim == 1 else v.shape[1]
        for t, (dt, ln) in _ARRAY_DTYPES.items():
            if v.dtype == dt and lanes == ln:
                return t
        raise TypeError(f"unsupported array {v.dtype} x{lanes}")

    def rep_specifier(self, s: int) -> int:
        return (T_SPECIFIER << 48) | _INLINE_BIT | s

    def rep_path_list(self, path_indexes: List[int]) -> int:
        # SdfPathListOp: flags byte (explicit + has-explicit-items) then
        # the explicit list as u64 count + u32 path indexes.
        raw = struct.pack("<BQ", _LISTOP_EXPLICIT | _LISTOP_HAS_EXPLICIT,
                          len(path_indexes)) + b"".join(
            struct.pack("<I", i) for i in path_indexes)
        return (T_PATH_LIST_OP << 48) | self._heap(raw)

    def field(self, name: str, rep: int) -> int:
        key = (self.token(name), rep)
        if key not in self._field_ix:
            self._field_ix[key] = len(self.fields)
            self.fields.append(key)
        return self._field_ix[key]

    def fieldset(self, field_indexes: List[int]) -> int:
        ix = len(self.fieldsets)
        self.fieldsets.extend(field_indexes)
        self.fieldsets.append(0xFFFFFFFF)
        return ix


def _path_parent(p: str) -> str:
    if "." in p:
        return p.rsplit(".", 1)[0]
    return p.rsplit("/", 1)[0] or "/"


def _path_element(p: str) -> Tuple[str, bool]:
    """(element token, is_property)."""
    if "." in p:
        return p.rsplit(".", 1)[1], True
    return p.rsplit("/", 1)[1], False


def _build_path_table(paths: List[str]) -> Tuple[List[str], Dict[str, int]]:
    """All paths incl. ancestors, DFS preorder from '/', + index map."""
    full = {"/"}
    for p in paths:
        while p != "/":
            full.add(p)
            p = _path_parent(p)
    kids: Dict[str, List[str]] = {p: [] for p in full}
    for p in sorted(full):
        if p != "/":
            kids[_path_parent(p)].append(p)
    order: List[str] = []

    def dfs(p: str):
        order.append(p)
        # Properties sort after child prims (writer convention only).
        for c in sorted(kids[p], key=lambda c: ("." in c, c)):
            dfs(c)

    dfs("/")
    return order, {p: i for i, p in enumerate(order)}


def _encode_paths(order: List[str], index: Dict[str, int],
                  w: _CrateWriter) -> bytes:
    """Iterative preorder emit with hasChild/hasSibling flags."""
    kids: Dict[str, List[str]] = {p: [] for p in order}
    for p in order:
        if p != "/":
            kids[_path_parent(p)].append(p)
    for p in kids:
        kids[p].sort(key=lambda c: index[c])
    sib_next: Dict[str, Optional[str]] = {}
    for p in order:
        cs = kids[p]
        for i, c in enumerate(cs):
            sib_next[c] = cs[i + 1] if i + 1 < len(cs) else None
    sib_next["/"] = None
    out = bytearray()
    for p in order:       # DFS preorder == emit order for this encoding
        has_child = bool(kids[p])
        has_sib = sib_next[p] is not None
        if p == "/":
            elem = 0
        else:
            tok, is_prop = _path_element(p)
            ti = w.token(tok)
            elem = -ti if is_prop else ti
        flags = (1 if has_child else 0) | (2 if has_sib else 0)
        out.extend(struct.pack("<IiB", index[p], elem, flags))
        if has_child and has_sib:
            out.extend(struct.pack("<q", 0))
    return bytes(out)


def _encode_paths_modern(order: List[str], index: Dict[str, int],
                         w: _CrateWriter) -> bytes:
    """The 0.4.0+ PATHS payload: three delta+lz4 integer streams
    (pathIndexes, elementTokenIndexes, jumps) in stream order
    node → descendant subtree → sibling subtree. Jump semantics:
    >0 sibling offset (node also has a child), -1 child only,
    0 sibling only, -2 leaf."""
    kids: Dict[str, List[str]] = {p: [] for p in order}
    for p in order:
        if p != "/":
            kids[_path_parent(p)].append(p)
    for p in kids:
        kids[p].sort(key=lambda c: index[c])
    pi: List[int] = []
    eti: List[int] = []
    jumps: List[int] = []

    def emit(p: str, has_sib: bool) -> int:
        pos = len(pi)
        pi.append(index[p])
        if p == "/":
            eti.append(0)
        else:
            tok, is_prop = _path_element(p)
            ti = w.token(tok)
            eti.append(-ti if is_prop else ti)
        jumps.append(-2)
        cs = kids[p]
        size = 1
        for i, c in enumerate(cs):
            size += emit(c, i + 1 < len(cs))
        if cs:
            jumps[pos] = size if has_sib else -1
        elif has_sib:
            jumps[pos] = 0
        return size

    emit("/", False)

    def comp(vals, dtype):
        b = cc.compress_ints(np.asarray(vals, dtype))
        return struct.pack("<Q", len(b)) + b

    return (struct.pack("<Q", len(pi)) + comp(pi, np.uint32)
            + comp(eti, np.int32) + comp(jumps, np.int32))


def save_usdc(path: str, prims: List[UsdPrim],
              version: Tuple[int, int, int] = (0, 8, 0)) -> None:
    """Write a flattened stage of UsdPrims as a binary crate file.
    `version` (0,8,0) emits the modern compressed-section layout every
    pxr build reads; (0,0,1) emits the legacy uncompressed layout."""
    modern = version >= (0, 4, 0)
    w = _CrateWriter(modern)
    all_paths = ["/"]
    for pr in prims:
        all_paths.append(pr.path)
        for a in pr.attrs:
            all_paths.append(f"{pr.path}.{a}")
        for r in pr.rels:
            all_paths.append(f"{pr.path}.{r}")
    order, index = _build_path_table(all_paths)

    # Pseudo-root spec.
    root_fs = w.fieldset([])
    w.specs.append((index["/"], root_fs, SPEC_PSEUDO_ROOT))
    for pr in prims:
        fs = w.fieldset([
            w.field("specifier", w.rep_specifier(SPECIFIER_DEF)),
            w.field("typeName", w.rep_for(pr.type_name)),
        ])
        w.specs.append((index[pr.path], fs, SPEC_PRIM))
        for name, val in pr.attrs.items():
            afs = w.fieldset([w.field("default", w.rep_for(val))])
            w.specs.append((index[f"{pr.path}.{name}"], afs, SPEC_ATTRIBUTE))
        for name, target in pr.rels.items():
            rfs = w.fieldset([w.field(
                "targetPaths", w.rep_path_list([index[target]]))])
            w.specs.append((index[f"{pr.path}.{name}"], rfs,
                            SPEC_RELATIONSHIP))

    if modern:
        paths_blob = struct.pack("<Q", len(order)) + _encode_paths_modern(
            order, index, w)
    else:
        paths_blob = struct.pack("<Q", len(order)) + _encode_paths(
            order, index, w)

    def comp_ints(vals, dtype=np.uint32):
        b = cc.compress_ints(np.asarray(vals, dtype))
        return struct.pack("<Q", len(b)) + b

    # Assemble sections AFTER the value heap (tokens got created during
    # path encoding too, so tokens must serialize last).
    sections: List[Tuple[bytes, bytes]] = []
    tok_raw = b"\0".join(t.encode() for t in w.tokens) + b"\0"
    if modern:
        tok_comp = cc.tf_compress(tok_raw)
        tok_blob = struct.pack("<QQQ", len(w.tokens), len(tok_raw),
                               len(tok_comp)) + tok_comp
    else:
        tok_blob = struct.pack("<Q", len(w.tokens)) + tok_raw
    sections.append((b"TOKENS", tok_blob))
    sections.append((b"STRINGS", struct.pack("<Q", 0)))
    if modern:
        reps_raw = np.asarray([rep for _, rep in w.fields],
                              np.uint64).tobytes()
        reps_comp = cc.tf_compress(reps_raw)
        f_blob = (struct.pack("<Q", len(w.fields))
                  + comp_ints([ti for ti, _ in w.fields])
                  + struct.pack("<Q", len(reps_comp)) + reps_comp)
        fs_blob = struct.pack("<Q", len(w.fieldsets)) + comp_ints(
            w.fieldsets)
        sp_blob = (struct.pack("<Q", len(w.specs))
                   + comp_ints([s[0] for s in w.specs])
                   + comp_ints([s[1] for s in w.specs])
                   + comp_ints([s[2] for s in w.specs]))
    else:
        f_blob = struct.pack("<Q", len(w.fields)) + b"".join(
            struct.pack("<IIQ", ti, 0, rep) for ti, rep in w.fields)
        fs_blob = struct.pack("<Q", len(w.fieldsets)) + np.asarray(
            w.fieldsets, np.uint32).tobytes()
        sp_blob = struct.pack("<Q", len(w.specs)) + b"".join(
            struct.pack("<III", *s) for s in w.specs)
    sections.append((b"FIELDS", f_blob))
    sections.append((b"FIELDSETS", fs_blob))
    sections.append((b"PATHS", paths_blob))
    sections.append((b"SPECS", sp_blob))

    with open(path, "wb") as f:
        f.write(MAGIC + bytes(version) + bytes(5))
        f.write(struct.pack("<q", 0))          # tocOffset placeholder
        f.write(bytes(64))
        f.write(bytes(w.body))
        toc_entries = []
        for name, blob in sections:
            start = f.tell()
            f.write(blob)
            toc_entries.append((name, start, len(blob)))
        toc_off = f.tell()
        f.write(struct.pack("<q", len(toc_entries)))
        for name, start, size in toc_entries:
            f.write(name.ljust(16, b"\0") + struct.pack("<qq", start, size))
        f.seek(16)
        f.write(struct.pack("<q", toc_off))


def save_usdz(path: str, prims: List[UsdPrim],
              layer_name: str = "stage.usdc") -> None:
    """Package a crate layer into .usdz (zip, STORED entries only)."""
    import io
    import os
    import tempfile
    tmp = tempfile.NamedTemporaryFile(suffix=".usdc", delete=False)
    tmp.close()
    try:
        save_usdc(tmp.name, prims)
        with open(tmp.name, "rb") as f:
            blob = f.read()
    finally:
        os.unlink(tmp.name)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr(layer_name, blob)


# =========================================================================
# Reader
# =========================================================================

class CrateError(ValueError):
    pass


class _CrateReader:
    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != MAGIC:
            raise CrateError("not a usdc file")
        self.ver = tuple(data[8:11])
        if self.ver >= (0, 10, 0):
            raise CrateError(
                f"usdc version {self.ver[0]}.{self.ver[1]}.{self.ver[2]} "
                "is newer than this reader (0.9.x max)")
        self.modern = self.ver >= (0, 4, 0)
        (toc_off,) = struct.unpack_from("<q", data, 16)
        (n,) = struct.unpack_from("<q", data, toc_off)
        self.sections: Dict[bytes, Tuple[int, int]] = {}
        o = toc_off + 8
        for _ in range(n):
            name = data[o:o + 16].rstrip(b"\0")
            start, size = struct.unpack_from("<qq", data, o + 16)
            self.sections[name] = (start, size)
            o += 32
        self.tokens = self._read_tokens()
        self.strings = self._read_strings()
        self.fields = self._read_fields()
        self.fieldsets = self._read_fieldsets()
        self.paths = self._read_paths()
        self.specs = self._read_specs()

    def _sec(self, name: bytes) -> bytes:
        if name not in self.sections:
            raise CrateError(f"missing section {name!r}")
        s, z = self.sections[name]
        return self.data[s:s + z]

    @staticmethod
    def _comp_ints(b: bytes, off: int, n: int,
                   wide: bool = False) -> Tuple[np.ndarray, int]:
        """One _CompressedIntsReader block: u64 compressedSize + blob."""
        (csz,) = struct.unpack_from("<Q", b, off)
        vals = cc.decompress_ints(b[off + 8:off + 8 + csz], n, wide)
        return vals, off + 8 + csz

    def _read_tokens(self) -> List[str]:
        b = self._sec(b"TOKENS")
        (n,) = struct.unpack_from("<Q", b, 0)
        if self.modern:
            raw_size, comp_size = struct.unpack_from("<QQ", b, 8)
            raw = cc.tf_decompress(b[24:24 + comp_size], raw_size)
        else:
            raw = b[8:]
        parts = raw.split(b"\0")
        return [p.decode("utf-8", "replace") for p in parts[:n]]

    def _read_strings(self) -> List[int]:
        if b"STRINGS" not in self.sections:
            return []
        b = self._sec(b"STRINGS")
        (n,) = struct.unpack_from("<Q", b, 0)
        return list(np.frombuffer(b, np.uint32, count=n, offset=8))

    def _read_fields(self) -> List[Tuple[int, int]]:
        b = self._sec(b"FIELDS")
        (n,) = struct.unpack_from("<Q", b, 0)
        if not self.modern:
            return [struct.unpack_from("<IIQ", b, 8 + 16 * i)[::2]
                    for i in range(n)]
        tok_ix, off = self._comp_ints(b, 8, n)
        (reps_size,) = struct.unpack_from("<Q", b, off)
        reps_raw = cc.tf_decompress(b[off + 8:off + 8 + reps_size], 8 * n)
        reps = np.frombuffer(reps_raw, np.uint64, n)
        return [(int(np.uint32(tok_ix[i])), int(reps[i])) for i in range(n)]

    def _read_fieldsets(self) -> List[int]:
        b = self._sec(b"FIELDSETS")
        (n,) = struct.unpack_from("<Q", b, 0)
        if not self.modern:
            return list(np.frombuffer(b, np.uint32, count=n, offset=8))
        vals, _ = self._comp_ints(b, 8, n)
        return list(vals.astype(np.int64) & 0xFFFFFFFF)

    def _read_paths(self) -> List[str]:
        b = self._sec(b"PATHS")
        (n,) = struct.unpack_from("<Q", b, 0)
        if self.modern:
            return self._read_paths_modern(b, n)
        paths: Dict[int, str] = {}
        pos = [8]

        def read_node(parent: str):
            ix, elem, flags = struct.unpack_from("<IiB", b, pos[0])
            pos[0] += 9
            has_child, has_sib = bool(flags & 1), bool(flags & 2)
            if has_child and has_sib:
                pos[0] += 8                       # sibling offset (unused)
            if elem == 0 and parent == "":
                p = "/"
            elif elem < 0:
                p = f"{parent}.{self.tokens[-elem]}"
            else:
                base = "" if parent == "/" else parent
                p = f"{base}/{self.tokens[elem]}"
            paths[ix] = p
            if has_child:
                read_node(p)
            if has_sib:
                read_node(parent)

        if n:
            read_node("")
        out = [""] * (max(paths) + 1)
        for i, p in paths.items():
            out[i] = p
        return out

    def _read_paths_modern(self, b: bytes, n: int) -> List[str]:
        """0.4.0+ path decoding: three compressed integer streams walked
        with the jump semantics (see _encode_paths_modern)."""
        (n_enc,) = struct.unpack_from("<Q", b, 8)
        pi, off = self._comp_ints(b, 16, n_enc)
        eti, off = self._comp_ints(b, off, n_enc)
        jumps, off = self._comp_ints(b, off, n_enc)
        pi = pi.astype(np.int64) & 0xFFFFFFFF
        paths: Dict[int, str] = {}
        # (start, parent) work stack; parent None marks the root entry.
        stack: List[Tuple[int, Optional[str]]] = [(0, None)]
        while stack:
            cur, parent = stack.pop()
            while True:
                j = int(jumps[cur])
                if parent is None:
                    p = "/"
                else:
                    ti = int(eti[cur])
                    tok = self.tokens[abs(ti)]
                    if ti < 0:
                        p = f"{parent}.{tok}"
                    else:
                        base = "" if parent == "/" else parent
                        p = f"{base}/{tok}"
                paths[int(pi[cur])] = p
                has_child = j > 0 or j == -1
                has_sib = j >= 0
                if has_child:
                    if has_sib:
                        stack.append((cur + j, parent))
                    parent = p
                    cur += 1
                elif has_sib:
                    cur += 1
                else:
                    break
        out = [""] * (max(paths) + 1 if paths else 0)
        for i, p in paths.items():
            out[i] = p
        return out

    def _read_specs(self) -> List[Tuple[int, int, int]]:
        b = self._sec(b"SPECS")
        (n,) = struct.unpack_from("<Q", b, 0)
        if not self.modern:
            return [struct.unpack_from("<III", b, 8 + 12 * i)
                    for i in range(n)]
        p_ix, off = self._comp_ints(b, 8, n)
        fs_ix, off = self._comp_ints(b, off, n)
        st, off = self._comp_ints(b, off, n)
        u = lambda a: (a.astype(np.int64) & 0xFFFFFFFF)
        p_ix, fs_ix, st = u(p_ix), u(fs_ix), u(st)
        return [(int(p_ix[i]), int(fs_ix[i]), int(st[i])) for i in range(n)]

    # --- value decoding --------------------------------------------------
    def _array_count(self, payload: int) -> Tuple[int, int]:
        """(count, offset-after-count). 64-bit sizes in 0.7.0+ and in the
        legacy layout this writer always used; 32-bit in 0.4.0-0.6.x."""
        if self.ver >= (0, 7, 0) or not self.modern:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            return cnt, payload + 8
        (cnt,) = struct.unpack_from("<I", self.data, payload)
        return cnt, payload + 4

    def _read_comp_block(self, off: int, n: int,
                         wide: bool = False) -> Tuple[np.ndarray, int]:
        (csz,) = struct.unpack_from("<Q", self.data, off)
        vals = cc.decompress_ints(self.data[off + 8:off + 8 + csz], n, wide)
        return vals, off + 8 + csz

    def _compressed_array(self, t: int, payload: int) -> np.ndarray:
        cnt, off = self._array_count(payload)
        if t in _COMPRESSIBLE_INTS:
            vals, _ = self._read_comp_block(off, cnt,
                                            _COMPRESSIBLE_INTS[t])
            return vals.astype(_ARRAY_DTYPES[t][0])
        dt = _ARRAY_DTYPES[t][0]
        code = self.data[off:off + 1]
        off += 1
        if code == b"i":                 # integers cast to float
            vals, _ = self._read_comp_block(off, cnt)
            return vals.astype(dt)
        if code == b"t":                 # lookup table + indexes
            (lut_n,) = struct.unpack_from("<I", self.data, off)
            off += 4
            lut = np.frombuffer(self.data, dt, lut_n, offset=off)
            off += lut_n * np.dtype(dt).itemsize
            ix, _ = self._read_comp_block(off, cnt)
            return lut[ix.astype(np.int64) & 0xFFFFFFFF]
        raise CrateError(f"unknown compressed-float code {code!r}")

    def _listop_items(self, payload: int, item_size: int,
                      path_items: bool) -> list:
        """SdfListOp payload: flags byte + one (u64 count + items) vector
        per present-flag. Returns explicit items if explicit, else
        prepended+added+appended (the flattened-stage cases are explicit)."""
        flags = self.data[payload]
        off = payload + 1
        lists: Dict[int, list] = {}
        for bit in (_LISTOP_HAS_EXPLICIT, _LISTOP_HAS_ADDED,
                    _LISTOP_HAS_PREPENDED, _LISTOP_HAS_APPENDED,
                    _LISTOP_HAS_DELETED, _LISTOP_HAS_ORDERED):
            if not flags & bit:
                continue
            (cnt,) = struct.unpack_from("<Q", self.data, off)
            off += 8
            ix = np.frombuffer(self.data, np.uint32, count=cnt, offset=off)
            off += cnt * item_size
            items = ([self.paths[i] for i in ix] if path_items
                     else [self.tokens[i] for i in ix])
            lists[bit] = items
        # Legacy files from this writer: flags==1 with the explicit list
        # following unflagged.
        if flags == _LISTOP_EXPLICIT and not lists and not self.modern:
            (cnt,) = struct.unpack_from("<Q", self.data, payload + 1)
            ix = np.frombuffer(self.data, np.uint32, count=cnt,
                               offset=payload + 9)
            return [self.paths[i] for i in ix]
        if flags & _LISTOP_EXPLICIT:
            return lists.get(_LISTOP_HAS_EXPLICIT, [])
        return (lists.get(_LISTOP_HAS_PREPENDED, [])
                + lists.get(_LISTOP_HAS_ADDED, [])
                + lists.get(_LISTOP_HAS_APPENDED, []))

    @staticmethod
    def _inline_vec(payload: int, lanes: int, dt) -> np.ndarray:
        """Inline vec values pack one signed byte per component."""
        raw = np.asarray([(payload >> (8 * i)) & 0xFF
                          for i in range(lanes)], np.uint8)
        return raw.view(np.int8).astype(dt)

    def value(self, rep: int) -> object:
        t = (rep >> 48) & 0xFF
        payload = rep & _PAYLOAD_MASK
        inline = bool(rep & _INLINE_BIT)
        if rep & _ARRAY_BIT:
            if t not in _ARRAY_DTYPES:
                raise CrateError(f"unsupported array type {t}")
            if rep & _COMPRESSED_BIT:
                return self._compressed_array(t, payload)
            dt, lanes = _ARRAY_DTYPES[t]
            cnt, off = self._array_count(payload)
            arr = np.frombuffer(self.data, dt, count=cnt * lanes,
                                offset=off)
            return arr.reshape(cnt, lanes) if lanes > 1 else arr.copy()
        if t == T_BOOL:
            return bool(payload & 1)
        if t == T_INT or t == T_UINT:
            if t == T_INT:                # sign-extend the low 32 bits
                return int(np.int32(np.uint32(payload & 0xFFFFFFFF)))
            return int(payload & 0xFFFFFFFF)
        if t == T_UCHAR:
            return int(payload & 0xFF)
        if t in (T_INT64, T_UINT64):
            if inline:
                v = int(np.int32(np.uint32(payload & 0xFFFFFFFF)))
                return v if t == T_INT64 else v & 0xFFFFFFFFFFFFFFFF
            fmt = "<q" if t == T_INT64 else "<Q"
            return struct.unpack_from(fmt, self.data, payload)[0]
        if t in (T_HALF, T_FLOAT, T_DOUBLE):
            if inline or t == T_FLOAT:
                # Doubles/halves inline as a float in the low 32 bits.
                f = struct.unpack("<f", struct.pack(
                    "<I", payload & 0xFFFFFFFF))[0]
                return float(f)
            dt = np.float64 if t == T_DOUBLE else np.float16
            return float(np.frombuffer(self.data, dt, 1, payload)[0])
        if t == T_STRING:
            # StringIndex -> token index via the STRINGS table.
            if self.strings and payload < len(self.strings):
                return self.tokens[self.strings[payload]]
            return self.tokens[payload]
        if t in (T_TOKEN, T_ASSET):
            return self.tokens[payload]
        if t in (T_SPECIFIER, T_PERMISSION, T_VARIABILITY):
            return int(payload)
        if t in (T_VEC2F, T_VEC3F, T_VEC4F, T_VEC2D, T_VEC3D, T_VEC4D,
                 T_VEC2H, T_VEC3H, T_VEC4H, T_VEC2I, T_VEC3I, T_VEC4I,
                 T_QUATF, T_QUATD):
            dt, lanes = _ARRAY_DTYPES[t]
            if inline:
                return self._inline_vec(payload, lanes, dt)
            return np.frombuffer(self.data, dt, lanes, payload).copy()
        if t in (T_MATRIX2D, T_MATRIX3D, T_MATRIX4D):
            side = {T_MATRIX2D: 2, T_MATRIX3D: 3, T_MATRIX4D: 4}[t]
            if inline:                    # int8 diagonal (e.g. identity)
                d = self._inline_vec(payload, side, np.float64)
                return np.diag(d)
            return np.frombuffer(self.data, np.float64, side * side,
                                 payload).reshape(side, side).copy()
        if t == T_TOKEN_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            ix = np.frombuffer(self.data, np.uint32, count=cnt,
                               offset=payload + 8)
            return [self.tokens[i] for i in ix]
        if t == T_PATH_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            ix = np.frombuffer(self.data, np.uint32, count=cnt,
                               offset=payload + 8)
            return [self.paths[i] for i in ix]
        if t == T_STRING_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            ix = np.frombuffer(self.data, np.uint32, count=cnt,
                               offset=payload + 8)
            return [self.value((T_STRING << 48) | int(i)) for i in ix]
        if t == T_DOUBLE_VECTOR:
            (cnt,) = struct.unpack_from("<Q", self.data, payload)
            return np.frombuffer(self.data, np.float64, count=cnt,
                                 offset=payload + 8).copy()
        if t == T_PATH_LIST_OP:
            return self._listop_items(payload, 4, path_items=True)
        if t == T_TOKEN_LIST_OP:
            return self._listop_items(payload, 4, path_items=False)
        if t == T_VALUE_BLOCK:
            return None
        if t == T_VALUE:
            # Recursive ValueRep: payload points at a heap u64 rep.
            (inner,) = struct.unpack_from("<Q", self.data, payload)
            return self.value(inner)
        raise CrateError(f"unsupported value type {t}")

    def spec_fields(self, fset: int) -> Dict[str, object]:
        out: Dict[str, object] = {}
        i = fset
        while i < len(self.fieldsets) and self.fieldsets[i] != 0xFFFFFFFF:
            ti, rep = self.fields[self.fieldsets[i]]
            # Tolerate field kinds outside the decoded set (dictionaries,
            # time samples, ...) — real-world stages carry plugin metadata
            # the scene builder never needs.
            try:
                out[self.tokens[ti]] = self.value(rep)
            except (CrateError, KeyError, IndexError, struct.error):
                pass
            i += 1
        return out


def read_usdc(data: bytes) -> List[UsdPrim]:
    """Decode crate bytes back into a flat UsdPrim list (DFS path order)."""
    r = _CrateReader(data)
    prims: Dict[str, UsdPrim] = {}
    for path_ix, fset, stype in r.specs:
        p = r.paths[path_ix]
        fields = r.spec_fields(fset)
        if stype == SPEC_PRIM:
            prims.setdefault(p, UsdPrim(p, "")).type_name = \
                fields.get("typeName", "")
        elif stype == SPEC_ATTRIBUTE and "." in p:
            prim_p, name = p.rsplit(".", 1)
            prims.setdefault(prim_p, UsdPrim(prim_p, ""))
            if "default" in fields:
                prims[prim_p].attrs[name] = fields["default"]
        elif stype == SPEC_RELATIONSHIP and "." in p:
            prim_p, name = p.rsplit(".", 1)
            prims.setdefault(prim_p, UsdPrim(prim_p, ""))
            targets = fields.get("targetPaths", [])
            if targets:
                prims[prim_p].rels[name] = targets[0]
    return [prims[p] for p in sorted(prims)]


# =========================================================================
# Scene building (shared by .usdc and .usdz entry points)
# =========================================================================

def _prims_to_scene(prims: List[UsdPrim], scene: Scene, meshes: MeshRegistry,
                    materials: MaterialRegistry,
                    parent: Optional[int]) -> List[int]:
    from .importers import _mat_to_quat
    by_path = {p.path: p for p in prims}
    mat_ids: Dict[str, int] = {}
    created: List[int] = []
    entity_of: Dict[str, Optional[int]] = {"/": parent}

    def mat_id_for(binding: Optional[str]) -> int:
        if binding is None:
            return 0
        if binding not in mat_ids:
            pr = by_path.get(binding)
            # UsdPreviewSurface inputs may live on a child Shader prim.
            srcs = [pr] if pr else []
            srcs += [q for q in prims
                     if q.path.startswith(binding + "/")]
            m = Material(name=binding.rsplit("/", 1)[-1])
            found = False
            for q in srcs:
                a = q.attrs
                if "inputs:diffuseColor" in a:
                    c = np.asarray(a["inputs:diffuseColor"], np.float32)
                    m.base_color = np.asarray(
                        list(c.reshape(-1)[:3]) + [1.0], np.float32)
                    found = True
                for key, field in (("inputs:metallic", "metallic"),
                                   ("inputs:roughness", "roughness"),
                                   ("inputs:opacityThreshold",
                                    "alpha_cutoff")):
                    if key in a:
                        setattr(m, field, float(np.asarray(a[key]).reshape(
                            -1)[0]))
                        found = True
                if "inputs:emissiveColor" in a:
                    m.emissive = np.asarray(
                        a["inputs:emissiveColor"], np.float32).reshape(-1)[:3]
                    found = True
            mat_ids[binding] = materials.add(m) if found else 0
        return mat_ids[binding]

    for pr in sorted(prims, key=lambda p: p.path.count("/")):
        if pr.type_name not in ("Xform", "Scope", "Mesh"):
            continue
        par = entity_of.get(_path_parent(pr.path), parent)
        M = np.asarray(pr.attrs.get("xformOp:transform", np.eye(4)),
                       np.float64)
        if M.shape != (4, 4):
            M = np.eye(4)
        else:
            M = M.T                 # usd stores row-major row-vector form
        t = M[:3, 3]
        s = np.linalg.norm(M[:3, :3], axis=0)
        r3 = M[:3, :3] / np.maximum(s, 1e-12)
        e = scene.create_node(par, tuple(t), tuple(_mat_to_quat(r3)),
                              tuple(s), name=pr.path.rsplit("/", 1)[-1])
        entity_of[pr.path] = e
        created.append(e)
        if pr.type_name != "Mesh":
            continue
        a = pr.attrs
        if "points" not in a or "faceVertexIndices" not in a:
            continue
        P = np.asarray(a["points"], np.float32).reshape(-1, 3)
        I = np.asarray(a["faceVertexIndices"], np.int32).reshape(-1)
        C = np.asarray(a.get("faceVertexCounts",
                             np.full(len(I) // 3, 3, np.int32)),
                       np.int32).reshape(-1)
        tris = []
        o = 0
        for c in C:
            c = int(c)
            for k in range(1, c - 1):
                tris.append((I[o], I[o + k], I[o + k + 1]))
            o += c
        T = np.asarray(tris, np.int32).reshape(-1, 3)
        uv = np.asarray(a.get("primvars:st", np.zeros((len(P), 2))),
                        np.float32).reshape(-1, 2)
        if len(uv) != len(P):
            uv = np.zeros((len(P), 2), np.float32)
        nrm = np.asarray(a.get("normals", ()), np.float32).reshape(-1, 3) \
            if "normals" in a else None
        if nrm is None or len(nrm) != len(P):
            nrm = compute_normals(P, T)
        md = MeshData(P, nrm, uv, T, name=pr.path.rsplit("/", 1)[-1])
        mid = meshes.add(md)
        scene.create_renderable(mid, mat_id_for(pr.rels.get(
            "material:binding")), parent=e)
    return created


def load_usdc(path: str, scene: Scene, meshes: MeshRegistry,
              materials: MaterialRegistry, parent: Optional[int] = None
              ) -> List[int]:
    with open(path, "rb") as f:
        data = f.read()
    return _prims_to_scene(read_usdc(data), scene, meshes, materials, parent)


def load_usdz(path: str, scene: Scene, meshes: MeshRegistry,
              materials: MaterialRegistry, parent: Optional[int] = None
              ) -> List[int]:
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith((".usdc", ".usda"))]
        if not names:
            raise CrateError(".usdz contains no usd layer")
        blob = z.read(names[0])
    if blob[:8] == MAGIC:
        return _prims_to_scene(read_usdc(blob), scene, meshes, materials,
                               parent)
    # ASCII layer inside the zip: write-through to the usda parser.
    import tempfile
    import os
    tmp = tempfile.NamedTemporaryFile(suffix=".usda", delete=False)
    try:
        tmp.write(blob)
        tmp.close()
        from .usd import load_usda
        return load_usda(tmp.name, scene, meshes, materials, parent)
    finally:
        os.unlink(tmp.name)


# =========================================================================
# Scene export convenience (usdc writer front-end)
# =========================================================================

def export_meshes_usdc(path: str, meshes: MeshRegistry,
                       materials: Optional[MaterialRegistry] = None,
                       instances: Optional[List[Tuple[int, int,
                                                      np.ndarray]]] = None
                       ) -> None:
    """Write registry meshes (optionally with per-instance (mesh_id,
    material_id, world 4x4) placements) as a flattened crate stage."""
    prims: List[UsdPrim] = [UsdPrim("/World", "Xform")]
    mat_paths: Dict[int, str] = {}
    if materials is not None:
        for i in range(len(materials)):
            m = materials.get(i)
            p = f"/World/Materials/mat{i}"
            prims.append(UsdPrim(p, "Material", attrs={
                "inputs:diffuseColor": np.asarray(m.base_color[:3],
                                                  np.float32).reshape(1, 3),
                "inputs:metallic": float(m.metallic),
                "inputs:roughness": float(m.roughness),
                "inputs:emissiveColor": np.asarray(
                    m.emissive, np.float32).reshape(1, 3),
            }))
            mat_paths[i] = p
    if instances is None:
        instances = [(i, 0, np.eye(4)) for i in range(len(meshes))]
    for k, (mid, mat, M) in enumerate(instances):
        md = meshes.get(mid)
        attrs = {
            "points": np.asarray(md.positions, np.float32),
            "faceVertexIndices": np.asarray(md.indices,
                                            np.int32).reshape(-1),
            "faceVertexCounts": np.full(len(md.indices), 3, np.int32),
            "normals": np.asarray(md.normals, np.float32),
            "primvars:st": np.asarray(md.uvs, np.float32),
            # row-vector row-major on disk (transpose of our column form)
            "xformOp:transform": np.asarray(M, np.float64).T,
            "xformOpOrder": ["xformOp:transform"],
        }
        rels = {}
        if mat in mat_paths:
            rels["material:binding"] = mat_paths[mat]
        prims.append(UsdPrim(f"/World/mesh{k}", "Mesh", attrs=attrs,
                             rels=rels))
    save_usdc(path, prims)
