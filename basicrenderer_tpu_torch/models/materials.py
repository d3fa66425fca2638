"""Material model + registry.

Reference analogue: MaterialManager + PerMaterialCB (reference:
BasicRenderer/src/Managers/MaterialManager.cpp,
BasicRenderer/include/ShaderBuffers.h:139-361). The reference supports both a
classic metallic-roughness PBR material and an OpenPBR surface; we start with
metallic-roughness (the deferred path's core) and reserve packed slots for the
OpenPBR extension set (coat/fuzz/emission) so the GPU layout won't change.

Materials are packed into a (MAX_MATERIALS, MAT_STRIDE) f32 device table;
integer fields (texture ids, flags) are bitcast into float lanes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Packed material table layout (float lanes)
MAT_STRIDE = 48
# lanes 0-3:   base color rgba
# lane  4:     metallic
# lane  5:     roughness
# lanes 6-8:   emissive rgb
# lane  9:     normal scale
# lane  10:    occlusion strength
# lane  11:    alpha cutoff (<0 = opaque, else masked)
# lane  12:    ior
# lanes 13-15: texture ids AS PLAIN FLOATS (base, normal, metalrough; -1 none)
#              — bitcast ints become denormals/NaNs through the one-hot
#              matmul lookup path, so ids are stored as float values
# lane  16:    emissive texture id (float)
# lane  17:    flags as a float bitfield: 1=doubleSided 2=alphaBlend 4=unlit
# lanes 18-21: coat (weight, roughness, ior, pad)     [OpenPBR]
# lanes 22-24: fuzz (weight, roughness, pad)          [OpenPBR]
# lanes 25-27: sheen color                             [OpenPBR]
# lanes 28-29: Reyes displacement (scale, texture id)
# lane  30:    transmission weight                     [OpenPBR]
# lane  31:    transmission depth (Beer-Lambert path)  [OpenPBR]
# lanes 32-34: transmission color                      [OpenPBR]
# lane  35:    transmission dispersion (Abbe-number analogue; stored for
#              parity — shading applies a fixed spectral tint shift)
# lane  36:    subsurface weight                       [OpenPBR]
# lanes 37-39: subsurface color                        [OpenPBR]
# lane  40:    subsurface radius (wrap-diffusion width)
# lane  41:    anisotropy strength                     [OpenPBR]
# lane  42:    anisotropy rotation (radians)           [OpenPBR]
# remaining:   reserved

FLAG_DOUBLE_SIDED = 1
FLAG_ALPHA_BLEND = 2
FLAG_UNLIT = 4


@dataclasses.dataclass
class Material:
    name: str = ""
    base_color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(4, np.float32))
    metallic: float = 0.0
    roughness: float = 0.8
    emissive: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    normal_scale: float = 1.0
    occlusion_strength: float = 1.0
    alpha_cutoff: float = -1.0
    ior: float = 1.5
    base_color_texture: int = -1
    normal_texture: int = -1
    metallic_roughness_texture: int = -1
    emissive_texture: int = -1
    double_sided: bool = False
    alpha_blend: bool = False
    unlit: bool = False
    coat_weight: float = 0.0
    coat_roughness: float = 0.0
    coat_ior: float = 1.6
    fuzz_weight: float = 0.0
    fuzz_roughness: float = 0.5
    sheen_color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    # Reyes displacement mapping (ops/reyes.py): world-units peak-to-peak
    # height along the vertex normal, sampled from the R channel of
    # `displacement_texture` (glTF ext / heightmap import).
    displacement_scale: float = 0.0
    displacement_texture: int = -1
    # OpenPBR transmission / subsurface / anisotropy (reference:
    # PerMaterialOpenPBRCB, ShaderBuffers.h:277-334). Transmission routes
    # the surface through the OIT peel (ops/oit.py) with a Beer-Lambert
    # tinted background; subsurface is a wrap-diffusion diffuse lobe;
    # anisotropy stretches the GGX lobe along the UV-derived tangent.
    transmission_weight: float = 0.0
    transmission_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    transmission_depth: float = 1.0
    transmission_dispersion: float = 0.0
    subsurface_weight: float = 0.0
    subsurface_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    subsurface_radius: float = 0.5
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0

    def pack(self) -> np.ndarray:
        row = np.zeros(MAT_STRIDE, np.float32)
        row[0:4] = np.asarray(self.base_color, np.float32)
        row[4] = self.metallic
        row[5] = self.roughness
        row[6:9] = np.asarray(self.emissive, np.float32)
        row[9] = self.normal_scale
        row[10] = self.occlusion_strength
        row[11] = self.alpha_cutoff
        row[12] = self.ior
        row[13:17] = np.array(
            [self.base_color_texture, self.normal_texture,
             self.metallic_roughness_texture, self.emissive_texture],
            np.float32,
        )
        flags = (FLAG_DOUBLE_SIDED * self.double_sided
                 | FLAG_ALPHA_BLEND * self.alpha_blend
                 | FLAG_UNLIT * self.unlit)
        row[17] = float(flags)
        row[18:21] = (self.coat_weight, self.coat_roughness, self.coat_ior)
        row[22:24] = (self.fuzz_weight, self.fuzz_roughness)
        row[25:28] = np.asarray(self.sheen_color, np.float32)
        # Lanes 28-29: Reyes displacement (ops/reyes.py).
        row[28] = self.displacement_scale
        row[29] = float(self.displacement_texture)
        row[30] = self.transmission_weight
        row[31] = self.transmission_depth
        row[32:35] = np.asarray(self.transmission_color, np.float32)
        row[35] = self.transmission_dispersion
        row[36] = self.subsurface_weight
        row[37:40] = np.asarray(self.subsurface_color, np.float32)
        row[40] = self.subsurface_radius
        row[41] = self.anisotropy_strength
        row[42] = self.anisotropy_rotation
        return row


class MaterialRegistry:
    def __init__(self):
        self.materials: List[Material] = []
        self.add(Material(name="default"))  # id 0 = default

    def add(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def get(self, mid: int) -> Material:
        return self.materials[mid]

    def packed_table(self, capacity: int) -> np.ndarray:
        """(capacity, MAT_STRIDE) f32 table; rows past len() are default."""
        table = np.zeros((capacity, MAT_STRIDE), np.float32)
        default = Material().pack()
        table[:] = default
        for i, m in enumerate(self.materials[:capacity]):
            table[i] = m.pack()
        return table

    def __len__(self):
        return len(self.materials)
