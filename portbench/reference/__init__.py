"""The plain reference that decides `correct`: the frame a scene and a
camera give, worked out in plain PyTorch from the benchmark's own inputs
(portbench/scenes/: meshes, objects, materials, the sun) by the
renderer's documented semantics: raster.py for the visibility buffer and
depth, shade.py for the shaded HDR, the sky and the 8-bit image.

It imports nothing of the port, the JAX package or JAX, and takes
nothing the program made: it places the meshes, sets up, clips and
rasterizes every triangle and shades every pixel itself. `mode` "ref"
computes in float64; "tf32" is the control (raster.py).
"""

from __future__ import annotations

import torch

from portbench.reference import raster, shade


class Reference:
    """Frames of one scene (`desc`, scenes/*.build) at `width` x `height`
    with the frame's `settings` (exposure, skyIntensity)."""

    def __init__(self, desc: dict, width: int, height: int, settings: dict,
                 device, mode: str = "ref"):
        self.geo = raster.Geometry(desc, device, mode)
        self.desc, self.width, self.height = desc, width, height
        self.exposure = settings.get("exposure", 1.0)
        self.sky_intensity = settings.get("skyIntensity", 1.0)
        dt, dev = self.geo.dtype, device
        mats = desc["materials"]
        self.albedo = torch.tensor([m["base_color"] for m in mats],
                                   dtype=dt, device=dev)
        self.metallic = torch.tensor([m["metallic"] for m in mats],
                                     dtype=dt, device=dev)
        self.roughness = torch.tensor([m["roughness"] for m in mats],
                                      dtype=dt, device=dev)
        sun = desc["sun"]
        d = torch.tensor(sun["direction"], dtype=torch.float64)
        self.to_sun = (-d / d.norm()).to(dev, dt)
        self.radiance = (torch.tensor(sun["color"], dtype=torch.float64)
                         * sun["intensity"]).to(dev, dt)

    def frame(self, position, target, fov_y: float, near: float) -> dict:
        """{"vis", "depth", "hdr", "image"} of the camera at `position`
        looking at `target`."""
        aspect = self.width / self.height
        view = raster.look_at(position, target)
        proj = raster.perspective(fov_y, aspect, near)
        g = raster.rasterize(self.geo, view, proj, near, self.width,
                             self.height)
        dt, dev = self.geo.dtype, self.geo.device
        covered = g["vis"] > 0
        mat = g["material"].clamp(min=0)
        eye = torch.tensor(position, dtype=torch.float64).to(dev, dt)
        lit = shade.ggx_sun(g["normal"], shade._unit(eye - g["world"]),
                            self.to_sun, self.albedo[mat],
                            self.metallic[mat][..., None],
                            self.roughness[mat][..., None], self.radiance)
        bg = shade.sky(view, fov_y, aspect, self.width, self.height,
                       self.sky_intensity, dt, dev)
        hdr = torch.where(covered[..., None], lit, bg)
        return {"vis": g["vis"], "depth": g["depth"], "hdr": hdr,
                "image": shade.to_image(hdr, self.exposure),
                "piece": g["piece"], "triangles": len(self.geo.material)}
