"""Core 3D math for the port: host-side camera builders (numpy) and the
column-form transforms the frame uses on tensors.

Port of the parts of basicrenderer_tpu/utils/math3d.py that the soup frame
needs. Conventions are the JAX package's: right-handed world space,
column vectors (``p' = M @ p``), D3D clip space (z in [0, 1] after the
divide) and reverse-Z depth (near = 1, far = 0).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Column-form transforms (tensors)
# ---------------------------------------------------------------------------

def mat4_columns(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 z: torch.Tensor, w=1.0):
    """Point transform by a 4x4 in COLUMN form: (...,)-shaped component
    planes in, 4 component planes out. Each output is summed left to right
    in f32, the order the JAX package writes."""
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3] * w,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3] * w,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3] * w,
            m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3] * w)


def mat3_columns(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 z: torch.Tensor):
    """3x3 row-matrix apply in column form (see mat4_columns)."""
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


# ---------------------------------------------------------------------------
# Frustum
# ---------------------------------------------------------------------------

def frustum_planes(viewproj: torch.Tensor) -> torch.Tensor:
    """Extract 6 clip planes (l, r, b, t, near, far) from a viewproj matrix.

    Planes are (nx, ny, nz, d) with inside meaning dot(plane, (p,1)) >= 0.
    D3D clip-space convention: -w<=x<=w, -w<=y<=w, 0<=z<=w.
    """
    r0, r1, r2, r3 = viewproj[0], viewproj[1], viewproj[2], viewproj[3]
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2])
    n = torch.linalg.vector_norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp(n, min=1e-20)


def sphere_in_frustum(planes: torch.Tensor, centers: torch.Tensor,
                      radii: torch.Tensor) -> torch.Tensor:
    """Batched sphere-vs-frustum: (6,4) planes, (N,3) centers, (N,) radii
    -> (N,) bool. The plane distance is written out per component (no
    matmul) so that it is a true f32 product on every device."""
    d = (centers[:, None, 0] * planes[None, :, 0]
         + centers[:, None, 1] * planes[None, :, 1]
         + centers[:, None, 2] * planes[None, :, 2]
         + planes[None, :, 3])                              # (N, 6)
    return torch.all(d >= -radii[:, None], dim=-1)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded correctly, as XLA's and CUDA's are. PyTorch's
    CPU f32 sqrt is not always: some calls round apart in the last ulp
    (0.03125006 -> 0.17677686, not 0.17677687) and some return part of a
    tensor approximated to ~2^-12 (sqrt(1.0) -> 0.99975586). The f64 root
    rounds to f32 exactly."""
    return torch.sqrt(x.double()).float()


def perspective(fov_y: torch.Tensor, aspect: float, near: float,
                far: torch.Tensor) -> torch.Tensor:
    """(4, 4) reverse-Z perspective projection to D3D clip space on the
    device of `fov_y`, for a field of view and far plane that are tensors
    (the shadow views take them from the light table). View space looks
    down -Z; clip w = -z_view; z_view = -near maps to 1 and -far to 0."""
    fov_y = torch.as_tensor(fov_y, dtype=torch.float32)
    dev = fov_y.device
    f = 1.0 / torch.tan(fov_y * 0.5)
    near = torch.tensor(near, dtype=torch.float32, device=dev)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev)
    A = near / (far - near)
    B = far * near / (far - near)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    return torch.stack([torch.stack([f / aspect, zero, zero, zero]),
                        torch.stack([zero, f, zero, zero]),
                        torch.stack([zero, zero, A, B]),
                        torch.stack([zero, zero, -one, zero])])


# ---------------------------------------------------------------------------
# Numpy-side helpers (host precompute)
# ---------------------------------------------------------------------------

def np_look_at(eye, target, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    f = target - eye
    f = f / (np.linalg.norm(f) + 1e-20)
    r = np.cross(f, up)
    r = r / (np.linalg.norm(r) + 1e-20)
    u = np.cross(r, f)
    m = np.eye(4)
    m[0, :3], m[0, 3] = r, -np.dot(r, eye)
    m[1, :3], m[1, 3] = u, -np.dot(u, eye)
    m[2, :3], m[2, 3] = -f, np.dot(f, eye)
    return m.astype(np.float32)


def np_perspective(fov_y, aspect, near, far, reverse_z=True) -> np.ndarray:
    f = 1.0 / np.tan(float(fov_y) * 0.5)
    near = float(near)
    if far is None:
        if not reverse_z:
            raise ValueError("infinite far plane requires reverse_z")
        A, B = 0.0, near
    else:
        far = float(far)
        if reverse_z:
            A = near / (far - near)
            B = far * near / (far - near)
        else:
            A = -far / (far - near)
            B = -far * near / (far - near)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = A
    proj[2, 3] = B
    proj[3, 2] = -1.0
    return proj


def np_orthographic(left, right, bottom, top, near, far, reverse_z=True) -> np.ndarray:
    sx = 2.0 / (right - left)
    sy = 2.0 / (top - bottom)
    tx = -(right + left) / (right - left)
    ty = -(top + bottom) / (top - bottom)
    if reverse_z:
        sz = 1.0 / (far - near)
        tz = far / (far - near)
    else:
        sz = -1.0 / (far - near)
        tz = -near / (far - near)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[0, 3] = sx, tx
    m[1, 1], m[1, 3] = sy, ty
    m[2, 2], m[2, 3] = sz, tz
    m[3, 3] = 1.0
    return m


# ---------------------------------------------------------------------------
# Quaternions and TRS (numpy f32; the host-side animation sampler)
# ---------------------------------------------------------------------------

def quat_to_matrix(q) -> np.ndarray:
    """(..., 4) xyzw quaternion -> (..., 4, 4) f32 rotation matrix (the
    quaternion need not be unit length)."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, np.float32(2.0) / np.maximum(n, np.float32(1e-20)),
                 np.float32(0.0)).astype(np.float32)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    one = np.ones_like(x)
    zero = np.zeros_like(x)
    rows = [
        np.stack([one - (yy + zz), xy - wz, xz + wy, zero], -1),
        np.stack([xy + wz, one - (xx + zz), yz - wx, zero], -1),
        np.stack([xz - wy, yz + wx, one - (xx + yy), zero], -1),
        np.stack([zero, zero, zero, one], -1),
    ]
    return np.stack(rows, axis=-2)


def quat_slerp(a, b, t) -> np.ndarray:
    """Spherical linear interpolation between xyzw quaternions, in f32;
    a lerp where they are nearly parallel."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(d < 0, -b, b)
    d = np.clip(np.abs(d), np.float32(-1.0), np.float32(1.0))
    theta = np.arccos(d)
    sin_theta = np.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = np.where(use_lerp, np.float32(1.0), sin_theta)
    w_a = np.where(use_lerp, np.float32(1.0 - t),
                   np.sin(np.float32(1.0 - t) * theta) / safe)
    w_b = np.where(use_lerp, np.float32(t), np.sin(np.float32(t) * theta) / safe)
    out = (w_a * a + w_b * b).astype(np.float32)
    return out / (np.linalg.norm(out, axis=-1, keepdims=True)
                  + np.float32(1e-20))


def compose_trs(translation_v, rotation_q, scale_v) -> np.ndarray:
    """Translation * Rotation * Scale -> (..., 4, 4) f32."""
    m = quat_to_matrix(rotation_q)
    s = np.broadcast_to(np.asarray(scale_v, np.float32), m.shape[:-2] + (3,))
    m[..., :3, :3] = m[..., :3, :3] * s[..., None, :]
    m[..., :3, 3] = np.asarray(translation_v, np.float32)
    return m
