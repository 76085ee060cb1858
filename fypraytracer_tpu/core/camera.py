"""Perspective fly camera with on-the-fly ray generation.

Matches the reference camera's matrix conventions (``Camera.cpp``):
glm right-handed ``perspectiveFov`` with [-1, 1] clip depth
(Camera.cpp:123-128) and ``lookAt`` with world up (0,1,0)
(Camera.cpp:130-134).

One deliberate departure: the reference precomputes a W×H
world-space ray-direction buffer on the host every time the camera moves
and uploads it per frame (Camera.cpp:136-153, Camera_GPU.cu:4-60).  Here
ray directions are computed *inside the jitted render step* from the two
inverse matrices — a handful of FLOPs per ray instead of an HBM round
trip per frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fypraytracer_tpu.core.mathutils import _xp, normalize


def perspective_fov(vfov_deg: float, width: float, height: float, near: float, far: float) -> np.ndarray:
    """glm::perspectiveFov (RH, -1..1 depth), row-major 4x4 (Camera.cpp:125)."""
    rad = np.deg2rad(vfov_deg)
    h = np.cos(0.5 * rad) / np.sin(0.5 * rad)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """glm::lookAt (RH), row-major 4x4 (Camera.cpp:132)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


@dataclasses.dataclass
class Camera:
    """Host-side camera state (Camera.h); produces matrices for the device.

    ``prev_*`` matrices back ReSTIR temporal reprojection (Camera.h:12-13;
    updated each frame at WalnutApp.cpp:908-909).
    """

    position: np.ndarray
    forward: np.ndarray
    vfov_deg: float = 45.0
    near: float = 0.1
    far: float = 100.0
    width: int = 256
    height: int = 256

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)
        self.forward = np.asarray(self.forward, np.float32)
        self.forward = self.forward / np.linalg.norm(self.forward)
        self._update()
        self.prev_view = self.view.copy()
        self.prev_projection = self.projection.copy()

    def _update(self):
        self.projection = perspective_fov(self.vfov_deg, self.width, self.height, self.near, self.far)
        self.view = look_at(self.position, self.position + self.forward)
        self.inv_projection = np.linalg.inv(self.projection).astype(np.float32)
        self.inv_view = np.linalg.inv(self.view).astype(np.float32)

    def resize(self, width: int, height: int):
        if (width, height) != (self.width, self.height):
            self.width, self.height = width, height
            self._update()

    def move_to(self, position, forward=None):
        self.position = np.asarray(position, np.float32)
        if forward is not None:
            f = np.asarray(forward, np.float32)
            self.forward = f / np.linalg.norm(f)
        self._update()

    def commit_frame(self):
        """Latch current matrices as previous (WalnutApp.cpp:908-909)."""
        self.prev_view = self.view.copy()
        self.prev_projection = self.projection.copy()

    # -- fly controls (Camera::OnUpdate, Camera.cpp:18-94) -------------------

    MOVE_SPEED = 5.0        # Camera.cpp speed
    ROT_SPEED = 0.3         # Camera.cpp:118-121

    def fly(self, dt: float, forward=0.0, right=0.0, up=0.0,
            yaw_delta=0.0, pitch_delta=0.0) -> bool:
        """FPS-style update: WASD-equivalents along forward/right axes,
        QE along world up, mouse-delta yaw/pitch (Camera.cpp:18-94).
        Returns True if the pose changed (caller resets accumulation)."""
        moved = False
        up_v = np.float32([0.0, 1.0, 0.0])
        right_v = np.cross(self.forward, up_v)
        right_v /= max(np.linalg.norm(right_v), 1e-12)
        if forward or right or up:
            self.position = (self.position
                             + self.forward * (forward * self.MOVE_SPEED * dt)
                             + right_v * (right * self.MOVE_SPEED * dt)
                             + up_v * (up * self.MOVE_SPEED * dt))
            moved = True
        if yaw_delta or pitch_delta:
            yaw = -yaw_delta * self.ROT_SPEED
            pitch = -pitch_delta * self.ROT_SPEED
            cy, sy = np.cos(yaw), np.sin(yaw)
            f = self.forward
            f = np.float32([f[0] * cy + f[2] * sy, f[1], -f[0] * sy + f[2] * cy])
            axis = np.cross(f, up_v)
            axis /= max(np.linalg.norm(axis), 1e-12)
            cp, sp = np.cos(pitch), np.sin(pitch)
            f = (f * cp + np.cross(axis, f) * sp
                 + axis * np.dot(axis, f) * (1.0 - cp))
            self.forward = f / np.linalg.norm(f)
            moved = True
        if moved:
            self._update()
        return moved

    @property
    def proj_view(self) -> np.ndarray:
        return (self.projection @ self.view).astype(np.float32)

    @property
    def prev_proj_view(self) -> np.ndarray:
        return (self.prev_projection @ self.prev_view).astype(np.float32)


def generate_rays(inv_projection, inv_view, width: int, height: int, xp=None, pixel_x=None, pixel_y=None):
    """Camera rays for a pixel grid — the jit-side replacement for the
    reference's precomputed ray-direction buffer (Camera.cpp:136-153).

    Per pixel: ``coord = (x/W, y/H)*2 - 1``; ``target = invProj @ (cx,cy,1,1)``;
    ``dir = (invView @ (normalize(target.xyz / target.w), 0)).xyz``.
    Deviation from the reference (Camera.cpp:144-145, row 0 → NDC y = -1):
    row 0 maps to NDC y = **+1** (top of screen) so image arrays are
    top-down and export without a flip — the reference compensates in its
    bottom-up BMP writer instead (MisUtils.cpp:13-95).

    Returns ``(origins, directions)`` with shape (H*W, 3) when pixel ids are
    not given, else matching the shape of ``pixel_x``.
    """
    if pixel_x is None:
        if xp is None:
            xp = _xp(inv_projection)
        ys, xs = xp.meshgrid(xp.arange(height), xp.arange(width), indexing="ij")
        pixel_x = xs.reshape(-1)
        pixel_y = ys.reshape(-1)
    xp = _xp(pixel_x) if xp is None else xp

    cx = (pixel_x.astype(xp.float32) / width) * 2.0 - 1.0
    cy = 1.0 - (pixel_y.astype(xp.float32) / height) * 2.0

    # target = invProj @ (cx, cy, 1, 1)
    ip = inv_projection
    tx = ip[0, 0] * cx + ip[0, 1] * cy + ip[0, 2] + ip[0, 3]
    ty = ip[1, 0] * cx + ip[1, 1] * cy + ip[1, 2] + ip[1, 3]
    tz = ip[2, 0] * cx + ip[2, 1] * cy + ip[2, 2] + ip[2, 3]
    tw = ip[3, 0] * cx + ip[3, 1] * cy + ip[3, 2] + ip[3, 3]

    t = xp.stack([tx, ty, tz], axis=-1) / tw[..., None]
    d = normalize(t)

    iv = inv_view
    # rotate by invView (w = 0)
    wx = iv[0, 0] * d[..., 0] + iv[0, 1] * d[..., 1] + iv[0, 2] * d[..., 2]
    wy = iv[1, 0] * d[..., 0] + iv[1, 1] * d[..., 1] + iv[1, 2] * d[..., 2]
    wz = iv[2, 0] * d[..., 0] + iv[2, 1] * d[..., 1] + iv[2, 2] * d[..., 2]
    directions = xp.stack([wx, wy, wz], axis=-1)

    origin = iv[:3, 3]
    origins = xp.broadcast_to(origin, directions.shape)
    return origins, directions
