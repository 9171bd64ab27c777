"""Sensor data pytree and shared primary-edge machinery
(reference: include/psdr/sensor/sensor.h, src/sensor/{perspective,orthographic}.cpp).

Design note: the reference *compacts* silhouette edges per camera pose
(``compressD``, perspective.cpp:101-111) which yields dynamic shapes.  We keep
the full static edge list and give non-silhouette edges **zero sampling mass**
instead — the discrete distribution never selects them, shapes stay static,
and XLA compiles one program per scene topology.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..core.types import pytree, static_field, Ray, EPSILON, EDGE_EPSILON
from ..core.distribution import DiscreteDistribution
from ..core.records import PrimaryEdgeSample, SensorDirectSample
from ..core.math import normalize, norm, safe_div, safe_sqrt, squared_norm, dot
from ..core import transform as xf
from ..core.object import Object
from ..ops.gather import gather_rows


class Sensor(Object):
    """User-facing camera base (reference sensor/sensor.h:21-65, exposed to
    Python at psdr.cpp:357).  Concrete cameras (Perspective/Orthographic)
    carry the differentiable ``to_world`` pose stack and resolution; their
    configured traced state is a :class:`SensorData`."""

    def set_transform(self, m):
        raise NotImplementedError


@pytree
class PrimaryEdgeInfo:
    """Screen-space projected silhouette candidates (edge/edge.h:26-41)."""

    p0: Any           # (E, 2) sample-space endpoints — differentiable
    p1: Any           # (E, 2)
    edge_normal: Any  # (E, 2) detached screen normal
    edge_length: Any  # (E,) detached screen length (0 = masked out)
    distrb: DiscreteDistribution


@pytree
class SensorData:
    """Configured camera (both perspective and orthographic models)."""

    sample_to_camera: Any  # (4, 4)
    to_world: Any          # (4, 4) — differentiable pose
    world_to_sample: Any   # (4, 4)
    camera_pos: Any        # (3,)
    camera_dir: Any        # (3,)
    inv_area: Any          # ()
    edge_info: Any         # PrimaryEdgeInfo | None
    width: int = static_field(default=0)
    height: int = static_field(default=0)
    ortho: bool = static_field(default=False)

    # -- ray generation ----------------------------------------------------
    def sample_primary_ray(self, samples, diff: bool = True):
        """Camera rays through sample-space points (perspective.cpp:160-178).

        The camera-space direction is always detached; the world transform is
        differentiable (pose gradients flow through ``to_world``).
        """
        s2c = jax.lax.stop_gradient(self.sample_to_camera)
        to_world = self.to_world if diff else jax.lax.stop_gradient(self.to_world)
        p3 = jnp.concatenate([samples, jnp.zeros_like(samples[..., :1])], axis=-1)
        near_p = xf.transform_pos(s2c, p3)
        if self.ortho:
            o = xf.transform_pos(to_world, near_p)
            d_cam = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), near_p.shape
            )
            d = xf.transform_dir(to_world, d_cam)
        else:
            d_cam = jax.lax.stop_gradient(normalize(near_p))
            o = xf.transform_pos(
                to_world, jnp.zeros_like(near_p)
            )
            d = xf.transform_dir(to_world, d_cam)
        return Ray(o, d)

    # -- world point -> pixel ------------------------------------------------
    def sample_direct(self, p) -> SensorDirectSample:
        """Project world point to pixel + importance (perspective.cpp:181-197).

        Fully detached like the reference C-only implementation.
        """
        w2s = jax.lax.stop_gradient(self.world_to_sample)
        q = xf.transform_pos(w2s, p)[..., :2]
        res = jnp.asarray([self.width, self.height], jnp.float32)
        iq = jnp.floor(q * res).astype(jnp.int32)
        is_valid = (
            (iq[..., 0] >= 0)
            & (iq[..., 0] < self.width)
            & (iq[..., 1] >= 0)
            & (iq[..., 1] < self.height)
        )
        pixel_idx = jnp.where(
            is_valid, iq[..., 1] * self.width + iq[..., 0], -1
        )
        if self.ortho:
            # Parallel projection: |d^2 s / dA| is the constant 1/A_plane —
            # no 1/dist^2 falloff, no ray obliquity (rays are the axis).
            # NOTE the reference reuses the perspective formula here
            # (orthographic.cpp:185-190), which is wrong for ortho; its own
            # tutorials never exercise ortho boundary terms.
            sensor_val = jnp.broadcast_to(
                jax.lax.stop_gradient(self.inv_area), pixel_idx.shape
            )
        else:
            cam_pos = jax.lax.stop_gradient(self.camera_pos)
            cam_dir = jax.lax.stop_gradient(self.camera_dir)
            dir_ = p - cam_pos
            dist2 = squared_norm(dir_)
            dir_ = dir_ * safe_div(1.0, safe_sqrt(dist2))[..., None]
            cos_theta = dot(cam_dir, dir_)
            sensor_val = safe_div(1.0, dist2) * safe_div(1.0, cos_theta) ** 3 * \
                jax.lax.stop_gradient(self.inv_area)
        return SensorDirectSample(
            q=q, pixel_idx=pixel_idx, sensor_val=sensor_val, is_valid=is_valid
        )


def sample_primary_edge(sensor: SensorData, sample1,
                        u_coin=None) -> PrimaryEdgeSample:
    """Sample a point on a projected silhouette edge (perspective.cpp:200-226).

    ``u_coin``: alias coin for big edge tables (DiscreteDistribution
    ``needs_coin``)."""
    info = sensor.edge_info
    edge_idx, pdf, u = info.distrb.sample_reuse(sample1, u_coin)
    # one packed one-hot gather for every per-edge field (ops/gather.py)
    rows = gather_rows(
        jnp.concatenate(
            [info.p0, info.p1, info.edge_normal, info.edge_length[:, None]],
            axis=1,
        ),
        edge_idx,
    )
    p0 = rows[..., 0:2]
    p1 = rows[..., 2:4]
    edge_normal = jax.lax.stop_gradient(rows[..., 4:6])
    pdf = safe_div(pdf, jax.lax.stop_gradient(rows[..., 6]))
    p_diff = p0 * (1.0 - u[..., None]) + p1 * u[..., None]
    p = jax.lax.stop_gradient(p_diff)
    x_dot_n = dot(p_diff, edge_normal)

    res = jnp.asarray([sensor.width, sensor.height], jnp.float32)
    ip = jnp.floor(p * res).astype(jnp.int32)
    valid = (
        (ip[..., 0] >= 0)
        & (ip[..., 0] < sensor.width)
        & (ip[..., 1] >= 0)
        & (ip[..., 1] < sensor.height)
    )
    idx = jnp.where(valid, ip[..., 1] * sensor.width + ip[..., 0], -1)

    ray_p = sensor.sample_primary_ray(p + EDGE_EPSILON * edge_normal, diff=False)
    ray_n = sensor.sample_primary_ray(p - EDGE_EPSILON * edge_normal, diff=False)
    return PrimaryEdgeSample(
        x_dot_n=x_dot_n, idx=idx, ray_p=ray_p, ray_n=ray_n, pdf=pdf
    )


def build_primary_edges(camera_pos, world_to_sample, mesh_list, mesh_datas,
                        camera_dir=None):
    """Silhouette classification + screen projection for all meshes
    (perspective.cpp:48-151), masked instead of compacted.

    Returns PrimaryEdgeInfo over the concatenated edge lists of all
    edge-enabled meshes, with non-silhouette edges given zero length/mass.
    ``camera_dir`` set => orthographic: classify against the parallel view
    direction instead of the eye position (the reference reuses the
    position form for ortho, orthographic.cpp:64-66, which misclassifies
    silhouettes when the camera plane is near the scene).
    """
    import numpy as np

    p0s, p1s, normals, lengths = [], [], [], []
    for mesh, md in zip(mesh_list, mesh_datas):
        if not mesh.enable_edges or mesh._edge_rows.shape[0] == 0:
            continue
        ei = jnp.asarray(mesh._edge_rows, jnp.int32)
        tri = md.tri
        has_f1 = ei[:, 3] >= 0
        f1 = jnp.maximum(ei[:, 3], 0)
        # classification is boolean (non-differentiable): detach the
        # gathered geometry so no gather here can transpose into a scatter
        # inside the per-step differentiated scene compile
        tp0 = jax.lax.stop_gradient(tri.p0)
        tfn = jax.lax.stop_gradient(tri.face_normal)
        if camera_dir is not None:
            e0 = jnp.broadcast_to(-normalize(camera_dir),
                                  (ei.shape[0], 3))
            e1 = e0
        else:
            e0 = normalize(camera_pos - tp0[ei[:, 2]])
            e1 = normalize(camera_pos - tp0[f1])
        n0 = tfn[ei[:, 2]]
        n1 = tfn[f1]

        d00 = dot(e0, n0)
        d11 = dot(e1, n1)
        uv_mask = None
        if mesh.has_uv:
            fuv = np.asarray(mesh.face_uv_indices)
            einp = np.asarray(mesh._edge_rows)
            fuv1 = fuv[einp[:, 2]]
            fuv2 = fuv[np.maximum(einp[:, 3], 0)]
            uv_cut = np.zeros(einp.shape[0], np.int32)
            for a in range(3):
                shared = (
                    (fuv1[:, a] == fuv2[:, 0])
                    | (fuv1[:, a] == fuv2[:, 1])
                    | (fuv1[:, a] == fuv2[:, 2])
                )
                uv_cut += shared.astype(np.int32)
            uv_mask = jnp.asarray(uv_cut != 2)

        if mesh.use_face_normals:
            skip = has_f1 & (
                ((d00 < EPSILON) & (d11 < EPSILON))
                | (dot(n0, n1) > 1.0 - EPSILON)
            )
            keep = ~skip
        else:
            keep = (~has_f1) | ((d00 > EPSILON) ^ (d11 > EPSILON))
        if uv_mask is not None:
            keep = keep | uv_mask

        # endpoints DO carry gradients (screen positions -> x_dot_n /
        # lengths): one one-hot-matmul gather for both, so the backward is
        # a single matmul transpose instead of two vertex scatters per mesh
        # per training step (ops/gather.py rationale)
        from ..ops.gather import gather_rows

        vp = md.vertex_positions
        both = gather_rows(vp, jnp.stack([ei[:, 0], ei[:, 1]]))
        q0 = xf.transform_pos(world_to_sample, both[0])[..., :2]
        q1 = xf.transform_pos(world_to_sample, both[1])[..., :2]
        e_scr = jax.lax.stop_gradient(q1 - q0)
        length = norm(e_scr)
        e_unit = e_scr * safe_div(1.0, length)[..., None]
        edge_n = jnp.stack([-e_unit[..., 1], e_unit[..., 0]], axis=-1)

        p0s.append(q0)
        p1s.append(q1)
        normals.append(edge_n)
        lengths.append(jnp.where(keep, length, 0.0))

    if not p0s:
        return None
    p0 = jnp.concatenate(p0s, axis=0)
    p1 = jnp.concatenate(p1s, axis=0)
    edge_normal = jnp.concatenate(normals, axis=0)
    edge_length = jnp.concatenate(lengths, axis=0)
    return PrimaryEdgeInfo(
        p0=p0,
        p1=p1,
        edge_normal=edge_normal,
        edge_length=edge_length,
        distrb=DiscreteDistribution.init(edge_length),
    )
