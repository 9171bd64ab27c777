"""Homogeneous 4x4 transforms (reference: include/psdr/core/transform.h).

Matrices use numpy row convention: ``transform_pos(M, v) = (M @ [v, 1]).xyz/w``.
All constructors accept python scalars or traced jnp scalars and return (4,4)
jnp arrays, so transforms are differentiable w.r.t. their parameters.
"""

from __future__ import annotations

import jax.numpy as jnp

from .math import normalize, cross


def translate(v):
    v = jnp.asarray(v, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(v)


def scale(v):
    v = jnp.asarray(v, jnp.float32)
    return jnp.diag(jnp.concatenate([v, jnp.ones(1, jnp.float32)]))


def rotate(axis, angle_deg):
    """Rotation about ``axis`` by ``angle`` in degrees (Rodrigues)."""
    axis = normalize(jnp.asarray(axis, jnp.float32))
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    s, c = jnp.sin(theta), jnp.cos(theta)
    x, y, z = axis[0], axis[1], axis[2]
    k = jnp.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]], jnp.float32)
    r = jnp.eye(3, dtype=jnp.float32) + s * k + (1.0 - c) * (k @ k)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(r)


def perspective(fov_deg, near, far):
    """Projection to [-1,1]^2 x [0,1] depth (transform.h:48-61)."""
    recip = 1.0 / (far - near)
    tan = jnp.tan(jnp.deg2rad(jnp.asarray(fov_deg, jnp.float32) * 0.5))
    cot = 1.0 / tan
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(cot)
    m = m.at[1, 1].set(cot)
    m = m.at[2, 2].set(far * recip)
    m = m.at[2, 3].set(-near * far * recip)
    m = m.at[3, 2].set(1.0)
    return m


def perspective_intrinsic(fx, fy, cx, cy, near, far):
    """Intrinsics-parameterised projection (transform.h:63-71)."""
    recip = 1.0 / (far - near)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(1.0)
    m = m.at[1, 1].set(1.0)
    m = m.at[2, 2].set(far * recip)
    m = m.at[2, 3].set(-near * far * recip)
    m = m.at[3, 2].set(1.0)
    t = translate(jnp.array([1.0 - 2.0 * cx, 1.0 - 2.0 * cy, 0.0]))
    s = scale(jnp.array([2.0 * fx, 2.0 * fy, 1.0]))
    return t @ s @ m


def orthographic(near, far):
    """Orthographic depth remap (transform.h:73-76)."""
    return scale(jnp.array([1.0, 1.0, 1.0 / (far - near)])) @ translate(
        jnp.array([0.0, 0.0, -near])
    )


def look_at(origin, target, up):
    """Camera-to-world: columns = [left, new_up, dir, origin] (transform.h:85-103)."""
    origin = jnp.asarray(origin, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    dir_ = normalize(target - origin)
    left = normalize(cross(up, dir_))
    new_up = cross(dir_, left)
    m = jnp.stack([left, new_up, dir_, origin], axis=-1)
    return jnp.concatenate(
        [m, jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0
    )


def transform_pos(m, v):
    """Apply 4x4 ``m`` to points ``v`` (..., 3) with perspective divide.

    Written as explicit muls/adds rather than a matmul: a float32 matmul
    may run in reduced precision (TF32 on the GPU's tensor cores, 10
    mantissa bits), which at scene scale corrupts positions by O(1) units
    and destroys geometry gradients.
    """
    rot = m[..., :3, :3]
    r = (
        v[..., 0:1] * rot[..., :, 0]
        + v[..., 1:2] * rot[..., :, 1]
        + v[..., 2:3] * rot[..., :, 2]
        + m[..., :3, 3]
    )
    w = (
        v[..., 0] * m[..., 3, 0]
        + v[..., 1] * m[..., 3, 1]
        + v[..., 2] * m[..., 3, 2]
        + m[..., 3, 3]
    )
    return r / w[..., None]


def transform_dir(m, v):
    """Apply the linear part of ``m`` to directions ``v`` (..., 3)."""
    rot = m[..., :3, :3]
    return (
        v[..., 0:1] * rot[..., :, 0]
        + v[..., 1:2] * rot[..., :, 1]
        + v[..., 2:3] * rot[..., :, 2]
    )
