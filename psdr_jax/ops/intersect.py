"""Detached closest-hit ray/triangle intersection.

Replacement for the reference's OptiX backend (``src/scene/scene_optix.cpp``).
The contract is the OptiX payload (``scene_optix.cpp:400-404``): for each ray
return

    ``(tri_id, valid, uv, t)``

with *global* triangle ids and barycentrics, always **detached** — the
differentiable part of an intersection is reconstructed from the payload by
``scene.reconstruct_intersection`` exactly like the reference's two-stage
formulation (``scene.cpp:612-806``).

Two implementations share the interface and ONE hit test (:func:`mt_hit`):

* :func:`ray_intersect_brute` — plain-JAX blocked Möller-Trumbore, the
  reference implementation and the CPU path,
* ``intersect_pallas.ray_intersect_pallas`` — a Pallas kernel compiled
  through Triton for the GPU: one program per ray block, triangles streamed
  from global memory, the running closest hit kept in registers.

This module also holds the one definition of which intersector runs
(:func:`intersect_backend`) and of the triangle count above which the
integrators' chunk knobs route a scene as "large" (:func:`is_large_scene`).
"""

from __future__ import annotations

import functools
import os as _os

import jax
import jax.numpy as jnp

from ..core.types import RAY_EPSILON

_INF = 1e30

# Scenes with more (padded) faces than this route the integrators' chunk
# sizes and edge-pass batching to their large-scene values
# (integrator/base.py).  The value was tuned for the previous accelerator's
# intersector; on the H100 it is not measured yet.
LARGE_SCENE_TRIS = 4096

# Triangle granularity of the Morton-ordered clusters the scene builds
# (scene.Scene._cluster_quality scores them): one kernel chunk.
CLUSTER_TRIS = 32

# PSDR_INTERSECT: "auto" (the kernel on a GPU, the blocked reference
# elsewhere), "brute" (the blocked reference everywhere), "pallas" (the
# kernel, compiled) or "interpret" (the kernel through the Pallas
# interpreter, for CPU tests of the kernel path).
BACKENDS = ("auto", "brute", "pallas", "interpret")


def is_large_scene(sd) -> bool:
    """Does this scene route the integrators' knobs to their large-scene
    values?  ``face_mesh_id`` has the scene's padded face count."""
    return sd is not None and sd.face_mesh_id.shape[0] > LARGE_SCENE_TRIS


def intersect_backend(backend: str = "auto") -> str:
    """Resolve ``backend`` (or ``PSDR_INTERSECT`` when "auto") to one of
    "brute", "pallas", "interpret".  Only a GPU gets the compiled kernel
    unasked; nothing falls back to the reference on a GPU."""
    if backend == "auto":
        backend = _os.environ.get("PSDR_INTERSECT", "auto")
    if backend not in BACKENDS:
        raise ValueError(
            f"PSDR_INTERSECT={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "brute"
    return backend


class _Components:
    """3-vectors as tuples of x/y/z arrays (the kernel's form)."""

    @staticmethod
    def sub(a, b):
        return tuple(x - y for x, y in zip(a, b))

    @staticmethod
    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    @staticmethod
    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


class _Stacked:
    """3-vectors as arrays with a trailing axis of 3 (the reference's
    form; XLA contracts its reductions into fused multiply-adds)."""

    @staticmethod
    def sub(a, b):
        return a - b

    cross = staticmethod(jnp.cross)

    @staticmethod
    def dot(a, b):
        return jnp.sum(a * b, axis=-1)


def mt_hit(p0, e1, e2, o, d, vec=_Components):
    """THE Möller-Trumbore hit test (reference utils.h:83-93 epsilons).

    Triangles and rays broadcast against each other (triangles along one
    axis, rays along another).  ``vec`` says how 3-vectors are held:
    tuples of x/y/z arrays (the kernel) or arrays with a trailing axis of
    3 (the blocked reference); the arithmetic is the same.  Returns ``(t,
    u, v, hit)``; divisions are guarded so degenerate triangles miss
    instead of producing NaNs, and any NaN coordinate makes a comparison
    false, so NaN rays miss.
    """
    h = vec.cross(d, e2)
    a = vec.dot(e1, h)
    live = jnp.abs(a) > 1e-12
    f = jnp.where(live, 1.0 / jnp.where(a == 0, 1.0, a), 0.0)
    s = vec.sub(o, p0)
    u = f * vec.dot(s, h)
    q = vec.cross(s, e1)
    v = f * vec.dot(d, q)
    t = f * vec.dot(e2, q)
    hit = live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPSILON)
    return t, u, v, hit


def _mt_block(p0, e1, e2, ray_o, ray_d):
    """:func:`mt_hit` for a (R, 3) ray block against a (C, 3) tri block;
    returns (t, u, v, hit) with shape (R, C)."""
    return mt_hit(p0[None], e1[None], e2[None], ray_o[:, None],
                  ray_d[:, None], vec=_Stacked)


def _closest_over_tris(p0, e1, e2, ray_o, ray_d, tri_chunk: int):
    """Scan triangle blocks for one ray block; returns best (t, id, u, v)."""
    f_pad = p0.shape[0]
    n_blocks = f_pad // tri_chunk
    r = ray_o.shape[0]

    def body(carry, blk):
        best_t, best_id, best_u, best_v = carry
        bp0, be1, be2, base = blk
        t, u, v, hit = _mt_block(bp0, be1, be2, ray_o, ray_d)
        t = jnp.where(hit, t, _INF)
        j = jnp.argmin(t, axis=-1)
        rows = jnp.arange(r)
        tj = t[rows, j]
        closer = tj < best_t
        best_id = jnp.where(closer, base + j, best_id)
        best_u = jnp.where(closer, u[rows, j], best_u)
        best_v = jnp.where(closer, v[rows, j], best_v)
        best_t = jnp.where(closer, tj, best_t)
        return (best_t, best_id, best_u, best_v), None

    init = (
        jnp.full((r,), _INF, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    if n_blocks == 1:
        (bt, bi, bu, bv), _ = body(init, (p0, e1, e2, jnp.int32(0)))
    else:
        blocks = (
            p0.reshape(n_blocks, tri_chunk, 3),
            e1.reshape(n_blocks, tri_chunk, 3),
            e2.reshape(n_blocks, tri_chunk, 3),
            jnp.arange(n_blocks, dtype=jnp.int32) * tri_chunk,
        )
        (bt, bi, bu, bv), _ = jax.lax.scan(body, init, blocks)
    return bt, bi, bu, bv


def ray_intersect_brute(
    p0, e1, e2, ray_o, ray_d, ray_chunk: int = 8192, tri_chunk: int = 256
):
    """Blocked brute-force closest hit: smallest ``t``, ties to the lowest
    triangle id.

    Args: ``p0/e1/e2``: (F, 3) triangle SoA; ``ray_o/ray_d``: (N, 3).
    Returns ``(tri_id (N,) int32 [-1 = miss], valid (N,) bool, uv (N, 2), t (N,))``.
    """
    f = p0.shape[0]
    n = ray_o.shape[0]
    tri_chunk = min(tri_chunk, max(8, f))
    f_pad = -(-f // tri_chunk) * tri_chunk
    if f_pad != f:
        pad = f_pad - f
        # degenerate padding triangles never hit (e1 = e2 = 0)
        p0 = jnp.concatenate([p0, jnp.zeros((pad, 3), p0.dtype)], axis=0)
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)], axis=0)
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)], axis=0)

    n_pad = -(-n // ray_chunk) * ray_chunk
    if n_pad != n:
        pad = n_pad - n
        ray_o = jnp.concatenate([ray_o, jnp.zeros((pad, 3), ray_o.dtype)], axis=0)
        ray_d = jnp.concatenate(
            [ray_d, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], ray_d.dtype), (pad, 1))],
            axis=0,
        )

    if n_pad == ray_chunk:
        bt, bi, bu, bv = _closest_over_tris(p0, e1, e2, ray_o, ray_d, tri_chunk)
    else:
        fn = functools.partial(_closest_over_tris, p0, e1, e2, tri_chunk=tri_chunk)
        ro = ray_o.reshape(-1, ray_chunk, 3)
        rd = ray_d.reshape(-1, ray_chunk, 3)
        bt, bi, bu, bv = jax.lax.map(lambda ab: fn(ab[0], ab[1]), (ro, rd))
        bt, bi, bu, bv = (x.reshape(-1) for x in (bt, bi, bu, bv))

    bt, bi, bu, bv = bt[:n], bi[:n], bu[:n], bv[:n]
    valid = bi >= 0
    uv = jnp.stack([bu, bv], axis=-1)
    t = jnp.where(valid, bt, _INF)
    return bi, valid, uv, t


def ray_intersect_detached(tri_p0, tri_e1, tri_e2, ray, active=None,
                           backend: str = "auto"):
    """Intersection entry point used by the scene layer.

    Everything is wrapped in ``stop_gradient`` — matching the reference where
    OptiX sees only detached rays (``scene_optix.cpp:358-375``).  NaN rays are
    masked out like ``scene_optix.cpp:348-353``.
    """
    p0 = jax.lax.stop_gradient(tri_p0)
    e1 = jax.lax.stop_gradient(tri_e1)
    e2 = jax.lax.stop_gradient(tri_e2)
    o = jax.lax.stop_gradient(ray.o)
    d = jax.lax.stop_gradient(ray.d)

    finite = jnp.all(jnp.isfinite(o), axis=-1) & jnp.all(jnp.isfinite(d), axis=-1)
    if active is not None:
        finite = finite & active

    backend = intersect_backend(backend)
    shape = o.shape[:-1]
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)

    if backend == "brute":
        # the blocked min-reductions would be poisoned by NaN t: substitute
        # harmless rays for dead lanes (their hits are masked below)
        live = finite.reshape(-1, 1)
        o2 = jnp.where(live, o2, 0.0)
        d2 = jnp.where(live, d2, jnp.asarray([0.0, 0.0, 1.0], d.dtype))
        tri_id, valid, uv, t = ray_intersect_brute(p0, e1, e2, o2, d2)
    else:
        from .intersect_pallas import ray_intersect_pallas

        # dead lanes start the kernel with a closest hit at -inf: they can
        # take no hit and never keep a chunk from being culled
        tri_id, valid, uv, t = ray_intersect_pallas(
            p0, e1, e2, o2, d2, active=finite.reshape(-1),
            interpret=backend == "interpret",
        )

    tri_id = tri_id.reshape(shape)
    valid = valid.reshape(shape) & finite
    uv = uv.reshape(shape + (2,))
    t = t.reshape(shape)
    tri_id = jnp.where(valid, tri_id, -1)
    return tri_id, valid, uv, t
