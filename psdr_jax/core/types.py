"""Core pytree types: render options, rays, frames, intersections.

Counterpart of the reference's ``ad``-templated Dr.Jit types
(``/root/reference/include/psdr/types.h``, ``core/ray.h``, ``core/frame.h``,
``core/intersection.h``).  Instead of a C/D (detached/attached) type split we
use plain ``jnp`` arrays everywhere and place ``jax.lax.stop_gradient`` at the
exact mathematical seams where the reference converts D->C.

All vector quantities are arrays with a trailing dimension (``(..., 3)`` for
3-vectors) so every field is a flat SoA over sample lanes — the layout XLA
vectorizes best.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# pytree dataclass helper
# ---------------------------------------------------------------------------


def static_field(**kwargs):
    """Mark a dataclass field as static (part of the pytree treedef)."""
    metadata = kwargs.pop("metadata", {})
    metadata = dict(metadata)
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree(cls):
    """Register a dataclass as a JAX pytree (data fields = leaves).

    Fields created with :func:`static_field` become part of the treedef
    (hashable, trigger retrace on change); all other fields are traced leaves.
    """
    cls = dataclasses.dataclass(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls


def mutable_pytree(leaves, static=()):
    """Register a *mutable* class as a pytree over named attributes.

    User-facing scene objects (BSDFs, bitmaps, emitters, sensors) follow the
    reference's mutate-then-reconfigure workflow (``sc.param_map[...].x = v``;
    tutorials cell patterns), so they stay ordinary mutable Python objects but
    flatten into (leaf attrs, static attrs) for tracing inside jitted scene
    builds.
    """

    leaves = tuple(leaves)
    static = tuple(static)

    def wrap(cls):
        def flatten(obj):
            return (
                tuple(getattr(obj, name) for name in leaves),
                tuple(getattr(obj, name) for name in static),
            )

        def unflatten(aux, children):
            obj = object.__new__(cls)
            for name, val in zip(leaves, children):
                object.__setattr__(obj, name, val)
            for name, val in zip(static, aux):
                object.__setattr__(obj, name, val)
            return obj

        jax.tree_util.register_pytree_node(cls, flatten, unflatten)
        cls._pytree_leaves = leaves
        cls._pytree_static = static
        return cls

    return wrap


# ---------------------------------------------------------------------------
# Constants (reference: include/psdr/constants.h:12-32)
# ---------------------------------------------------------------------------

EPSILON = 1e-5
RAY_EPSILON = 1e-3
SHADOW_EPSILON = 1e-3
EDGE_EPSILON = 1e-5

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / (4.0 * PI)


# ---------------------------------------------------------------------------
# Render options (reference: include/psdr/types.h:217-228)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(init=False)
class RenderOption:
    """Static rendering configuration.

    Mirrors ``RenderOption{width,height,spp,sppe,sppse,log_level}`` and its
    positional constructors (reference: include/psdr/types.h:217-222,
    src/psdr.cpp:127-129): ``RenderOption(w, h, s)`` sets spp=sppe=sppse=s;
    ``RenderOption(w, h, s1, s2)`` sets sppe=sppse=s2.
    Plain (non-pytree) dataclass — all fields are static compile-time values.
    """

    width: int = 128
    height: int = 128
    spp: int = 1
    sppe: int = 1
    sppse: int = 1
    log_level: int = 0

    def __init__(self, width=128, height=128, spp=1, sppe=None, sppse=None,
                 log_level=0):
        self.width = int(width)
        self.height = int(height)
        self.spp = int(spp)
        self.sppe = int(spp if sppe is None else sppe)
        self.sppse = int(self.sppe if sppse is None else sppse)
        self.log_level = int(log_level)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


# ---------------------------------------------------------------------------
# Ray (reference: include/psdr/core/ray.h:8-30)
# ---------------------------------------------------------------------------


@pytree
class Ray:
    """A bundle of rays in SoA layout: ``o``/``d`` have shape ``(..., 3)``."""

    o: Any
    d: Any

    def __call__(self, t):
        return self.o + self.d * t[..., None]

    def reversed(self) -> "Ray":
        return Ray(self.o, -self.d)


# ---------------------------------------------------------------------------
# Orthonormal frame (reference: include/psdr/core/frame.h)
# ---------------------------------------------------------------------------


def coordinate_system(n):
    """Build an ONB around unit normal ``n`` (Duff et al. 2017).

    Matches reference ``coordinate_system`` (``core/frame.h:9-28``) so frames
    (and thus local BSDF sample directions) agree bitwise-ish with psdr-jit.
    Returns ``(s, t)`` with shapes matching ``n``.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = jnp.stack([sign * nx * nx * a + 1.0, sign * b, -sign * nx], axis=-1)
    t = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return s, t


@pytree
class Frame:
    """Shading frame with tangent ``s``, bitangent ``t``, normal ``n``."""

    s: Any
    t: Any
    n: Any

    @staticmethod
    def from_normal(n) -> "Frame":
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v):
        return jnp.stack(
            [
                jnp.sum(v * self.s, axis=-1),
                jnp.sum(v * self.t, axis=-1),
                jnp.sum(v * self.n, axis=-1),
            ],
            axis=-1,
        )

    def to_world(self, v):
        return (
            self.s * v[..., 0:1] + self.t * v[..., 1:2] + self.n * v[..., 2:3]
        )


# Trig helpers on local-frame directions (frame.h:64-131).
def cos_theta(v):
    return v[..., 2]


def cos_theta_2(v):
    return jnp.square(v[..., 2])


def sin_theta_2(v):
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]


def sin_theta(v):
    return jnp.sqrt(jnp.maximum(sin_theta_2(v), 0.0))


def sin_phi(v):
    s2 = sin_theta_2(v)
    inv = jax.lax.rsqrt(jnp.maximum(s2, 1e-30))
    return jnp.where(jnp.abs(s2) <= 4.0 * EPSILON, 0.0,
                     jnp.clip(v[..., 1] * inv, -1.0, 1.0))


def cos_phi(v):
    s2 = sin_theta_2(v)
    inv = jax.lax.rsqrt(jnp.maximum(s2, 1e-30))
    return jnp.where(jnp.abs(s2) <= 4.0 * EPSILON, 1.0,
                     jnp.clip(v[..., 0] * inv, -1.0, 1.0))


# ---------------------------------------------------------------------------
# Intersection (reference: include/psdr/core/intersection.h:7-60)
# ---------------------------------------------------------------------------


@pytree
class Intersection:
    """Surface interaction record (SoA over lanes).

    ``mesh_id`` replaces the reference's vcall mesh pointer; BSDF/emitter
    dispatch goes through per-mesh integer tables in the scene data.
    ``J`` is the material-form Jacobian used by the path-space formulation
    (``scene.cpp:679-683``).
    """

    valid: Any          # (...,) bool — hit anything
    t: Any              # (...,) distance
    p: Any              # (..., 3) hit position
    n: Any              # (..., 3) geometric (face) normal
    sh_frame: Frame     # shading frame
    wi: Any             # (..., 3) incident dir in local frame
    uv: Any             # (..., 2) texture uv
    J: Any              # (...,) path-space Jacobian
    dp_du: Any          # (..., 3) position derivative wrt u
    dp_dv: Any          # (..., 3) position derivative wrt v
    bc: Any             # (..., 2) barycentric coords
    tri_id: Any         # (...,) global triangle index (detached payload)
    mesh_id: Any        # (...,) mesh index (detached payload)
    face_indices: Any   # (..., 3) vertex ids of the hit face (mesh-local)

    def is_valid(self):
        return self.valid
