"""Vector math helpers shared across the renderer.

Counterpart of the reference's ``include/psdr/utils.h`` (bilinear,
Möller-Trumbore, fresnel, MIS weights, ...).  Every helper is NaN-safe under
reverse- and forward-mode AD: divisions and sqrts that can hit 0/0 in masked
lanes use the double-``where`` pattern so dead lanes cannot poison gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import Ray

_TINY = 1e-20


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def squared_norm(v):
    return jnp.sum(v * v, axis=-1)


def norm(v):
    return safe_sqrt(squared_norm(v))


def cross(a, b):
    return jnp.cross(a, b)


def safe_sqrt(x):
    """sqrt(max(x, 0)) with a finite gradient at x <= 0."""
    safe_x = jnp.maximum(x, _TINY)
    return jnp.where(x > 0.0, jnp.sqrt(safe_x), 0.0)


def safe_rsqrt(x):
    safe_x = jnp.maximum(x, _TINY)
    return jnp.where(x > 0.0, jax.lax.rsqrt(safe_x), 0.0)


def safe_div(a, b):
    """a / b, returning 0 (with zero gradient) where |b| is ~0."""
    safe_b = jnp.where(jnp.abs(b) > _TINY, b, 1.0)
    return jnp.where(jnp.abs(b) > _TINY, a / safe_b, 0.0)


def rcp(x):
    """Reciprocal matching the reference's drjit::rcp (inf at 0 tolerated)."""
    return 1.0 / x


def normalize(v):
    """v / |v| with NaN-safe gradient for |v| -> 0 lanes."""
    n2 = squared_norm(v)
    inv = safe_rsqrt(n2)
    return v * inv[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def sign_eps(x, eps):
    """{-1, 0, +1} with a dead-zone of +-eps (reference utils.h:48-54)."""
    return jnp.where(x > eps, 1, jnp.where(x < -eps, -1, 0)).astype(jnp.int32)


def rgb2luminance(rgb):
    """BT.709 luminance (utils.h:77-80)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def bilinear(p0, e1, e2, st):
    """p0 + e1*s + e2*t for (...,3) points and (...,2) st (utils.h:65-68)."""
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def bilinear2(p0, e1, e2, st):
    """Same for 2D points (uv interpolation)."""
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def mis_weight(pdf1, pdf2):
    """Power heuristic (beta=2), reference utils.h:278-281."""
    w1 = jnp.square(pdf1)
    w2 = jnp.square(pdf2)
    return safe_div(w1, w1 + w2)


def ray_intersect_triangle(p0, e1, e2, ray: Ray):
    """Möller-Trumbore returning ((u, v), t) — differentiable.

    Matches reference ``ray_intersect_triangle`` (utils.h:83-93).  No masking
    is applied here; callers mask by barycentric/t validity.  Division is
    NaN-safe so rays parallel to the triangle plane yield 0, not NaN.
    """
    h = cross(ray.d, e2)
    a = dot(e1, h)
    f = safe_div(1.0, a)
    s = ray.o - p0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray.d, q)
    t = f * dot(e2, q)
    return jnp.stack([u, v], axis=-1), t


def ray_intersect_scene_aabb(ray: Ray, lower, upper):
    """Intersect rays against a scene AABB from the *inside*.

    Returns (t, n, G) like reference utils.h:145-164: distance to the exit
    face, inward face normal, and geometry factor ``dot(n,-d)/t^2``.
    """
    # a zero direction component never exits through that axis: its slab
    # time must be +inf (reference 1/d -> inf; safe_div's 0 collapsed t to
    # 0 and silently zeroed the lane's G — review find 2026-08-20)
    inv_d = safe_div(1.0, ray.d)
    t1 = (lower - ray.o) * inv_d
    t2 = (upper - ray.o) * inv_d
    t_far = jnp.maximum(t1, t2)  # per-axis exit distances
    t_far = jnp.where(ray.d == 0.0, jnp.inf, t_far)
    idx = jnp.argmin(t_far, axis=-1)
    t = jnp.min(t_far, axis=-1)
    # inward normal of the exit face: -sign(d) on the exit axis
    n = -jnp.sign(ray.d) * jax.nn.one_hot(idx, 3, dtype=ray.d.dtype)
    g = dot(n, -ray.d) * safe_div(1.0, jnp.square(t))
    return t, n, g


def fresnel_conductor(eta_r, eta_i, cos_theta_i):
    """Conductor Fresnel with complex IOR (utils.h:168-184)."""
    cos_theta_i_2 = jnp.square(cos_theta_i)
    sin_theta_i_2 = 1.0 - cos_theta_i_2
    sin_theta_i_4 = jnp.square(sin_theta_i_2)
    if eta_r.ndim > cos_theta_i.ndim:
        cos_theta_i = cos_theta_i[..., None]
        cos_theta_i_2 = cos_theta_i_2[..., None]
        sin_theta_i_2 = sin_theta_i_2[..., None]
        sin_theta_i_4 = sin_theta_i_4[..., None]
    temp_1 = jnp.square(eta_r) - jnp.square(eta_i) - sin_theta_i_2
    a_2_pb_2 = safe_sqrt(jnp.square(temp_1) + 4.0 * jnp.square(eta_i * eta_r))
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))
    term_1 = a_2_pb_2 + cos_theta_i_2
    term_2 = 2.0 * cos_theta_i * a
    r_s = safe_div(term_1 - term_2, term_1 + term_2)
    term_3 = a_2_pb_2 * cos_theta_i_2 + sin_theta_i_4
    term_4 = term_2 * sin_theta_i_2
    r_p = r_s * safe_div(term_3 - term_4, term_3 + term_4)
    return 0.5 * (r_s + r_p)


def fresnel_dielectric(eta, cos_theta_i):
    """Dielectric Fresnel (utils.h:186-215).

    Returns (r, cos_theta_t, eta_it, eta_ti).
    """
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = jnp.where(outside, eta, rcp_eta)
    eta_ti = jnp.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - (1.0 - jnp.square(cos_theta_i)) * jnp.square(eta_ti)
    cos_theta_i_abs = jnp.abs(cos_theta_i)
    cos_theta_t_abs = safe_sqrt(cos_theta_t_sqr)

    index_matched = eta == 1.0
    special_case = index_matched | (cos_theta_i_abs == 0.0)
    r_sc = jnp.where(index_matched, 0.0, 1.0)

    a_s = safe_div(cos_theta_i_abs - eta_it * cos_theta_t_abs,
                   cos_theta_i_abs + eta_it * cos_theta_t_abs)
    a_p = safe_div(cos_theta_t_abs - eta_it * cos_theta_i_abs,
                   cos_theta_t_abs + eta_it * cos_theta_i_abs)
    r = 0.5 * (jnp.square(a_s) + jnp.square(a_p))
    r = jnp.where(special_case, r_sc, r)
    # drjit mulsign_neg semantics: sign(+0.0) is +1, so an exactly-grazing
    # cos_theta_i gives -cos_theta_t_abs (jnp.sign would zero it)
    cos_theta_t = -jnp.where(cos_theta_i >= 0.0, 1.0, -1.0) * cos_theta_t_abs
    return r, cos_theta_t, eta_it, eta_ti


def mulsign(x, s):
    """x * sign(s) with sign(0) = +1 (drjit mulsign semantics)."""
    return jnp.where(s >= 0.0, x, -x)


def scrub_nonfinite(x):
    """Replace non-finite entries by 0 (reference integrator.cpp:126)."""
    return jnp.where(jnp.isfinite(x), x, 0.0)


# Below this table size a dense compare-count beats binary search on the
# VPU (one (lanes, N) compare + row reduction, zero gathers); above it,
# log2(N) shared-table gathers win.
SEARCHSORTED_DENSE_MAX = 2048


def searchsorted_1d(cdf, u):
    """First index i with cdf[i] >= u, one shared (N,) table for all lanes.

    Small tables use a dense comparison count (elementwise, no gathers);
    large tables use binary search with SHARED-table
    ``jnp.take`` lookups, which lower to efficient dynamic gathers (unlike
    per-row ``take_along_axis``).
    """
    n = cdf.shape[-1]
    if n <= SEARCHSORTED_DENSE_MAX:
        flat = u.reshape(-1)
        idx = jnp.sum(
            cdf[None, :] < flat[:, None], axis=-1, dtype=jnp.int32
        )
        return jnp.minimum(idx, n - 1).reshape(u.shape)
    lo = jnp.zeros(u.shape, jnp.int32)
    hi = jnp.full(u.shape, n - 1, jnp.int32)
    steps = max(1, (n - 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) // 2
        cm = jnp.take(cdf, mid)
        pred = cm < u
        lo = jnp.where(pred, mid + 1, lo)
        hi = jnp.where(pred, hi, mid)
    return lo
