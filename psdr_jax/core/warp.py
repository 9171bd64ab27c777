"""Sample warping functions (reference: include/psdr/core/warp.h)."""

from __future__ import annotations

import jax.numpy as jnp

from .types import INV_PI, PI
from .math import safe_sqrt, squared_norm, safe_div


def _sincos_pio4(x):
    """sin(x), cos(x) for |x| <= pi/4 — minimax polynomials (<=2 ulp f32).

    jnp.sin/cos pay general range reduction the warp never needs: its
    argument is (pi/4)*(rp/r) with |rp| <= |r|.  The reduced-range
    polynomials fuse into the neighbouring elementwise ops of the
    hemisphere-sampling hot loop.
    """
    z = x * x
    s = x + x * z * (
        -1.6666654611e-1 + z * (8.3321608736e-3 + z * (-1.9515295891e-4))
    )
    c = 1.0 - 0.5 * z + z * z * (
        4.166664568298827e-2
        + z * (-1.388731625493765e-3 + z * 2.443315711809948e-5)
    )
    return s, c


def square_to_uniform_disk_concentric(sample):
    """Shirley's low-distortion concentric square->disk map (warp.h:16-50)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    quadrant_1_or_3 = jnp.abs(x) < jnp.abs(y)
    r = jnp.where(quadrant_1_or_3, y, x)
    rp = jnp.where(quadrant_1_or_3, x, y)
    # phi = pi/2 - phi' in quadrants 1/3 else phi', with phi' = pi/4*(rp/r):
    # cos/sin of phi are a swap of sin/cos of phi' (|phi'| <= pi/4).
    # x == y == 0 falls out: safe_div -> 0, quadrant False -> (cos,sin)=(1,0)
    # and r = 0 zeroes the point.
    s, c = _sincos_pio4(0.25 * PI * safe_div(rp, r))
    cos_phi = jnp.where(quadrant_1_or_3, s, c)
    sin_phi = jnp.where(quadrant_1_or_3, c, s)
    return jnp.stack([r * cos_phi, r * sin_phi], axis=-1)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere via concentric disk (warp.h:55-64)."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - squared_norm(p))
    return jnp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(v):
    """cos(theta)/pi (warp.h:68-74)."""
    return INV_PI * v[..., 2]


def square_to_uniform_triangle(sample):
    """Square -> barycentric coordinates, uniform by area (warp.h:79-83)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return jnp.stack([1.0 - t, t * sample[..., 1]], axis=-1)


def square_to_uniform_triangle_pdf(_p):
    return 2.0
