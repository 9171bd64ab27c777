"""Warp function statistical tests (reference: include/psdr/core/warp.h)."""

import numpy as np
import jax.numpy as jnp

from psdr_jax.core import warp
from psdr_jax.core.sampler import Sampler


def _uniform2(n, seed=0):
    return Sampler(seed, jnp.arange(n, dtype=jnp.uint32)).next_2d()


def test_concentric_disk_uniform():
    p = np.asarray(warp.square_to_uniform_disk_concentric(_uniform2(200_000)))
    r2 = (p ** 2).sum(-1)
    assert r2.max() <= 1.0 + 1e-6
    # uniform in area: r^2 uniform on [0,1], angle uniform
    assert abs(r2.mean() - 0.5) < 3e-3
    ang = np.arctan2(p[:, 1], p[:, 0])
    assert abs(ang.mean()) < 2e-2


def test_cosine_hemisphere_moments():
    v = np.asarray(warp.square_to_cosine_hemisphere(_uniform2(200_000, 1)))
    assert np.all(v[:, 2] >= 0.0)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # E[cos theta] under pdf cos/pi = 2/3
    assert abs(v[:, 2].mean() - 2.0 / 3.0) < 3e-3


def test_cosine_hemisphere_pdf_consistency():
    """MC estimate of integral of pdf over the hemisphere must be 1:
    sample cosine-warped, average pdf_other/pdf_self stays consistent."""
    v = warp.square_to_cosine_hemisphere(_uniform2(100_000, 2))
    pdf = np.asarray(warp.square_to_cosine_hemisphere_pdf(v))
    np.testing.assert_allclose(pdf, np.asarray(v[:, 2]) / np.pi, rtol=1e-5)
    # importance-sampling identity: E[1/pdf] = hemisphere solid angle (2*pi)
    assert abs((1.0 / pdf).mean() - 2.0 * np.pi) < 0.15


def test_uniform_triangle():
    b = np.asarray(warp.square_to_uniform_triangle(_uniform2(200_000, 3)))
    assert b.min() >= 0.0
    assert np.all(b.sum(-1) <= 1.0 + 1e-6)
    # uniform over the unit right triangle: E[u] = E[v] = 1/3
    assert abs(b[:, 0].mean() - 1.0 / 3.0) < 3e-3
    assert abs(b[:, 1].mean() - 1.0 / 3.0) < 3e-3
