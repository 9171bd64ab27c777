"""Interior-term gradient tests (smooth scene parameters).

With a fixed seed the interior estimator is a smooth function of albedo /
radiance / texture parameters, so fixed-seed finite differences must match AD
almost exactly — this isolates `stop_gradient` placement bugs from MC noise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from scenes import make_cbox


@pytest.fixture(scope="module")
def cbox():
    sc = make_cbox(width=16, height=16, spp=4)
    sc.configure()
    return sc


def test_albedo_gradient_fd(cbox):
    """d(mean image)/d(white-wall albedo scalar): AD vs fixed-seed FD."""
    integ = psdr.PathTracer(max_depth=2)
    bsdf = cbox.param_map["BSDF[id=white]"]
    base = bsdf.reflectance.data

    def loss(s):
        bsdf.reflectance.data = base * s
        return jnp.mean(integ.renderD(cbox, 0, seed=0))

    # jitted: eager, every op of the render compiles on its own
    g = float(jax.jit(jax.grad(loss))(jnp.float32(1.0)))
    eps = 1e-2
    floss = jax.jit(loss)
    fd = (float(floss(jnp.float32(1 + eps))) - float(floss(jnp.float32(1 - eps)))) / (2 * eps)
    bsdf.reflectance.data = base
    assert g > 0.0
    np.testing.assert_allclose(g, fd, rtol=2e-2)


def test_radiance_gradient_linearity(cbox):
    """The image is linear in emitter radiance at depth<=1 so the jvp equals
    the exact difference quotient."""
    sc = make_cbox(width=16, height=16, spp=4)
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    em = sc.emitters[0]
    base = em.radiance

    def render(s):
        em.radiance = base * s
        return integ.renderD(sc, 0, seed=0)

    img1, dimg = jax.jvp(render, (jnp.float32(1.0),), (jnp.float32(1.0),))
    img2 = render(jnp.float32(2.0))
    em.radiance = base
    np.testing.assert_allclose(
        np.asarray(dimg), np.asarray(img2 - img1), rtol=1e-3, atol=1e-5
    )
    assert float(jnp.abs(dimg).mean()) > 0.0


def test_texture_gradient_fd():
    """Textured reflectance: gradients flow into individual texels."""
    sc = make_cbox(width=16, height=16, spp=4)
    tex = np.full((4, 4, 3), 0.5, np.float32)
    sc.bsdfs[2].reflectance = psdr.Bitmap3f(tex)  # "white" walls
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    bsdf = sc.bsdfs[2]
    base = bsdf.reflectance.data

    def loss(d):
        bsdf.reflectance.data = base + d
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    g = np.asarray(jax.grad(loss)(jnp.zeros((4, 4, 3), jnp.float32)))
    bsdf.reflectance.data = base
    assert (g > 0).any()
    # FD along a random direction
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(4, 4, 3)), jnp.float32) * 0.01
    fd = (float(loss(v)) - float(loss(-v))) / 2.0
    np.testing.assert_allclose(float((g * np.asarray(v)).sum()), fd, rtol=5e-2)


def test_camera_pose_gradient_nonzero(cbox):
    """Pose gradients flow through to_world of the sensor."""
    integ = psdr.PathTracer(max_depth=1)
    cam = cbox.sensors[0]
    base = cam.to_world_raw

    def loss(dx):
        cam.to_world_raw = base.at[0, 3].add(dx)
        # weight by x-position so lateral motion has nonzero derivative
        img = integ.renderD(cbox, 0, seed=0)
        w = jnp.arange(img.shape[0], dtype=jnp.float32) % 16
        return jnp.mean(img * w[:, None])

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    cam.to_world_raw = base
    assert np.isfinite(g) and abs(g) > 0.0


def test_vertex_gradient_interior_nonzero(cbox):
    """Vertex gradients flow through the solid-angle re-intersection."""
    integ = psdr.PathTracer(max_depth=1)
    mesh = cbox.meshes[-1]  # tall block
    base = mesh.vertex_positions_raw

    def loss(d):
        mesh.vertex_positions_raw = base + d
        return jnp.mean(integ.renderD(cbox, 0, seed=0))

    g = np.asarray(jax.grad(loss)(jnp.zeros_like(base)))
    mesh.vertex_positions_raw = base
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
