"""Differentiable bitmap UV transforms (reference bitmap.cpp:48-131:
scale / rotation / translation of texture coordinates are AD parameters)
and envmap orientation gradients."""

import numpy as np
import jax
import jax.numpy as jnp

import psdr_jax as psdr
from psdr_jax.core.bitmap import Bitmap


def _smooth_tex(n=16):
    y, x = np.mgrid[0:n, 0:n] / n
    tex = np.stack([np.sin(2 * np.pi * x), np.cos(2 * np.pi * y),
                    x * y], -1).astype(np.float32) * 0.5 + 0.5
    return tex


def test_uv_translate_gradient():
    b = Bitmap.from_array(_smooth_tex())
    uv = jnp.asarray(np.random.default_rng(0).uniform(0.2, 0.8, (512, 2)),
                     jnp.float32)

    def loss(t):
        b.trans = t
        return jnp.sum(b.eval(uv))

    g = np.asarray(jax.grad(loss)(jnp.zeros(2, jnp.float32)))
    eps = 1e-3
    for k in range(2):
        v = jnp.zeros(2, jnp.float32).at[k].set(eps)
        fd = (float(loss(v)) - float(loss(-v))) / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=5e-2, atol=1e-3)
    b.trans = jnp.zeros(2, jnp.float32)


def test_uv_rotation_scale_gradient():
    b = Bitmap.from_array(_smooth_tex())
    uv = jnp.asarray(np.random.default_rng(1).uniform(0.3, 0.7, (512, 2)),
                     jnp.float32)

    def loss(rot, scale):
        b.rot = rot
        b.scale = scale
        return jnp.sum(b.eval(uv))

    g_rot, g_scale = jax.grad(loss, argnums=(0, 1))(
        jnp.float32(0.3), jnp.float32(1.2)
    )
    eps = 1e-3
    fd_rot = (float(loss(jnp.float32(0.3 + eps), jnp.float32(1.2)))
              - float(loss(jnp.float32(0.3 - eps), jnp.float32(1.2)))) / (2 * eps)
    fd_scale = (float(loss(jnp.float32(0.3), jnp.float32(1.2 + eps)))
                - float(loss(jnp.float32(0.3), jnp.float32(1.2 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(g_rot), fd_rot, rtol=5e-2, atol=1e-2)
    np.testing.assert_allclose(float(g_scale), fd_scale, rtol=5e-2, atol=1e-2)
    b.rot = jnp.float32(0.0)
    b.scale = jnp.float32(1.0)


def test_textured_floor_uv_translate_in_render():
    """UV-translation gradient flows through a full render (a UV-mapped
    plane; meshes without UVs evaluate at the texel-corner uv=0 where the
    bilinear derivative is discontinuous)."""
    from psdr_jax.core import transform as xf

    sc = psdr.Scene()
    sc.opts.width = sc.opts.height = 16
    sc.opts.spp = 4
    sc.opts.sppe = sc.opts.sppse = 0
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(
        xf.look_at([0, 0, 10.0], [0, 0, 0], [0, 1.0, 0]), np.float32
    )
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF(Bitmap.from_array(_smooth_tex())), "tex")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0] * 3), "black")

    floor = psdr.Mesh()
    floor.use_face_normals = True
    floor.load_raw(
        np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        uvs=np.asarray([[0.1, 0.1], [0.9, 0.1], [0.9, 0.9], [0.1, 0.9]],
                       np.float32),
        face_uvs=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_Mesh(floor, None, "tex")
    light = psdr.Mesh()
    light.use_face_normals = True
    light.enable_edges = False
    light.load_raw(
        np.asarray([[-0.3, -0.3, 4], [0.3, -0.3, 4], [0.3, 0.3, 4],
                    [-0.3, 0.3, 4]], np.float32),
        np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
    )
    sc.add_Mesh(light, None, "black", psdr.AreaLight([60.0] * 3))
    sc.configure()

    integ = psdr.PathTracer(1)
    bmp = sc.bsdfs[0].reflectance

    def loss(t):
        bmp.trans = t
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    g = np.asarray(jax.grad(loss)(jnp.zeros(2, jnp.float32)))
    eps = 5e-3
    v = jnp.asarray([eps, 0.0], jnp.float32)
    fd = (float(loss(v)) - float(loss(-v))) / (2 * eps)
    bmp.trans = jnp.zeros(2, jnp.float32)
    assert np.isfinite(g).all() and abs(g[0]) > 0
    np.testing.assert_allclose(g[0], fd, rtol=0.15, atol=1e-4)


def test_envmap_rotation_gradient():
    """Envmap to_world orientation is differentiable (set_transform)."""
    rng = np.random.default_rng(2)
    tex = rng.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32)

    import test_envmap as te

    sc = te._plane_under_sky()
    sc.emitters[0].radiance = psdr.Bitmap3f(tex)
    sc.configure()
    integ = psdr.PathTracer(1)
    env = sc.emitters[0]

    from psdr_jax.core import transform as xf

    # rotate about a HORIZONTAL axis: a vertical-axis rotation leaves the
    # horizontal plane's irradiance exactly invariant (zero gradient)
    def loss(angle):
        env.to_world_left = xf.rotate(jnp.asarray([1.0, 0.0, 0.0]), angle)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    g = float(jax.grad(loss)(jnp.float32(10.0)))
    eps = 0.5
    fd = (float(loss(jnp.float32(10 + eps))) -
          float(loss(jnp.float32(10 - eps)))) / (2 * eps)
    env.to_world_left = jnp.eye(4, dtype=jnp.float32)
    assert np.isfinite(g) and abs(fd) > 1e-4
    np.testing.assert_allclose(g, fd, rtol=0.2, atol=1e-4)
