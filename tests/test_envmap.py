"""Environment-map emitter tests (reference: src/emitter/envmap.cpp).

A *uniform* envmap gives closed-form expectations: a diffuse surface under
uniform sky radiance L sees irradiance pi*L, so its radiance is rho*L; the
sky itself evaluates to L in any direction.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.core import transform as xf


def _plane_under_sky(L=1.0, rho=0.6, w=32, envres=(8, 16)):
    """Diffuse plane at z=0 viewed from above; uniform envmap radiance L."""
    sc = psdr.Scene()
    sc.opts.width = w
    sc.opts.height = w
    sc.opts.spp = 32
    sc.opts.sppe = 0
    sc.opts.sppse = 0
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(
        xf.look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        np.float32,
    )
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF([rho, rho, rho]), "rho")

    plane = psdr.Mesh()
    plane.use_face_normals = True
    plane.enable_edges = False
    plane.load_raw(
        np.asarray(
            [[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32
        ),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_Mesh(plane, None, "rho")

    env = psdr.EnvironmentMap(np.full(envres + (3,), L, np.float32))
    sc.add_EnvironmentMap(env)
    return sc


def test_uniform_sky_diffuse_plane():
    L, rho = 2.0, 0.6
    sc = _plane_under_sky(L=L, rho=rho)
    sc.configure()
    img = np.asarray(psdr.PathTracer(1).renderC(sc, 0, seed=0)).reshape(32, 32, 3)
    # center of the plane: radiance = rho * L (perfect white-sky furnace)
    center = img[8:24, 8:24, 0]
    np.testing.assert_allclose(center.mean(), rho * L, rtol=0.03)


def test_uniform_sky_seen_directly():
    """Camera rays that miss geometry terminate on the bounding-box mesh and
    return the envmap radiance (scene.cpp:435-485 trick)."""
    L = 2.0
    sc = _plane_under_sky(L=L)
    # shrink the plane so the camera sees sky around it
    sc.meshes[0].to_world_raw = jnp.asarray(
        xf.scale(jnp.asarray([0.05, 0.05, 1.0])), jnp.float32
    )
    sc.configure()
    img = np.asarray(psdr.PathTracer(1).renderC(sc, 0, seed=0)).reshape(32, 32, 3)
    corner = img[:4, :4, 0]  # sky
    np.testing.assert_allclose(corner, L, rtol=1e-3)


def test_envmap_nee_vs_bsdf_sampling():
    """Direct lighting via envmap NEE and via BSDF sampling must agree
    (validates sample_position / sample_position_pdf inverse pair)."""
    # non-uniform envmap: two bright bands
    rng = np.random.default_rng(0)
    tex = rng.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    tex[2] *= 10.0
    sc = _plane_under_sky()
    sc.emitters[0].radiance = psdr.Bitmap3f(tex)
    sc.configure()
    means = []
    for mis in (0, 1):
        acc = 0.0
        for seed in range(4):
            acc += np.asarray(psdr.Direct(mis).renderC(sc, 0, seed)).mean()
        means.append(acc / 4)
    assert abs(means[0] - means[1]) < 0.15 * max(means), means


def test_envmap_scale_gradient():
    """d(image)/d(scale) is exact: image is linear in the envmap scale."""
    sc = _plane_under_sky(L=1.0)
    sc.configure()
    integ = psdr.PathTracer(1)
    env = sc.emitters[0]
    base = env.scale

    def render(s):
        env.scale = base * s
        return integ.renderD(sc, 0, seed=0)

    img1, dimg = jax.jvp(render, (jnp.float32(1.0),), (jnp.float32(1.0),))
    img2 = render(jnp.float32(2.0))
    env.scale = base
    np.testing.assert_allclose(
        np.asarray(dimg), np.asarray(img2 - img1), rtol=1e-3, atol=1e-4
    )
    assert float(jnp.abs(dimg).mean()) > 0.1


def test_envmap_microfacet_render():
    """BASELINE config #3 shape: envmap + Microfacet, with secondary edges."""
    sc = _plane_under_sky()
    sc.bsdfs[0] = psdr.MicrofacetBSDF(
        specular=(0.04,) * 3, diffuse=(0.5,) * 3, roughness=0.3
    )
    # occluder casting a sky shadow, with edges enabled
    occ = psdr.Mesh()
    occ.use_face_normals = True
    occ.load_raw(
        np.asarray([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_Mesh(occ, None, "rho")
    sc.opts.sppse = 4
    sc.configure()
    integ = psdr.PathTracer(1)
    img = np.asarray(integ.renderC(sc, 0, seed=0))
    assert np.isfinite(img).all() and img.mean() > 0.05

    occ_base = sc.meshes[-1].to_world_raw

    def mean_img(tx):
        sc.meshes[-1].to_world_raw = occ_base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
    sc.meshes[-1].to_world_raw = occ_base
    assert np.isfinite(float(d))


# ---------------------------------------------------------------------------
# Secondary-edge oracle under envmap lighting (the AABB-projected boundary
# path: scene.sample_boundary_segment_direct with an envmap emitter)
# ---------------------------------------------------------------------------

def _envmap_shadow_scene(w=32, sppse=64, rho=0.8, L=1.0):
    """Diffuse receiver z=0 under a UNIFORM sky L; black occluder quad at
    z=2 spanning x in [-1,1], y in [-3,3] (edges on); ortho camera views
    x in [1.5,3.5], y in [-1,1] from z=10."""
    sc = psdr.Scene()
    sc.opts.width = w
    sc.opts.height = w
    sc.opts.spp = 4
    sc.opts.sppe = 0
    sc.opts.sppse = sppse
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(
        xf.look_at([2.5, 0.0, 10.0], [2.5, 0.0, 0.0], [0.0, 1.0, 0.0]),
        np.float32,
    )
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF([rho, rho, rho]), "rho")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")

    recv = psdr.Mesh()
    recv.use_face_normals = True
    recv.enable_edges = False
    recv.load_raw(
        np.asarray([[-12, -12, 0], [12, -12, 0], [12, 12, 0], [-12, 12, 0]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_Mesh(recv, None, "rho")

    occ = psdr.Mesh()
    occ.use_face_normals = True
    occ.enable_edges = True
    occ.load_raw(
        np.asarray([[-1, -3, 2], [1, -3, 2], [1, 3, 2], [-1, 3, 2]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_Mesh(occ, None, "black")

    env = psdr.EnvironmentMap(np.full((8, 16, 3), L, np.float32))
    sc.add_EnvironmentMap(env)
    return sc, occ


def _envmap_shadow_oracle(rho=0.8, L=1.0):
    """Quadrature-exact translation derivative of the mean image.

    Uniform sky: receiver radiance = (rho/pi) * (pi*L - L*B(x, y)) with
    B = projected solid angle of the occluder strip,
    B(x,y) = int_{-1}^{1} int_{-3}^{3} 4 / ((x'-x)^2 + (y'-y)^2 + 4)^2.
    Translating the occluder by tx shifts B in x, so
    d(mean)/dtx = (rho/pi)(L/A) * int_y [B(3.5,y) - B(1.5,y)] dy,  A = 4.
    """
    xs = np.linspace(-1, 1, 241)
    ys = np.linspace(-3, 3, 721)
    X, Y = np.meshgrid(xs, ys, indexing="ij")

    def B(x, y):
        integ = 4.0 / ((X - x) ** 2 + (Y - y) ** 2 + 4.0) ** 2
        return np.trapezoid(np.trapezoid(integ, ys, axis=1), xs)

    yv = np.linspace(-1, 1, 41)
    diff = np.asarray([B(3.5, y) - B(1.5, y) for y in yv])
    return (rho / np.pi) * (L / 4.0) * np.trapezoid(diff, yv)


def test_envmap_secondary_edge_gradient_oracle():
    """The envmap boundary estimator (AABB-projected p2) must reproduce the
    quadrature-exact shadow-translation derivative — closes the gap where
    this path was previously checked only for finiteness."""
    rho, L = 0.8, 1.0
    sc, occ = _envmap_shadow_scene(w=32, sppse=64, rho=rho, L=L)
    sc.configure()
    integ = psdr.PathTracer(1)
    base = occ.to_world_raw

    def mean_img(tx, seed):
        occ.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=seed))

    grads = []
    for seed in range(6):
        _, d = jax.jvp(
            lambda t: mean_img(t, seed), (jnp.float32(0.0),), (jnp.float32(1.0),)
        )
        grads.append(float(d))
    occ.to_world_raw = base
    g = np.mean(grads)
    expect = _envmap_shadow_oracle(rho, L)
    assert expect < 0
    np.testing.assert_allclose(g, expect, rtol=0.25)


def test_envmap_secondary_edge_interior_alone_misses_gradient():
    sc, occ = _envmap_shadow_scene(w=32, sppse=8)
    sc.opts.sppse = 0
    sc.configure()
    integ = psdr.PathTracer(1)
    base = occ.to_world_raw

    def mean_img(tx):
        occ.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
    occ.to_world_raw = base
    assert abs(float(d)) < 0.25 * abs(_envmap_shadow_oracle())


def test_multi_emitter_mis_partitions_unity():
    """Envmap + area light: NEE-only, BSDF-only and MIS direct renders must
    agree in expectation.  DEVIATION from the reference documented in
    envmap.py sample_position_pdf: envmap.cpp:142-162 omits the
    emitter-selection probability that area.cpp:48-59 includes, biasing the
    reference's MIS on envmap paths in multi-emitter scenes; we include it."""
    sc = _plane_under_sky(w=32, rho=0.6, L=0.4)
    sc.opts.spp = 256
    # add a small area light above the plane
    quad = psdr.Mesh()
    quad.use_face_normals = True
    quad.enable_edges = False
    quad.load_raw(
        np.asarray([[2, -1, 4], [2, 1, 4], [4, 1, 4], [4, -1, 4]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    sc.add_Mesh(quad, None, "black", psdr.AreaLight([6.0, 6.0, 6.0]))
    sc.configure()

    means = []
    for mis in (0, 1, 2):
        img = np.asarray(psdr.Direct(mis).renderC(sc, 0, seed=mis + 1))
        means.append(float(img.mean()))
    # all three estimators target the same integral
    assert abs(means[2] - means[0]) < 0.05 * means[0], means
    assert abs(means[2] - means[1]) < 0.08 * means[1], means


def test_portrait_ortho_film_inside_sky_box():
    """Portrait films (aspect < 1) span y in [-1/aspect, 1/aspect] in
    camera space; the envmap bound box must contain the WHOLE film plane
    or the top/bottom rows originate outside the inward-facing sky box and
    render envmap radiance in front of the geometry (regression for the
    hardcoded +-1.2 corner containment)."""
    L, rho = 0.4, 0.6
    sc = _plane_under_sky(L=L, rho=rho, w=16)
    sc.opts.width = 16
    sc.opts.height = 48  # aspect 1/3 -> film y in [-3, 3]
    sc.opts.spp = 64
    sc.configure()
    img = np.asarray(psdr.PathTracer(1).renderC(sc, 0, seed=2))
    img = img.reshape(48, 16, 3)
    # the 10x10 plane covers the film everywhere (|y_cam| <= 3 < 5): every
    # row must show the lit plane (~rho*L), not raw envmap radiance (=L)
    row_means = img.mean(axis=(1, 2))
    assert np.all(np.abs(row_means - rho * L) < 0.35 * rho * L), (
        row_means.min(), row_means.max()
    )


def test_default_constant_envmap_configures_and_renders():
    """EnvironmentMap() (constant radiance, 1x1 bitmap) must survive
    configure: the importance grid falls back to a minimal 2x2 sin(theta)
    table (regression: build_envmap_distribution asserted w,h > 1)."""
    sc2 = psdr.Scene()
    sc2.opts.width = sc2.opts.height = 16
    sc2.opts.spp = 16
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(
        xf.look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
        np.float32,
    )
    sc2.add_Sensor(cam)
    sc2.add_BSDF(psdr.DiffuseBSDF([0.5, 0.5, 0.5]), "rho")
    plane = psdr.Mesh()
    plane.use_face_normals = True
    plane.enable_edges = False
    plane.load_raw(
        np.asarray([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    sc2.add_Mesh(plane, None, "rho")
    sc2.add_EnvironmentMap(psdr.EnvironmentMap())  # default: uniform sky
    sc2.configure()
    img = np.asarray(psdr.PathTracer(1).renderC(sc2, 0, seed=0))
    assert np.isfinite(img).all() and img.mean() > 0.1
