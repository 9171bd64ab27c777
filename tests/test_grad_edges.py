"""Boundary-term gradient tests with ANALYTIC oracles.

These isolate each boundary estimator exactly like the reference's
Forward_AD_envmap tutorial isolates (spp, sppe, sppse):

* primary edge: an emissive quad partially covering an orthographic view —
  d(mean)/d(translation) = L / 2 exactly (screen coverage derivative).
* secondary edge: a straight occluder edge between a small light and a
  diffuse receiver — the shadow-boundary velocity and irradiance jump are
  known in closed form.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.core import transform as xf


def _quad_mesh(v0, v1, v2, v3, flip=False, edges=True):
    """Planar quad with normal = cross(v1-v0, v2-v0) (flip to reverse)."""
    m = psdr.Mesh()
    m.use_face_normals = True
    m.enable_edges = edges
    faces = [[0, 1, 2], [0, 2, 3]] if not flip else [[0, 2, 1], [0, 3, 2]]
    m.load_raw(
        np.asarray([v0, v1, v2, v3], np.float32),
        np.asarray(faces, np.int32),
    )
    return m


def _ortho_cam(center_xy, z, look_down=True):
    cam = psdr.OrthographicCamera(0.1, 100.0)
    target = [center_xy[0], center_xy[1], 0.0]
    origin = [center_xy[0], center_xy[1], z]
    cam.to_world = np.asarray(
        xf.look_at(origin, target, [0.0, 1.0, 0.0]), np.float32
    )
    return cam


# ---------------------------------------------------------------------------
# Primary edges
# ---------------------------------------------------------------------------

def _primary_edge_scene(x0=0.3, w=64, sppe=8):
    """Emissive quad z=5 spanning x in [-2, x0], y in [-2, 2]; ortho camera at
    origin looking +z over world x, y in [-1, 1]^2."""
    sc = psdr.Scene()
    sc.opts.width = w
    sc.opts.height = w
    sc.opts.spp = 4
    sc.opts.sppe = sppe
    sc.opts.sppse = 0
    cam = psdr.OrthographicCamera(0.1, 100.0)
    sc.add_Sensor(cam)  # identity to_world: at origin looking +z
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    light = _quad_mesh(
        [-2, -2, 5], [x0, -2, 5], [x0, 2, 5], [-2, 2, 5], flip=True
    )
    sc.add_Mesh(light, None, "black", psdr.AreaLight([1.0, 1.0, 1.0]))
    return sc, light


def test_primary_edge_primal_coverage():
    sc, _ = _primary_edge_scene(x0=0.3)
    sc.configure()
    img = np.asarray(psdr.PathTracer(0).renderC(sc, 0, seed=0))
    # covered sample-space fraction = (x0 + 1) / 2 = 0.65
    np.testing.assert_allclose(img.mean(), 0.65, atol=0.01)


def test_primary_edge_gradient_analytic():
    """d(mean)/d(tx) = L * d(coverage)/d(tx) = 1/2 exactly."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=16)
    sc.configure()
    integ = psdr.PathTracer(0)
    base = light.to_world_raw

    def mean_img(tx, seed):
        light.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=seed))

    @jax.jit  # one program for every seed (eager, each op compiles alone)
    def dmean(seed):
        return jax.jvp(lambda t: mean_img(t, seed), (jnp.float32(0.0),),
                       (jnp.float32(1.0),))[1]

    grads = [float(dmean(jnp.uint32(seed))) for seed in range(4)]
    light.to_world_raw = base
    g = np.mean(grads)
    np.testing.assert_allclose(g, 0.5, rtol=0.05)


def test_primary_edge_interior_alone_misses_gradient():
    """Without sppe the translation gradient is ~0 — proves the edge term is
    what carries it (the reference's reason to exist)."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=8)
    sc.opts.sppe = 0
    sc.configure()
    integ = psdr.PathTracer(0)
    base = light.to_world_raw

    def mean_img(tx):
        light.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
    light.to_world_raw = base
    assert abs(float(d)) < 0.01


def test_primary_edge_vertex_gradient():
    """Gradient w.r.t. raw vertex positions (not just transforms)."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=16)
    sc.configure()
    integ = psdr.PathTracer(0)
    base = light.vertex_positions_raw

    def mean_img(d, seed):
        light.vertex_positions_raw = base + d
        return jnp.mean(integ.renderD(sc, 0, seed=seed))

    # move only the two x0-edge vertices (1 and 2) in +x: half the effect of
    # translating the whole quad (edge endpoints move, coverage derivative
    # is still 1/2 since the whole visible right edge moves)
    tang = jnp.zeros_like(base).at[1, 0].set(1.0).at[2, 0].set(1.0)
    grads = []
    for seed in range(4):
        _, d = jax.jvp(
            lambda t: mean_img(t * tang, seed),
            (jnp.float32(0.0),), (jnp.float32(1.0),),
        )
        grads.append(float(d))
    light.vertex_positions_raw = base
    np.testing.assert_allclose(np.mean(grads), 0.5, rtol=0.06)


def test_primary_edge_bf16_adjoint_delta_pinned():
    """Pin the documented bf16 rounding of the reverse-mode edge adjoint.

    The default ``PSDR_SPLAT_T=rows_bf16`` transpose gathers the loss
    cotangent image from a bf16 table (ops/image.py).  This test pins the
    contract: the deterministic rounding stays ~0.4% (<1e-2 relative) of
    the f32 gradient, and the f32 ``rows``
    transpose matches forward-mode exactly.  A change that amplifies the
    bf16 error past 1% fails here.

    The loss is a *random-weighted* pixel sum: a mean loss has a
    power-of-two adjoint (exact in bf16) and would pin nothing.
    """
    from psdr_jax.ops import image as image_ops

    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=16)
    sc.configure()
    base = light.to_world_raw
    w = jnp.asarray(
        np.random.default_rng(7).uniform(0.25, 1.0, (64 * 64, 3)), jnp.float32
    )

    def grad_of(mode):
        # SPLAT_TRANSPOSE is read at trace time; a fresh integrator gets a
        # fresh jit cache, so toggling the module variable retraces.
        old = image_ops.SPLAT_TRANSPOSE
        image_ops.SPLAT_TRANSPOSE = mode
        try:
            integ = psdr.PathTracer(0)

            def loss(tx):
                light.to_world_raw = base.at[0, 3].add(tx)
                return jnp.sum(integ.renderD(sc, 0, seed=0) * w)

            if mode == "jvp":
                image_ops.SPLAT_TRANSPOSE = "rows"
                _, d = jax.jvp(
                    loss, (jnp.float32(0.0),), (jnp.float32(1.0),)
                )
                return float(d)
            return float(jax.grad(loss)(jnp.float32(0.0)))
        finally:
            image_ops.SPLAT_TRANSPOSE = old
            light.to_world_raw = base

    g_fwd = grad_of("jvp")           # forward mode: always exact f32
    g_rows = grad_of("rows")         # reverse, f32 adjoint table
    g_bf16 = grad_of("rows_bf16")    # reverse, bf16 adjoint table (default)

    assert abs(g_fwd) > 0.1  # the edge term actually carries signal here
    # f32 reverse == forward (same linear program, transposed exactly)
    np.testing.assert_allclose(g_rows, g_fwd, rtol=1e-5)
    # bf16 table rounding: documented ~0.4%, pinned below 1% relative
    assert abs(g_bf16 - g_rows) / abs(g_rows) < 1e-2, (g_bf16, g_rows)


# ---------------------------------------------------------------------------
# Secondary edges
# ---------------------------------------------------------------------------

def _shadow_scene(w=32, sppse=32, light_half=0.05, rho=0.8, L=200.0):
    """Receiver plane z=0, small light at (0,0,4) facing down, occluder quad
    z=2 spanning x in [-1,1]; camera views x in [1.5,3.5], y in [-1,1] from
    z=10 straight down (outside the occluder's footprint)."""
    sc = psdr.Scene()
    sc.opts.width = w
    sc.opts.height = w
    sc.opts.spp = 4
    sc.opts.sppe = 0
    sc.opts.sppse = sppse
    sc.add_Sensor(_ortho_cam((2.5, 0.0), 10.0))
    sc.add_BSDF(psdr.DiffuseBSDF([rho, rho, rho]), "rho")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")

    receiver = _quad_mesh(
        [-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0], edges=False
    )
    sc.add_Mesh(receiver, None, "rho")

    hl = light_half
    lightm = _quad_mesh(
        [-hl, -hl, 4], [hl, -hl, 4], [hl, hl, 4], [-hl, hl, 4],
        flip=True, edges=False,
    )
    sc.add_Mesh(lightm, None, "black", psdr.AreaLight([L, L, L]))

    occluder = _quad_mesh(
        [-1, -3, 2], [1, -3, 2], [1, 3, 2], [-1, 3, 2], edges=True
    )
    sc.add_Mesh(occluder, None, "black")
    return sc, occluder


def _shadow_analytic(rho, L, light_half):
    """-(2/A_view) * int_{-1}^{1} (rho/pi) E(2, y) dy with point-light
    irradiance E(x, y) = L * A_l * 16 / (x^2 + y^2 + 16)^2."""
    a_l = (2 * light_half) ** 2
    y = np.linspace(-1, 1, 20001)
    e = L * a_l * 16.0 / (4.0 + y ** 2 + 16.0) ** 2
    integral = np.trapezoid(rho / np.pi * e, y)
    return -2.0 / 4.0 * integral


def test_shadow_scene_primal():
    """Shadow boundary at x=2: left strip of the view is dark."""
    sc, _ = _shadow_scene(w=32, sppse=0)
    sc.opts.sppse = 0
    sc.configure()
    img = np.asarray(
        psdr.PathTracer(1).renderC(sc, 0, seed=0)
    ).reshape(32, 32, 3)
    # look_at flips the camera x-axis: column 0 -> world x=1.5 (shadowed),
    # column 31 -> world x=3.5 (lit)
    lit = img[:, 26:, 0].mean()     # world x ~ 3.1-3.5 (unshadowed)
    dark = img[:, :6, 0].mean()     # world x ~ 1.5-1.9 (shadowed)
    assert lit > 5.0 * max(dark, 1e-6)


def test_secondary_edge_gradient_analytic():
    rho, L, hl = 0.8, 200.0, 0.05
    sc, occluder = _shadow_scene(w=32, sppse=64, light_half=hl, rho=rho, L=L)
    sc.configure()
    integ = psdr.PathTracer(1)
    base = occluder.to_world_raw

    def mean_img(tx, seed):
        occluder.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=seed))

    @jax.jit  # one program for every seed (eager, each op compiles alone)
    def dmean(seed):
        return jax.jvp(lambda t: mean_img(t, seed), (jnp.float32(0.0),),
                       (jnp.float32(1.0),))[1]

    grads = [float(dmean(jnp.uint32(seed))) for seed in range(6)]
    occluder.to_world_raw = base
    g = np.mean(grads)
    expect = _shadow_analytic(rho, L, hl)
    assert expect < 0
    np.testing.assert_allclose(g, expect, rtol=0.15)


def test_secondary_edge_interior_alone_misses_gradient():
    sc, occluder = _shadow_scene(w=32, sppse=8)
    sc.opts.sppse = 0
    sc.configure()
    integ = psdr.PathTracer(1)
    base = occluder.to_world_raw

    def mean_img(tx):
        occluder.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
    occluder.to_world_raw = base
    expect = abs(_shadow_analytic(0.8, 200.0, 0.05))
    assert abs(float(d)) < 0.2 * expect


def test_secondary_edge_guiding_reduces_variance():
    """preprocess_secondary_edges guiding: same expectation, lower variance."""
    rho, L, hl = 0.8, 200.0, 0.05
    expect = _shadow_analytic(rho, L, hl)

    def run(guided):
        sc, occluder = _shadow_scene(w=16, sppse=16, light_half=hl, rho=rho, L=L)
        sc.configure()
        integ = psdr.PathTracer(1)
        if guided:
            integ.preprocess_secondary_edges(sc, 0, [8, 8, 8, 16], 1)
        base = occluder.to_world_raw
        vals = []
        for seed in range(8):
            def mean_img(tx):
                occluder.to_world_raw = base.at[0, 3].add(tx)
                return jnp.mean(integ.renderD(sc, 0, seed=seed))
            _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
            vals.append(float(d))
        occluder.to_world_raw = base
        return np.asarray(vals)

    unguided = run(False)
    guided = run(True)
    # both unbiased
    assert abs(guided.mean() - expect) < 0.4 * abs(expect)
    # guiding must REDUCE the estimator's variance (the whole point of the
    # reference's secondary_edge_guiding tutorial; path.cpp:130-168)
    assert guided.std() < unguided.std(), (
        f"guided std {guided.std():.4g} >= unguided {unguided.std():.4g}"
    )


def test_secondary_edge_guiding_refresh_takes_effect():
    """A preprocess_secondary_edges call AFTER a first differentiable
    render must change subsequent renders (regression: the guiding table
    was read at trace time and the cached jit replayed the unguided
    first-render trace forever, silently ignoring all re-guiding —
    found+fixed 2026-08-20, base.py _get_jit warp argument)."""
    rho, L, hl = 0.8, 200.0, 0.05
    sc, occluder = _shadow_scene(w=16, sppse=16, light_half=hl, rho=rho, L=L)
    sc.configure()
    integ = psdr.PathTracer(1)
    base = occluder.to_world_raw

    def grad(seed=5):
        def mean_img(tx):
            occluder.to_world_raw = base.at[0, 3].add(tx)
            return jnp.mean(integ.renderD(sc, 0, seed=seed))
        _, d = jax.jvp(mean_img, (jnp.float32(0.0),), (jnp.float32(1.0),))
        occluder.to_world_raw = base
        return float(d)

    unguided = grad()
    integ.preprocess_secondary_edges(sc, 0, [8, 8, 8, 16], 1)
    refreshed = grad()

    # oracle: a FRESH integrator preprocessed before its first render
    sc2, occ2 = _shadow_scene(w=16, sppse=16, light_half=hl, rho=rho, L=L)
    sc2.configure()
    integ2 = psdr.PathTracer(1)
    integ2.preprocess_secondary_edges(sc2, 0, [8, 8, 8, 16], 1)
    base2 = occ2.to_world_raw

    def mean_img2(tx):
        occ2.to_world_raw = base2.at[0, 3].add(tx)
        return jnp.mean(integ2.renderD(sc2, 0, seed=5))
    _, fresh = jax.jvp(mean_img2, (jnp.float32(0.0),), (jnp.float32(1.0),))
    fresh = float(fresh)

    assert refreshed != unguided, "post-render preprocess was ignored"
    np.testing.assert_allclose(refreshed, fresh, rtol=1e-6)
