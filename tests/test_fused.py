"""Fused forward+adjoint step (integrator/fused.py) vs jax.grad of renderD.

The fused step must reproduce the exact sample set and estimator values of
the remat-based reverse path — same loss, same parameter gradients — while
running one forward + one adjoint (no recompute).
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp

import psdr_jax as psdr
from scenes import make_cbox


def _setup(**kw):
    sc = make_cbox(width=32, height=32, **kw)
    sc.configure()
    integ = psdr.PathTracer(2)
    mesh = sc.meshes[-1]
    em = sc.emitters[0]
    return sc, integ, mesh, em


def _ref_loss_grad(sc, integ, mesh, em, target, seed):
    bv, br = mesh.vertex_positions_raw, em.radiance

    def loss(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr
        img = integ.renderD(sc, 0, seed=seed)
        return jnp.sum(jnp.square(img - target))

    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
    return jax.value_and_grad(loss)(p0), p0, bv, br


def _fused_loss_grad(sc, integ, mesh, em, target, seed, p0, bv, br):
    def apply(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    return integ.loss_and_grad(sc, p0, apply, ploss, seed=seed)


def test_fused_matches_jax_grad_interior():
    sc, integ, mesh, em = _setup(spp=4)
    target = jnp.zeros((32 * 32, 3), jnp.float32)
    (l_ref, g_ref), p0, bv, br = _ref_loss_grad(sc, integ, mesh, em, target, 7)
    l_f, g_f, img = _fused_loss_grad(sc, integ, mesh, em, target, 7, p0, bv, br)
    assert abs(float(l_ref) - float(l_f)) <= 1e-3 * max(1.0, abs(float(l_ref)))
    for r, f in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_f)):
        r, f = np.asarray(r), np.asarray(f)
        np.testing.assert_allclose(f, r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))
    # the returned image is renderD's primal (edge terms are derivative-only;
    # renderC differs at ULP level via the solid- vs path-space formulation)
    mesh.vertex_positions_raw = bv
    em.radiance = br
    img_d = np.asarray(integ.renderD(sc, 0, seed=7))
    np.testing.assert_allclose(np.asarray(img), img_d, rtol=1e-5, atol=1e-6)


def test_fused_matches_jax_grad_full_terms():
    sc, integ, mesh, em = _setup(spp=4, sppe=4, sppse=4)
    target = jnp.full((32 * 32, 3), 0.1, jnp.float32)
    (l_ref, g_ref), p0, bv, br = _ref_loss_grad(sc, integ, mesh, em, target, 3)
    l_f, g_f, _ = _fused_loss_grad(sc, integ, mesh, em, target, 3, p0, bv, br)
    assert abs(float(l_ref) - float(l_f)) <= 1e-3 * max(1.0, abs(float(l_ref)))
    for r, f in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_f)):
        r, f = np.asarray(r), np.asarray(f)
        np.testing.assert_allclose(f, r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


def test_fused_jittable_and_chunked():
    """Multiple chunks (chunk_lanes forced small) under an outer jit."""
    import psdr_jax.integrator.base as base

    old = base.CHUNK_LANES
    base.CHUNK_LANES = 512  # 32x32 spp=4 -> 4096 lanes -> 8 chunks
    try:
        sc, integ, mesh, em = _setup(spp=4)
        target = jnp.zeros((32 * 32, 3), jnp.float32)
        (l_ref, g_ref), p0, bv, br = _ref_loss_grad(
            sc, integ, mesh, em, target, 11
        )

        def apply(p):
            dv, dr = p
            mesh.vertex_positions_raw = bv + dv
            em.radiance = br + dr

        def ploss(rows, pix):
            return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

        fn = jax.jit(
            lambda p: integ.loss_and_grad(sc, p, apply, ploss, seed=11)[:2]
        )
        l_f, g_f = fn(p0)
        assert abs(float(l_ref) - float(l_f)) <= 1e-3 * max(
            1.0, abs(float(l_ref))
        )
        # chunked accumulation order differs between the fused scan and the
        # remat transpose; measured f32 reorder noise of jax.grad against
        # ITSELF across chunk sizes is ~5e-3 of max-abs on this workload —
        # allow 1e-2 of scale
        for r, f in zip(jax.tree_util.tree_leaves(g_ref),
                        jax.tree_util.tree_leaves(g_f)):
            r, f = np.asarray(r), np.asarray(f)
            np.testing.assert_allclose(
                f, r, rtol=0.0, atol=1e-2 * max(1e-3, np.abs(r).max())
            )
    finally:
        base.CHUNK_LANES = old


def test_fused_sharded_matches_single_device():
    """The sharded fused step (shard_map over the 8-device virtual mesh,
    edge-lane windows + all-gathered cotangent image + psum'd parameter
    cotangents) must reproduce the single-device fused step."""
    from psdr_jax.parallel.mesh import make_device_mesh
    from psdr_jax.parallel.shard import make_fused_train_step

    sc, integ, mesh_obj, em = _setup(spp=4, sppe=4, sppse=4)
    target = jnp.full((32 * 32, 3), 0.1, jnp.float32)
    bv, br = mesh_obj.vertex_positions_raw, em.radiance
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))

    l_1, g_1, img_1 = _fused_loss_grad(
        sc, integ, mesh_obj, em, target, 5, p0, bv, br
    )

    def apply(p):
        dv, dr = p
        mesh_obj.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    dmesh = make_device_mesh(8)
    step = make_fused_train_step(sc, integ, dmesh, apply, ploss)
    l_8, g_8, img_8 = step(p0, seed=5)

    assert abs(float(l_1) - float(l_8)) <= 1e-3 * max(1.0, abs(float(l_1)))
    # same estimator values; only f32 accumulation order differs (per-device
    # scan + psum vs one global scan)
    for a, b in zip(jax.tree_util.tree_leaves(g_1),
                    jax.tree_util.tree_leaves(g_8)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(
            b, a, rtol=1e-4, atol=2e-5 * max(1.0, np.abs(a).max())
        )
    np.testing.assert_allclose(
        np.asarray(img_8), np.asarray(img_1), rtol=1e-5, atol=1e-6
    )


def test_fused_sharded_guiding_refresh_takes_effect():
    """make_fused_train_step must pick up a preprocess_secondary_edges
    call made AFTER the step was created (regression, 2026-08-20: the
    guiding table was a trace-time closure constant and re-guiding was
    silently ignored; it now flows in as a jit argument)."""
    from psdr_jax.parallel.mesh import make_device_mesh
    from psdr_jax.parallel.shard import make_fused_train_step

    sc, integ, mesh_obj, em = _setup(spp=2, sppe=0, sppse=8)
    target = jnp.full((32 * 32, 3), 0.1, jnp.float32)
    bv, br = mesh_obj.vertex_positions_raw, em.radiance
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))

    def apply(p):
        dv, dr = p
        mesh_obj.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    dmesh = make_device_mesh(8)
    step = make_fused_train_step(sc, integ, dmesh, apply, ploss)
    l_unguided, g_unguided, _ = step(p0, seed=5)

    integ.preprocess_secondary_edges(sc, 0, [4, 4, 4, 8], 1)
    l_refreshed, g_refreshed, _ = step(p0, seed=5)

    # oracle: a FRESH step created after preprocessing
    step2 = make_fused_train_step(sc, integ, dmesh, apply, ploss)
    l_fresh, g_fresh, _ = step2(p0, seed=5)

    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(g_refreshed),
                        jax.tree_util.tree_leaves(g_unguided))
    )
    assert changed, "post-creation preprocess was ignored by the step"
    np.testing.assert_allclose(float(l_refreshed), float(l_fresh), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g_refreshed),
                    jax.tree_util.tree_leaves(g_fresh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)


def test_fused_user_jit_guiding_guard_and_warp_arg():
    """The stale-guiding footgun: a user-jitted
    closure over loss_and_grad with an implicit guiding table RAISES at
    trace time (the table would bake as a constant; a later
    preprocess_secondary_edges would be silently ignored), while the
    blessed ``warp=`` jit-argument path picks up re-preprocessing and
    matches the eager (always-fresh) call exactly."""
    sc, integ, mesh_obj, em = _setup(spp=2, sppe=0, sppse=8)
    target = jnp.full((32 * 32, 3), 0.1, jnp.float32)
    bv, br = mesh_obj.vertex_positions_raw, em.radiance
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))

    def apply(p):
        dv, dr = p
        mesh_obj.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    # warp-as-argument step: traced ONCE per table structure, values fresh
    step = jax.jit(lambda p, s, w: integ.loss_and_grad(
        sc, p, apply, ploss, seed=s, warp=w)[:2])
    l_u, g_u = step(p0, 5, None)

    integ.preprocess_secondary_edges(sc, 0, [4, 4, 4, 8], 1)
    l_g, g_g = step(p0, 5, integ.warpper.get(0))
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(g_g),
                        jax.tree_util.tree_leaves(g_u))
    )
    assert changed, "guiding table passed via warp= was ignored"

    # oracle: the eager call reads the integrator's table fresh every time
    l_e, g_e, _ = integ.loss_and_grad(sc, p0, apply, ploss, seed=5)
    np.testing.assert_allclose(float(l_g), float(l_e), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g_g),
                    jax.tree_util.tree_leaves(g_e)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-8)

    # the footgun pattern now fails loudly instead of going silently stale
    import pytest
    bad = jax.jit(lambda p, s: integ.loss_and_grad(
        sc, p, apply, ploss, seed=s)[:2])
    with pytest.raises(RuntimeError, match="guiding table"):
        bad(p0, 5)


def test_fused_edge_only_spp0():
    """spp=0 with edge terms on (edge-only gradients, supported by
    renderD) must not crash the fused step: zero interior image, loss
    cotangent still pulled through the edge passes (regression: 1.0/spp
    ZeroDivisionError at trace time, found 2026-08-20)."""
    sc, integ, mesh_obj, em = _setup(spp=0, sppe=4, sppse=4)
    target = jnp.full((32 * 32, 3), 0.1, jnp.float32)
    bv, br = mesh_obj.vertex_positions_raw, em.radiance
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))

    def apply(p):
        dv, dr = p
        mesh_obj.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    loss, grads, image = integ.loss_and_grad(sc, p0, apply, ploss, seed=3)
    assert np.asarray(image).max() == 0.0  # interior primal exactly zero
    assert np.isfinite(float(loss))
    gleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(g).all() for g in gleaves)
    # the boundary estimators must actually contribute gradient signal
    assert max(np.abs(g).max() for g in gleaves) > 0.0
