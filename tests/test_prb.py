"""Path-replay backprop (integrator/prb.py) must reproduce the default
remat reverse-mode gradients for every differentiable parameter class —
including vertex positions, whose gradients flow through the cross-bounce
position/frame chains that classic PRB drops."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
import psdr_jax.integrator.base as base_mod
from scenes import make_cbox


def _grads(mode, param_kind, depth=2):
    old = base_mod.REMAT_MODE
    base_mod.REMAT_MODE = mode
    try:
        sc = make_cbox(width=16, height=16, spp=4)
        sc.configure()
        integ = psdr.PathTracer(depth)
        mesh = sc.meshes[-1]
        em = sc.emitters[0]
        cam = sc.sensors[0]
        base_v = mesh.vertex_positions_raw
        base_r = em.radiance
        base_c = cam.to_world

        if param_kind == "vertices":
            def loss(d):
                mesh.vertex_positions_raw = base_v + d
                return jnp.sum(jnp.square(integ.renderD(sc, 0, seed=7)))
            g = jax.jit(jax.grad(loss))(jnp.zeros_like(base_v))
            mesh.vertex_positions_raw = base_v
        elif param_kind == "radiance":
            def loss(d):
                em.radiance = base_r + d
                return jnp.sum(jnp.square(integ.renderD(sc, 0, seed=7)))
            g = jax.jit(jax.grad(loss))(jnp.zeros_like(base_r))
            em.radiance = base_r
        elif param_kind == "albedo":
            b = sc.bsdfs[0]
            base_a = b.reflectance.data
            def loss(d):
                b.reflectance.data = base_a + d
                return jnp.sum(jnp.square(integ.renderD(sc, 0, seed=7)))
            g = jax.jit(jax.grad(loss))(jnp.zeros_like(base_a))
            b.reflectance.data = base_a
        else:  # camera pose
            def loss(d):
                cam.to_world = base_c.at[0, 3].add(d)
                return jnp.sum(jnp.square(integ.renderD(sc, 0, seed=7)))
            g = jax.jit(jax.grad(loss))(jnp.float32(0.0))
            cam.to_world = base_c
        return np.asarray(g)
    finally:
        base_mod.REMAT_MODE = old


@pytest.mark.parametrize("param_kind",
                         ["vertices", "radiance", "albedo", "camera"])
def test_prb_matches_remat(param_kind):
    g_remat = _grads("chunk", param_kind)
    g_prb = _grads("prb", param_kind)
    assert np.isfinite(g_prb).all()
    assert (np.abs(g_remat) > 0).any()
    np.testing.assert_allclose(g_prb, g_remat, rtol=2e-4, atol=1e-6)


def test_prb_primal_matches():
    """The custom_vjp primal equals the plain forward."""
    old = base_mod.REMAT_MODE
    try:
        sc = make_cbox(width=16, height=16, spp=4)
        sc.configure()
        integ = psdr.PathTracer(2)
        base_mod.REMAT_MODE = "chunk"
        a = np.asarray(integ.renderD(sc, 0, seed=3))
        integ2 = psdr.PathTracer(2)
        base_mod.REMAT_MODE = "prb"
        b = np.asarray(integ2.renderD(sc, 0, seed=3))
        np.testing.assert_array_equal(a, b)
    finally:
        base_mod.REMAT_MODE = old


def test_prb_depth0():
    old = base_mod.REMAT_MODE
    try:
        base_mod.REMAT_MODE = "prb"
        sc = make_cbox(width=8, height=8, spp=2)
        sc.configure()
        integ = psdr.PathTracer(0)
        em = sc.emitters[0]
        base_r = em.radiance

        def loss(d):
            em.radiance = base_r + d
            return jnp.sum(integ.renderD(sc, 0, seed=1))

        g = np.asarray(jax.jit(jax.grad(loss))(jnp.zeros_like(base_r)))
        em.radiance = base_r
        assert np.isfinite(g).all() and (g > 0).any()
    finally:
        base_mod.REMAT_MODE = old


def test_non_prb_integrator_keeps_chunk_checkpoint_under_prb_mode():
    """PSDR_REMAT=prb with an integrator that lacks path-replay support
    (Direct) must fall back to chunk checkpointing — same gradients as
    chunk mode, and the reverse pass must not stack per-chunk residuals
    (regression for the silent REMAT_MODE=none fallback)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import psdr_jax as psdr
    import psdr_jax.integrator.base as base_mod
    from scenes import make_cbox

    sc = make_cbox(width=16, height=16, spp=2)
    sc.configure()
    em = sc.emitters[0]
    base_r = em.radiance

    def make_loss():
        # fresh integrator per mode: the jit/trace caches key on the
        # function identity, so a reused instance would replay the jaxpr
        # traced under the previous REMAT_MODE
        integ = psdr.Direct(2)

        def loss_fn(dr):
            em.radiance = base_r + dr
            img = integ.renderD(sc, 0, seed=4)
            return jnp.sum(jnp.square(img))
        return loss_fn

    old_mode = base_mod.REMAT_MODE
    old_chunks = base_mod.CHUNK_LANES
    try:
        base_mod.CHUNK_LANES = 128  # force several chunks at 16x16 spp=2
        base_mod.REMAT_MODE = "chunk"
        g_chunk = jax.grad(make_loss())(jnp.zeros_like(base_r))
        base_mod.REMAT_MODE = "prb"
        # spy: the chunk body must still be wrapped in jax.checkpoint
        calls = []
        real_remat = base_mod._remat

        def spy(fn):
            calls.append(fn)
            return real_remat(fn)

        base_mod._remat = spy
        try:
            g_prb = jax.grad(make_loss())(jnp.zeros_like(base_r))
        finally:
            base_mod._remat = real_remat
        assert calls, "chunk checkpoint missing under PSDR_REMAT=prb fallback"
    finally:
        base_mod.REMAT_MODE = old_mode
        base_mod.CHUNK_LANES = old_chunks
        em.radiance = base_r
    np.testing.assert_allclose(np.asarray(g_chunk), np.asarray(g_prb),
                               rtol=1e-6)
