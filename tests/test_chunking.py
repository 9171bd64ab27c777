"""In-jit chunked rendering must reproduce the unchunked estimator exactly
(the per-lane sample streams make any lane partition exact)."""

import numpy as np
import jax
import jax.numpy as jnp

import psdr_jax as psdr
import psdr_jax.integrator.base as base
from scenes import make_cbox


def _render(chunk_lanes, kind="C", seed=1):
    old = base.CHUNK_LANES, base.EDGE_CHUNK_LANES
    base.CHUNK_LANES = base.EDGE_CHUNK_LANES = chunk_lanes
    try:
        sc = make_cbox(width=16, height=16, spp=8, sppe=8, sppse=8)
        sc.configure()
        integ = psdr.PathTracer(1)  # fresh jit cache per call
        if kind == "C":
            return np.asarray(integ.renderC(sc, 0, seed=seed))
        mesh = sc.meshes[-1]
        base_raw = mesh.to_world_raw

        def f(tx):
            mesh.to_world_raw = base_raw.at[0, 3].add(tx)
            return integ.renderD(sc, 0, seed=seed)

        img, dimg = jax.jvp(f, (jnp.float32(0.0),), (jnp.float32(1.0),))
        return np.asarray(img), np.asarray(dimg)
    finally:
        base.CHUNK_LANES, base.EDGE_CHUNK_LANES = old


def test_chunked_forward_matches_unchunked():
    full = _render(1 << 20)
    chunked = _render(512)
    np.testing.assert_allclose(chunked, full, rtol=1e-6, atol=1e-7)


def test_chunked_gradient_matches_unchunked():
    img_f, d_f = _render(1 << 20, kind="D")
    img_c, d_c = _render(512, kind="D")
    np.testing.assert_allclose(img_c, img_f, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_c, d_f, rtol=1e-4, atol=1e-6)
    assert np.abs(d_f).max() > 0


def test_bvh_scene_routes_interior_chunks_and_stays_exact():
    """Large scenes route interior chunks to CHUNK_LANES_LARGE
    (integrator/base.interior_chunk_lanes) — the routed partition must
    reproduce a many-chunk render bitwise (the global per-lane RNG makes
    ANY lane partition exact)."""
    import pytest
    from scenes import make_bunny_envmap

    try:
        sc = make_bunny_envmap(width=8, height=8, spp=4)
    except FileNotFoundError as e:
        pytest.skip(str(e))
    sc.configure()
    assert base.interior_chunk_lanes(sc.data) == base.CHUNK_LANES_LARGE
    integ = psdr.PathTracer(1)
    routed = np.asarray(integ.renderC(sc, 0, seed=3))

    old = base.CHUNK_LANES_LARGE
    base.CHUNK_LANES_LARGE = 64   # force many tiny interior chunks
    try:
        sc2 = make_bunny_envmap(width=8, height=8, spp=4)
        sc2.configure()
        integ2 = psdr.PathTracer(1)
        pinned = np.asarray(integ2.renderC(sc2, 0, seed=3))
    finally:
        base.CHUNK_LANES_LARGE = old
    np.testing.assert_allclose(pinned, routed, rtol=1e-6, atol=1e-7)
