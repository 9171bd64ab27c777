"""Forward-render integration tests on the Cornell box."""

import numpy as np
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from scenes import make_cbox


@pytest.fixture(scope="module")
def cbox():
    sc = make_cbox(width=32, height=32, spp=4)
    sc.configure()
    return sc


def test_render_basic(cbox):
    integ = psdr.PathTracer(max_depth=2)
    img = np.asarray(integ.renderC(cbox, 0)).reshape(32, 32, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # light pixels carry the raw radiance (light radiance = (20, 20, 8))
    assert img[..., 0].max() > 15.0
    # the scene is lit: most pixels non-black
    assert (img.sum(-1) > 1e-3).mean() > 0.9


def test_wall_colors(cbox):
    """Red wall (world +x) lands on screen-left, green (x=0) on screen-right
    (perspective sample-space x flip, transform.h/scale(-0.5...))."""
    integ = psdr.PathTracer(max_depth=2)
    img = np.asarray(integ.renderC(cbox, 0)).reshape(32, 32, 3)
    left = img[8:24, :6]
    right = img[8:24, 26:]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()    # red
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()  # green


def test_depth_adds_light(cbox):
    """More bounces add energy (GI) but not unboundedly."""
    i0 = np.asarray(psdr.PathTracer(max_depth=0).renderC(cbox, 0))
    i1 = np.asarray(psdr.PathTracer(max_depth=1).renderC(cbox, 0))
    i2 = np.asarray(psdr.PathTracer(max_depth=2).renderC(cbox, 0))
    assert i1.mean() > i0.mean()
    assert i2.mean() > i1.mean()
    assert i2.mean() < 3.0 * i1.mean()


def test_determinism(cbox):
    integ = psdr.PathTracer(max_depth=1)
    a = np.asarray(integ.renderC(cbox, 0, seed=5))
    b = np.asarray(integ.renderC(cbox, 0, seed=5))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(integ.renderC(cbox, 0, seed=6))
    assert not np.allclose(a, c)


def test_batch_pix_consistency(cbox):
    """Crop rendering reproduces the full frame exactly
    (the reference batch_pix contract, integrator.cpp:23-30)."""
    integ = psdr.PathTracer(max_depth=1)
    full = np.asarray(integ.renderC(cbox, 0, seed=1))
    pix = jnp.asarray([0, 5, 77, 511, 1023], jnp.int32)
    crop = np.asarray(integ.renderC(cbox, 0, seed=1, pix_id=pix))
    np.testing.assert_allclose(crop, full[np.asarray(pix)], rtol=1e-6, atol=1e-7)


def test_direct_integrator(cbox):
    for mis in (0, 1, 2):
        img = np.asarray(psdr.Direct(mis).renderC(cbox, 0)).reshape(32, 32, 3)
        assert np.isfinite(img).all() and img.max() > 1.0


def test_direct_mis_consistency(cbox):
    """NEE-only, BSDF-only, and MIS must estimate the same integral."""
    means = []
    for mis in (0, 1, 2):
        acc = 0.0
        for seed in range(6):
            acc += np.asarray(psdr.Direct(mis).renderC(cbox, 0, seed)).mean()
        means.append(acc / 6)
    assert abs(means[0] - means[2]) < 0.12 * means[2]
    assert abs(means[1] - means[2]) < 0.25 * means[2]


def test_field_integrators(cbox):
    depth = np.asarray(
        psdr.FieldExtractionIntegrator("depth").renderC(cbox, 0)
    ).reshape(32, 32, 3)
    assert depth.max() > 500.0  # cbox scale
    sil = np.asarray(
        psdr.FieldExtractionIntegrator("silhouette").renderC(cbox, 0)
    )
    assert 0.9 < sil.max() <= 1.0 + 1e-6
    normal = np.asarray(
        psdr.FieldExtractionIntegrator("geoNormal").renderC(cbox, 0)
    )
    assert np.isfinite(normal).all()
    uv = np.asarray(psdr.FieldExtractionIntegrator("uv").renderC(cbox, 0))
    assert np.isfinite(uv).all()
    seg = np.asarray(
        psdr.FieldExtractionIntegrator("segmentation").renderC(cbox, 0)
    )
    assert seg.max() >= 6.0  # 8 meshes in the scene


def test_collocated(cbox):
    img = np.asarray(
        psdr.CollocatedIntegrator(1e5).renderC(cbox, 0)
    ).reshape(32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01


def test_renderD_primal_matches_renderC(cbox):
    """renderD's primal equals renderC with the same seed: the boundary terms
    are derivative-only (value - stop_gradient(value)).

    The interior term switches formulation (solid-angle vs path-space,
    scene.cpp:736-806) whose primals agree only up to f32 rounding; a rounding
    flip of a shadow-ray validity test can move a whole sample, so isolated
    pixels may differ — require near-exact agreement on 99% of pixels and a
    tight mean."""
    sc = make_cbox(width=16, height=16, spp=4, sppe=4, sppse=4)
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    c = np.asarray(integ.renderC(sc, 0, seed=2))
    d = np.asarray(integ.renderD(sc, 0, seed=2))
    rel = np.abs(d - c) / (np.abs(c) + 1e-4)
    assert (rel < 1e-3).mean() > 0.9
    np.testing.assert_allclose(d.mean(), c.mean(), rtol=1e-2)
