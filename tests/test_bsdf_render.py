"""Render-level integration tests for every BSDF family.

Each material renders in a small closed scene: results must be finite,
non-black, energy-sane, and differentiable w.r.t. the material parameters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from scenes import make_cbox, _quads_to_mesh, SHORT_BLOCK


def _cbox_with(bsdf, max_depth=2):
    """Cornell box with the short block using the given BSDF."""
    sc = make_cbox(width=24, height=24, spp=8)
    sc.add_BSDF(bsdf, "test_mat")
    sc.meshes[-2].bsdf_id = len(sc.bsdfs) - 1  # short block
    sc.configure()
    img = np.asarray(psdr.PathTracer(max_depth).renderC(sc, 0, seed=0))
    return sc, img.reshape(24, 24, 3)


def test_microfacet_render():
    sc, img = _cbox_with(psdr.MicrofacetBSDF(
        specular=(0.2,) * 3, diffuse=(0.3, 0.25, 0.2), roughness=0.25))
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert img.max() < 50.0


def test_roughconductor_render():
    sc, img = _cbox_with(psdr.RoughConductorBSDF(alpha_u=0.2))
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_roughdielectric_render():
    sc, img = _cbox_with(psdr.RoughDielectricBSDF(alpha_u=0.2, int_ior=1.5),
                         max_depth=4)
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_normalmap_render():
    # bumpy normal map over microfacet
    rng = np.random.default_rng(0)
    nm = rng.uniform(0.35, 0.65, (8, 8, 3)).astype(np.float32)
    nm[..., 2] = 1.0
    nested = psdr.MicrofacetBSDF(specular=(0.1,) * 3, diffuse=(0.4,) * 3,
                                 roughness=0.3)
    sc, img = _cbox_with(psdr.NormalMapBSDF(nm, nested))
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_microfacet_pv_render_and_grad():
    """Per-vertex parameters interpolate at hits and carry gradients."""
    sc = make_cbox(width=16, height=16, spp=8)
    block = sc.meshes[-2]
    nv = block.num_vertices
    pv = psdr.MicrofacetBSDFPerVertex(
        np.full((nv, 3), 0.05, np.float32),
        np.tile(np.linspace(0.1, 0.9, nv)[:, None], (1, 3)).astype(np.float32),
        np.full((nv,), 0.4, np.float32),
    )
    sc.add_BSDF(pv, "pv")
    block.bsdf_id = len(sc.bsdfs) - 1
    sc.configure()
    integ = psdr.PathTracer(1)
    img = np.asarray(integ.renderC(sc, 0, seed=0))
    assert np.isfinite(img).all() and img.mean() > 0.01

    base = pv.diffuseReflectance

    def loss(d):
        pv.diffuseReflectance = base + d
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    g = np.asarray(jax.grad(loss)(jnp.zeros_like(base)))
    pv.diffuseReflectance = base
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any()
    # fixed-seed FD agreement (smooth parameter)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=g.shape), jnp.float32) * 0.01
    fd = (float(loss(v)) - float(loss(-v))) / 2.0
    np.testing.assert_allclose(float((g * np.asarray(v)).sum()), fd, rtol=5e-2)


def test_roughness_gradient():
    """Roughness (1-channel bitmap) gradients flow in renders."""
    sc = make_cbox(width=16, height=16, spp=8)
    mf = psdr.MicrofacetBSDF(specular=(0.3,) * 3, diffuse=(0.2,) * 3,
                             roughness=0.3)
    sc.add_BSDF(mf, "mf")
    sc.meshes[-2].bsdf_id = len(sc.bsdfs) - 1
    sc.configure()
    integ = psdr.PathTracer(1)
    base = mf.roughness.data

    def loss(s):
        mf.roughness.data = base * s
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    g = float(jax.grad(loss)(jnp.float32(1.0)))
    eps = 1e-2
    fd = (float(loss(jnp.float32(1 + eps))) -
          float(loss(jnp.float32(1 - eps)))) / (2 * eps)
    mf.roughness.data = base
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-6)


def test_field_object_filter():
    sc = make_cbox(width=16, height=16, spp=2)
    sc.meshes[-1].id = "tall_block"
    sc.configure()
    sil = np.asarray(
        psdr.FieldExtractionIntegrator("silhouette tall_block").renderC(sc, 0)
    ).reshape(16, 16, 3)
    sil_all = np.asarray(
        psdr.FieldExtractionIntegrator("silhouette").renderC(sc, 0)
    ).reshape(16, 16, 3)
    assert 0 < sil.mean() < 0.5 * sil_all.mean()


def test_microfacet_pv_backward_has_no_scatter():
    """The per-vertex interpolation routes through one-hot matmuls
    (ops/gather.py), so the backward HLO of a per-vertex gradient contains
    no scatter ops."""
    import jax.numpy as jnp
    from psdr_jax.bsdf.microfacet_pv import MicrofacetBSDFPerVertex
    from psdr_jax.core.types import Intersection, Frame

    nv, n = 64, 256
    rng = np.random.default_rng(0)
    spec = jnp.full((nv, 3), 0.05, jnp.float32)
    diff = jnp.asarray(rng.uniform(0.2, 0.8, (nv, 3)), jnp.float32)
    rough = jnp.full((nv,), 0.4, jnp.float32)

    fi = jnp.asarray(rng.integers(0, nv, (n, 3)), jnp.int32)
    bc = jnp.asarray(rng.uniform(0.1, 0.4, (n, 2)), jnp.float32)
    wi = jnp.tile(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 1))
    wo_ = jnp.tile(
        jnp.asarray([0.3, 0.0, 0.9539392], jnp.float32), (n, 1))

    def loss(d):
        b = MicrofacetBSDFPerVertex(spec, d, rough)
        its = Intersection(
            valid=jnp.ones((n,), bool), t=jnp.ones((n,)),
            p=jnp.zeros((n, 3)), n=wi, sh_frame=Frame.from_normal(wi),
            wi=wi, uv=bc, J=jnp.ones((n,)),
            dp_du=jnp.zeros((n, 3)), dp_dv=jnp.zeros((n, 3)),
            bc=bc, tri_id=jnp.zeros((n,), jnp.int32),
            mesh_id=jnp.zeros((n,), jnp.int32), face_indices=fi,
        )
        return jnp.sum(b.eval(its, wo_, jnp.ones((n,), bool)))

    hlo = jax.jit(jax.grad(loss)).lower(diff).as_text()
    assert "scatter" not in hlo, "per-vertex backward fell back to scatter"
    g = np.asarray(jax.grad(loss)(diff))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
