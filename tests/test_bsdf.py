"""BSDF sample/eval/pdf consistency tests.

For every BSDF: (a) the pdf reported by ``sample`` matches ``pdf`` evaluated
at the sampled direction, (b) a binned histogram of sampled directions
matches the pdf (chi^2-lite), (c) energy conservation for unit albedo.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.core.types import Frame, Intersection
from psdr_jax.core.sampler import Sampler

N = 100_000


def make_its(n, wi=(0.3, -0.2, 0.9)):
    wi = jnp.broadcast_to(normalize(jnp.asarray(wi, jnp.float32)), (n, 3))
    z = jnp.zeros((n,), jnp.float32)
    v3 = jnp.zeros((n, 3), jnp.float32)
    frame = Frame.from_normal(
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    )
    return Intersection(
        valid=jnp.ones((n,), bool), t=z + 1.0, p=v3,
        n=frame.n, sh_frame=frame, wi=wi,
        uv=jnp.full((n, 2), 0.5), J=z + 1.0, dp_du=v3, dp_dv=v3,
        bc=jnp.full((n, 2), 0.3),
        tri_id=jnp.zeros((n,), jnp.int32),
        mesh_id=jnp.zeros((n,), jnp.int32),
        face_indices=jnp.zeros((n, 3), jnp.int32),
    )


def normalize(v):
    return v / jnp.linalg.norm(v)


BSDFS = [
    ("diffuse", psdr.DiffuseBSDF([1.0, 1.0, 1.0])),
    ("microfacet", psdr.MicrofacetBSDF(
        specular=(0.2, 0.2, 0.2), diffuse=(0.0, 0.0, 0.0), roughness=0.5)),
    ("roughconductor", psdr.RoughConductorBSDF(alpha_u=0.3)),
    ("roughdielectric", psdr.RoughDielectricBSDF(alpha_u=0.3)),
]


@pytest.mark.parametrize("name,bsdf", BSDFS, ids=[b[0] for b in BSDFS])
def test_sample_pdf_agree(name, bsdf):
    its = make_its(N)
    active = jnp.ones((N,), bool)
    rnd = Sampler(0, jnp.arange(N, dtype=jnp.uint32)).next_nd(3)
    bs = bsdf.sample(its, rnd, active)
    pdf2 = np.asarray(bsdf.pdf(its, bs.wo, bs.is_valid))
    pdf1 = np.asarray(bs.pdf)
    valid = np.asarray(bs.is_valid) & (pdf1 > 1e-3) & (pdf2 > 0)
    assert valid.mean() > 0.5, f"only {valid.mean():.2%} valid samples"
    err = np.abs(pdf1[valid] - pdf2[valid]) / pdf1[valid]
    assert np.quantile(err, 0.95) < 2e-2, (
        f"{name}: sample pdf != pdf() (p95 rel err {np.quantile(err, 0.95):.3f})"
    )


@pytest.mark.parametrize(
    "name,bsdf", BSDFS[:3], ids=[b[0] for b in BSDFS[:3]]
)
def test_histogram_matches_pdf(name, bsdf):
    """Bin sampled wo on a (cos_theta, phi) grid; bin frequency must match
    the pdf integral over the bin (estimated by uniform-direction MC)."""
    its = make_its(N)
    active = jnp.ones((N,), bool)
    rnd = Sampler(1, jnp.arange(N, dtype=jnp.uint32)).next_nd(3)
    bs = bsdf.sample(its, rnd, active)
    wo = np.asarray(bs.wo)
    valid = np.asarray(bs.is_valid)

    nb_c, nb_p = 6, 8
    ci = np.clip((wo[:, 2] * nb_c).astype(int), 0, nb_c - 1)
    pi = np.clip(
        ((np.arctan2(wo[:, 1], wo[:, 0]) / (2 * np.pi) + 0.5) * nb_p).astype(int),
        0, nb_p - 1,
    )
    hist = np.zeros((nb_c, nb_p))
    np.add.at(hist, (ci[valid], pi[valid]), 1.0 / N)

    # uniform hemisphere quadrature of pdf per bin
    m = 200_000
    u = np.asarray(Sampler(2, jnp.arange(m, dtype=jnp.uint32)).next_2d())
    cz = u[:, 0]
    phi = (u[:, 1] - 0.5) * 2 * np.pi
    sz = np.sqrt(np.maximum(1 - cz ** 2, 0))
    wu = np.stack([sz * np.cos(phi), sz * np.sin(phi), cz], -1).astype(np.float32)
    pdf_u = np.asarray(
        bsdf.pdf(make_its(m), jnp.asarray(wu), jnp.ones((m,), bool))
    )
    ci_u = np.clip((cz * nb_c).astype(int), 0, nb_c - 1)
    pi_u = np.clip(((phi / (2 * np.pi) + 0.5) * nb_p).astype(int), 0, nb_p - 1)
    expect = np.zeros((nb_c, nb_p))
    np.add.at(expect, (ci_u, pi_u), pdf_u * (2 * np.pi / m))

    mask = expect > 5e-3
    assert mask.sum() >= 8
    rel = np.abs(hist[mask] - expect[mask]) / expect[mask]
    assert rel.mean() < 0.05, f"{name}: histogram vs pdf mean rel {rel.mean():.3f}"


def test_diffuse_energy_conservation():
    bsdf = psdr.DiffuseBSDF([1.0, 1.0, 1.0])
    its = make_its(N)
    active = jnp.ones((N,), bool)
    rnd = Sampler(3, jnp.arange(N, dtype=jnp.uint32)).next_nd(3)
    bs = bsdf.sample(its, rnd, active)
    f = np.asarray(bsdf.eval(its, bs.wo, bs.is_valid))
    ratio = f[:, 0] / np.maximum(np.asarray(bs.pdf), 1e-9)
    valid = np.asarray(bs.is_valid)
    albedo = ratio[valid].mean() * valid.mean()
    np.testing.assert_allclose(albedo, 1.0, rtol=2e-3)


def test_conductor_energy_bounded():
    bsdf = psdr.RoughConductorBSDF(alpha_u=0.3)
    its = make_its(N)
    active = jnp.ones((N,), bool)
    rnd = Sampler(4, jnp.arange(N, dtype=jnp.uint32)).next_nd(3)
    bs = bsdf.sample(its, rnd, active)
    f = np.asarray(bsdf.eval(its, bs.wo, bs.is_valid)).max(-1)
    ratio = f / np.maximum(np.asarray(bs.pdf), 1e-9)
    valid = np.asarray(bs.is_valid) & (np.asarray(bs.pdf) > 1e-5)
    assert ratio[valid].mean() * valid.mean() < 1.05


def test_normalmap_flat_matches_nested():
    """A flat normal map (0.5, 0.5, 1) must reproduce the nested BSDF."""
    nested = psdr.MicrofacetBSDF(
        specular=(0.1,) * 3, diffuse=(0.4,) * 3, roughness=0.4
    )
    nm = psdr.NormalMapBSDF((0.5, 0.5, 1.0), nested)
    its = make_its(4096)
    active = jnp.ones((4096,), bool)
    wo = np.asarray(Sampler(5, jnp.arange(4096, dtype=jnp.uint32)).next_nd(3))
    wo = wo * 2 - 1
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = jnp.asarray(wo, jnp.float32)
    a = np.asarray(nm.eval(its, wo, active))
    b = np.asarray(nested.eval(its, wo, active))
    np.testing.assert_allclose(a, b, rtol=5e-2, atol=1e-3)
