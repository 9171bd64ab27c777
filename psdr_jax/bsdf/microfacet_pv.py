"""Microfacet BRDF with per-vertex parameters, barycentric-interpolated at
hits (reference: src/bsdf/microfacet_pv.cpp)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import INV_PI, mutable_pytree
from ..core.records import BSDFSample
from ..core.math import normalize, mulsign, safe_div
from .bsdf import BSDF
from .ggx import GGXDistribution
from ..ops.gather import gather_rows


def _interpolate(its, values):
    """Barycentric interpolation of per-vertex values at the hit
    (microfacet_pv.cpp:145-163).  ``values``: (V, k); uses mesh-local
    ``face_indices`` and ``bc``.

    Routed through :func:`gather_rows` so the backward pass of a per-vertex
    optimization is a single one-hot matmul into the table per call instead
    of three scatter-adds per bounce.
    """
    rows = gather_rows(values, its.face_indices)  # (..., 3, k)
    v0, v1, v2 = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]
    bc = its.bc
    return v0 + (v1 - v0) * bc[..., 0:1] + (v2 - v0) * bc[..., 1:2]


@mutable_pytree(
    leaves=("specularReflectance", "diffuseReflectance", "roughness"),
    static=("twoSide",),
)
class MicrofacetBSDFPerVertex(BSDF):
    def __init__(self, spec_refl, diff_refl, roughness, twoSide: bool = False):
        self.specularReflectance = jnp.asarray(spec_refl, jnp.float32)  # (V, 3)
        self.diffuseReflectance = jnp.asarray(diff_refl, jnp.float32)   # (V, 3)
        r = jnp.asarray(roughness, jnp.float32)
        self.roughness = r.reshape(-1, 1)                                # (V, 1)
        self.twoSide = twoSide

    def _orient(self, wi, wo):
        if self.twoSide:
            wo = wo.at[..., 2].set(mulsign(wo[..., 2], wi[..., 2]))
            wi = wi.at[..., 2].set(jnp.abs(wi[..., 2]))
        return wi, wo

    def eval(self, its, wo, active):
        wi, wo = self._orient(its.wi, wo)
        # one packed gather for all three per-vertex tables (spec|diff|rough)
        packed = jnp.concatenate(
            [self.specularReflectance, self.diffuseReflectance, self.roughness],
            axis=-1,
        )
        interp = _interpolate(its, packed)
        spec, diff, roughness = interp[..., 0:3], interp[..., 3:6], interp[..., 6]

        cos_nv, cos_nl = wi[..., 2], wo[..., 2]
        active = active & (cos_nv > 0.0) & (cos_nl > 0.0)

        diffuse = diff * INV_PI
        h = normalize(wi + wo)
        cos_nh = h[..., 2]
        cos_vh = jnp.sum(h * wi, axis=-1)
        alpha = jnp.square(roughness)
        k = jnp.square(roughness + 1.0) / 8.0

        # UE4-style analytic GGX + Schlick-GGX geometry (microfacet_pv.cpp:48-60)
        tmp = safe_div(alpha, cos_nh * cos_nh * (jnp.square(alpha) - 1.0) + 1.0)
        ggx = tmp * tmp * INV_PI
        coeff = cos_vh * (-5.55473 * cos_vh - 6.8316)
        fresnel = spec + (1.0 - spec) * jnp.exp2(coeff)[..., None]
        smith_g = safe_div(cos_nv, cos_nv * (1.0 - k) + k) * safe_div(
            cos_nl, cos_nl * (1.0 - k) + k
        )
        numerator = (ggx * smith_g)[..., None] * fresnel
        denominator = 4.0 * cos_nl * cos_nv
        specular = numerator / (denominator + 1e-6)[..., None]
        value = (diffuse + specular) * cos_nl[..., None]
        return jnp.where(active[..., None], value, 0.0)

    def sample(self, its, rnd3, active) -> BSDFSample:
        wi = its.wi
        if self.twoSide:
            wi = wi.at[..., 2].set(jnp.abs(wi[..., 2]))
        roughness = _interpolate(its, self.roughness)[..., 0]
        cos_i = wi[..., 2]
        distr = GGXDistribution(jnp.square(roughness))
        m, m_pdf = distr.sample(wi, rnd3)
        wo = 2.0 * jnp.sum(wi * m, axis=-1, keepdims=True) * m - wi
        pdf = safe_div(m_pdf, 4.0 * jnp.sum(wo * m, axis=-1))
        bs = BSDFSample(
            wo=wo,
            pdf=pdf,
            eta=jnp.ones(pdf.shape, jnp.float32),
            is_valid=active & (cos_i > 0.0) & (pdf != 0.0) & (wo[..., 2] > 0.0),
        )
        return jax.lax.stop_gradient(bs)

    def pdf(self, its, wo, active):
        wi, wo = self._orient(its.wi, wo)
        roughness = _interpolate(its, self.roughness)[..., 0]
        cos_i, cos_o = wi[..., 2], wo[..., 2]
        m = normalize(wo + wi)
        active = (
            active
            & (cos_i > 0.0)
            & (cos_o > 0.0)
            & (jnp.sum(wi * m, axis=-1) > 0.0)
            & (jnp.sum(wo * m, axis=-1) > 0.0)
        )
        distr = GGXDistribution(jnp.square(roughness))
        result = safe_div(distr.eval(m) * distr.smith_g1(wi, m), 4.0 * cos_i)
        return jax.lax.stop_gradient(jnp.where(active, result, 0.0))
