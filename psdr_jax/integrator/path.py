"""Unidirectional path tracer with NEE + MIS and both boundary terms
(reference: src/integrator/path.cpp)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Ray, EPSILON, SHADOW_EPSILON
from ..core.math import (
    normalize, norm, squared_norm, dot, safe_div, safe_sqrt, mis_weight,
)
from .base import Integrator
from .edge import SecondaryEdgeMixin


def nee_contribution(sd, its, sampler, active, diff: bool, throughput,
                     tape=None):
    """Next-event estimation block (path.cpp:47-83).  Returns contribution."""
    u2 = sampler.next_2d()
    # exact alias coin for big envmap importance tables (trace-static
    # draw-count change per scene class; see DiscreteDistribution.needs_coin)
    coin = sampler.next_1d() if sd.emitter_coin_needed else None
    ps = sd.sample_emitter_position(its.p, u2, active, u_coin=coin)
    active_direct = active & ps.is_valid & ~sd.is_emitter(its, active)
    wod = ps.p - its.p
    dist_sqr = squared_norm(wod)
    dist = safe_sqrt(dist_sqr)
    wod = wod * safe_div(1.0, dist)[..., None]
    its1 = sd.ray_intersect(Ray(its.p, wod), active_direct, mode="path",
                            diff=diff, tape=tape)
    active_direct = (
        active_direct
        & its1.valid
        & (its1.t > dist - SHADOW_EPSILON)
        & sd.is_emitter(its1, active_direct)
    )
    cos_val = dot(its1.n, -wod)
    g_val = safe_div(jnp.abs(cos_val), dist_sqr)
    emitter_val = sd.Le(its1, active)

    wo_local = its.sh_frame.to_local(wod)
    bsdf_val2 = sd.eval_bsdf(its, wo_local, active_direct)
    bsdf_val2 = bsdf_val2 * (g_val * ps.J * safe_div(1.0, ps.pdf))[..., None]
    pdf1 = sd.pdf_bsdf(its, wo_local, active_direct)
    if diff:
        pdf1 = pdf1 * jax.lax.stop_gradient(g_val)
    else:
        pdf1 = pdf1 * g_val
    active_direct = active_direct & (pdf1 != 0.0)
    weight1 = mis_weight(ps.pdf, pdf1)
    contrib = throughput * emitter_val * bsdf_val2 * weight1[..., None]
    return jnp.where(active_direct[..., None], contrib, 0.0)


def bsdf_bounce(sd, its, sampler, active, diff: bool, tape=None):
    """BSDF-sampling bounce (path.cpp:85-123).

    Returns (its1, active, bsdf_throughput_factor, weight2, eta).
    """
    bs = sd.sample_bsdf(its, sampler.next_nd(3), active)
    ray = Ray(its.p, its.sh_frame.to_world(bs.wo))
    its1 = sd.ray_intersect(ray, active, mode="path", diff=diff, tape=tape)
    active = active & bs.is_valid & its1.valid
    t_det = jax.lax.stop_gradient(its1.t)
    if diff:
        wo = (its1.p - its.p) * safe_div(1.0, its1.t)[..., None]
        cos_val = dot(its1.n, -wo)
        g_val = safe_div(jnp.abs(cos_val), jnp.square(its1.t))
        j = jnp.where(its1.valid, its1.J, 1.0)
        g_val = jnp.where(its1.valid, g_val, 1.0)
        pdf0 = bs.pdf * jax.lax.stop_gradient(g_val)
        ev = sd.eval_bsdf(its, its.sh_frame.to_local(wo), active)
        bsdf_val = ev * (g_val * j * safe_div(1.0, pdf0))[..., None]
        bsdf_val = jnp.where((t_det < EPSILON)[..., None], 0.0, bsdf_val)
    else:
        cos_val = dot(its1.n, -ray.d)
        g_val = safe_div(jnp.abs(cos_val), jnp.square(its1.t))
        pdf0 = bs.pdf * g_val
        ev = sd.eval_bsdf(its, bs.wo, active)
        bsdf_val = ev * safe_div(1.0, bs.pdf)[..., None]
        bsdf_val = jnp.where((t_det < EPSILON)[..., None], 0.0, bsdf_val)
    weight2 = mis_weight(pdf0, sd.emitter_position_pdf(its.p, its1, active))
    return its1, active, bsdf_val, weight2, bs.eta


class PathTracer(SecondaryEdgeMixin, Integrator):
    """PathTracer(max_depth) — unrolled depth loop like the reference
    (path.cpp:45, LoopRecord disabled at psdr.cpp:105)."""

    supports_prb = True  # path-replay reverse mode (integrator/prb.py)
    supports_bounce_remat = True  # Li self-remats per bounce under "bounce"

    def __init__(self, max_depth: int = 1, hide_emitters: bool = False):
        assert max_depth >= 0
        Integrator.__init__(self)
        SecondaryEdgeMixin.__init__(self)
        self.max_depth = max_depth
        self.hide_emitters = hide_emitters

    def Li(self, sd, sampler, ray, active, diff: bool, tape=None):
        from .base import REMAT_MODE

        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path",
                               diff=diff, tape=tape)
        active = active & its.valid

        throughput = jnp.ones(its.t.shape + (3,), jnp.float32)
        if self.hide_emitters:
            result = jnp.zeros_like(throughput)
        else:
            result = sd.Le(its, active)

        def bounce(sd, its, active, throughput):
            r = nee_contribution(sd, its, sampler, active, diff, throughput,
                                 tape=tape)
            its1, active1, bsdf_val, weight2, _eta = bsdf_bounce(
                sd, its, sampler, active, diff, tape=tape
            )
            thr = throughput * bsdf_val
            contrib = sd.Le(its1, active1) * thr * weight2[..., None]
            r = r + jnp.where(active1[..., None], contrib, 0.0)
            return r, its1, active1, thr

        if diff and REMAT_MODE == "bounce":
            from .base import _remat
            bounce = _remat(bounce)

        for _depth in range(self.max_depth):
            r, its, active, throughput = bounce(sd, its, active, throughput)
            result = result + r
        return result
