"""Single-bounce direct-illumination integrator
(reference: src/integrator/direct.cpp).

``mis``: 0 = NEE only, 1 = BSDF sampling only, 2 = MIS (direct.cpp:20-22).
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Integrator
from .edge import SecondaryEdgeMixin
from .path import nee_contribution, bsdf_bounce


class Direct(SecondaryEdgeMixin, Integrator):
    def __init__(self, mis: int = 2, hide_emitters: bool = False):
        assert 0 <= mis <= 2
        Integrator.__init__(self)
        SecondaryEdgeMixin.__init__(self)
        self.mis = mis
        self.hide_emitters = hide_emitters

    def Li(self, sd, sampler, ray, active, diff: bool):
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path", diff=diff)
        active = active & its.valid

        throughput = jnp.ones(its.t.shape + (3,), jnp.float32)
        if self.hide_emitters:
            result = jnp.zeros_like(throughput)
        else:
            result = sd.Le(its, active)

        if self.mis != 1:
            if self.mis == 0:
                # weight1 forced to 1 (direct.cpp:80-82)
                contrib = _nee_no_mis(sd, its, sampler, active, diff, throughput)
            else:
                contrib = nee_contribution(sd, its, sampler, active, diff, throughput)
            result = result + contrib

        if self.mis != 0:
            its1, active, bsdf_val, weight2, _eta = bsdf_bounce(
                sd, its, sampler, active, diff
            )
            if self.mis == 1:
                weight2 = jnp.ones_like(weight2)
            throughput = throughput * bsdf_val
            contrib = sd.Le(its1, active) * throughput * weight2[..., None]
            result = result + jnp.where(active[..., None], contrib, 0.0)
        return result


def _nee_no_mis(sd, its, sampler, active, diff, throughput):
    """NEE with MIS weight forced to 1 (direct.cpp:80-82)."""
    import jax
    from ..core.types import Ray, SHADOW_EPSILON
    from ..core.math import squared_norm, safe_sqrt, safe_div, dot

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
    its1 = sd.ray_intersect(Ray(its.p, wod), active_direct, mode="path", diff=diff)
    active_direct = (
        active_direct
        & its1.valid
        & (its1.t > dist - SHADOW_EPSILON)
        & sd.is_emitter(its1, active_direct)
    )
    g_val = safe_div(jnp.abs(dot(its1.n, -wod)), dist_sqr)
    emitter_val = sd.Le(its1, active)
    wo_local = its.sh_frame.to_local(wod)
    bsdf_val2 = sd.eval_bsdf(its, wo_local, active_direct)
    bsdf_val2 = bsdf_val2 * (g_val * ps.J * safe_div(1.0, ps.pdf))[..., None]
    contrib = throughput * emitter_val * bsdf_val2
    return jnp.where(active_direct[..., None], contrib, 0.0)
