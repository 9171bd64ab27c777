"""Collocated point-light integrator: BSDF(wi, wi) * intensity / t^2
(reference: src/integrator/collocated.cpp)."""

from __future__ import annotations

import jax.numpy as jnp

from ..core.math import safe_div
from .base import Integrator


class CollocatedIntegrator(Integrator):
    def __init__(self, intensity):
        super().__init__()
        self.intensity = jnp.asarray(intensity, jnp.float32).reshape(-1)
        if self.intensity.shape[0] == 1:
            self.intensity = jnp.repeat(self.intensity, 3)

    # reference attribute name (psdr.cpp binds 'm_intensity')
    @property
    def m_intensity(self):
        return self.intensity

    @m_intensity.setter
    def m_intensity(self, v):
        self.intensity = jnp.asarray(v, jnp.float32).reshape(-1)
        if self.intensity.shape[0] == 1:
            self.intensity = jnp.repeat(self.intensity, 3)

    def Li(self, sd, sampler, ray, active, diff: bool):
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path", diff=diff)
        active = active & its.valid
        value = sd.eval_bsdf(its, its.wi, active)
        value = value * safe_div(1.0, jnp.square(its.t))[..., None]
        value = value * self.intensity
        return jnp.where(active[..., None], value, 0.0)
