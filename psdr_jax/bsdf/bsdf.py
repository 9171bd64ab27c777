"""BSDF base protocol and per-lane type dispatch.

The reference dispatches BSDFs through Dr.Jit vcalls on per-mesh pointers
(``bsdf/bsdf.h:22-77``).  Here, pointer-based virtual calls become a
*static unrolled loop over BSDF instances* with per-lane masks: the scene
holds a small static tuple of BSDF objects, each lane knows its bsdf slot
(via the hit mesh id), and each instance evaluates masked.  With the handful
of BSDF instances typical of psdr scenes this keeps every lane on the VPU
with zero gather/scatter, and lets XLA fuse all instance evaluations into the
surrounding shading code.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax

from ..core.records import BSDFSample
from ..core.object import Object


class BSDF(Object):
    """Interface; concrete BSDFs are mutable pytrees with these methods.

    ``its`` is any object providing ``wi`` (local frame), ``uv``, ``bc``,
    ``face_indices`` fields (an :class:`~psdr_jax.core.types.Intersection`).

    Conventions (matching the reference):
    * ``eval`` returns f(wi, wo) * cos(theta_o) — differentiable.
    * ``sample`` returns a fully detached :class:`BSDFSample`
      (reference ``diffuse.cpp:69`` returns ``detach(bs)``).
    * ``pdf`` returns a detached solid-angle density.
    """

    twoSide: bool = False

    def eval(self, its, wo, active):
        raise NotImplementedError

    def sample(self, its, rnd3, active) -> BSDFSample:
        raise NotImplementedError

    def pdf(self, its, wo, active):
        raise NotImplementedError

    def anisotropic(self) -> bool:
        return False

    def to_string(self) -> str:
        return type(self).__name__

    __repr__ = to_string


def _zeros_sample(shape):
    return BSDFSample(
        wo=jnp.zeros(shape + (3,), jnp.float32),
        pdf=jnp.zeros(shape, jnp.float32),
        eta=jnp.ones(shape, jnp.float32),
        is_valid=jnp.zeros(shape, bool),
    )


def eval_dispatch(bsdfs, slot, its, wo, active):
    """Masked evaluate-all over the static BSDF tuple.

    ``slot``: (...,) int32 per-lane BSDF index (-1 = none).
    """
    result = jnp.zeros(wo.shape[:-1] + (3,), jnp.float32)
    for i, b in enumerate(bsdfs):
        m = active & (slot == i)
        val = b.eval(its, wo, m)
        result = jnp.where(m[..., None], val, result)
    return result


def sample_dispatch(bsdfs, slot, its, rnd3, active) -> BSDFSample:
    shape = rnd3.shape[:-1]
    out = _zeros_sample(shape)
    for i, b in enumerate(bsdfs):
        m = active & (slot == i)
        bs = b.sample(its, rnd3, m)
        out = BSDFSample(
            wo=jnp.where(m[..., None], bs.wo, out.wo),
            pdf=jnp.where(m, bs.pdf, out.pdf),
            eta=jnp.where(m, bs.eta, out.eta),
            is_valid=jnp.where(m, bs.is_valid, out.is_valid),
        )
    return jax.lax.stop_gradient(out)


def pdf_dispatch(bsdfs, slot, its, wo, active):
    result = jnp.zeros(wo.shape[:-1], jnp.float32)
    for i, b in enumerate(bsdfs):
        m = active & (slot == i)
        result = jnp.where(m, b.pdf(its, wo, m), result)
    return jax.lax.stop_gradient(result)
