"""Emitter base class (reference include/psdr/emitter/emitter.h:8-66).

The reference dispatches emitters through Dr.Jit vcalls; here concrete
emitters are evaluated masked by the scene layer.  The base exists for the
reference's class hierarchy (``Emitter`` is exposed to Python,
psdr.cpp:342) and documents the interface contract.
"""

from __future__ import annotations

from ..core.object import Object


class Emitter(Object):
    """Interface: concrete emitters provide ``configure``-time data via the
    scene compile and the sampling/eval methods below on that data.

    Conventions (emitter.h:8-66):
    * ``sampling_weight`` drives the scene-level emitter distribution.
    * ``eval(its)`` returns emitted radiance toward ``its.wi``.
    * ``sample_position(ref_p, u2)`` returns a
      :class:`~psdr_jax.core.records.PositionSample`.
    """

    sampling_weight: float = 1.0

    def eval(self, its, active):
        raise NotImplementedError

    def sample_position(self, ref_p, u2, active, u_coin=None):
        raise NotImplementedError

    def sample_position_pdf(self, ref_p, its, active):
        raise NotImplementedError
