"""Deterministic counter-based sampler.

The reference seeds one PCG32 stream per sample lane via a 64-bit TEA hash
(``/root/reference/src/core/sampler.cpp:6-30``) so that sample i of lane j is
a pure function of ``(seed, lane, draw)``.  We keep that contract — it is what
makes batch/crop rendering bitwise consistent with full frames
(``integrator.cpp:23-30``) and hence what makes multi-device sharding exact —
but use a stateless counter-based hash (PCG4D, Jarzynski & Olano, JCGT 2020)
that is plain elementwise integer arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def pcg4d(a, b, c, d):
    """PCG4D hash: four u32 in, four decorrelated u32 out."""
    v0 = a.astype(_U32) * _U32(1664525) + _U32(1013904223)
    v1 = b.astype(_U32) * _U32(1664525) + _U32(1013904223)
    v2 = c.astype(_U32) * _U32(1664525) + _U32(1013904223)
    v3 = d.astype(_U32) * _U32(1664525) + _U32(1013904223)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _u32_to_unit_float(u):
    """Map u32 -> float32 in [0, 1) using the top 24 bits.

    Via int32 (exact: the shifted value is < 2^24), the cast every
    backend and kernel language lowers."""
    return (u >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0
    )


class Sampler:
    """Per-lane independent sample streams.

    ``lane`` are *global* sample indices (e.g. ``pixel_id * spp + s``), so an
    arbitrary partition of lanes across devices/hosts reproduces the exact
    full-frame sample set — the reference's ``batch_pix`` seed-gather trick
    (``integrator.cpp:28``) for free.

    The draw counter is a Python int: under ``jax.jit`` every trace replays
    the same static draw schedule, which mirrors the reference's in-trace
    PCG32 state advance.
    """

    def __init__(self, seed=0, lane=None):
        self.seed_value = jnp.asarray(seed, jnp.uint32)
        self.lane = (jnp.zeros((1,), jnp.uint32) if lane is None
                     else jnp.asarray(lane, jnp.uint32))
        self.cnt = 0

    def seed(self, seed_values):
        """Reference-compatible re-seeding (Sampler::seed, psdr.cpp:183):
        one independent stream per entry of ``seed_values``."""
        seed_values = jnp.asarray(seed_values, jnp.uint32)
        self.lane = seed_values
        self.cnt = 0
        return self

    # historical spelling from this package's first release
    seed_ = seed

    def _draw(self, n_dims: int):
        outs = []
        salt = _U32(0x9E3779B9)
        while len(outs) < n_dims:
            cnt = jnp.full(self.lane.shape, self.cnt, _U32)
            v = pcg4d(self.lane, cnt, jnp.broadcast_to(self.seed_value, self.lane.shape),
                      jnp.broadcast_to(salt, self.lane.shape))
            outs.extend(v[: min(4, n_dims - len(outs))])
            self.cnt += 1
        return [_u32_to_unit_float(u) for u in outs]

    def next_1d(self):
        return self._draw(1)[0]

    def next_2d(self):
        return jnp.stack(self._draw(2), axis=-1)

    def next_nd(self, n: int):
        return jnp.stack(self._draw(n), axis=-1)
