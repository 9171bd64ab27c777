"""Sampling distributions.

* :class:`DiscreteDistribution` — PMF/CDF sampling with sample reuse
  (reference ``src/core/pmf.cpp``), built with ``jnp.cumsum`` on device
  instead of the reference's CPU scan (``pmf.h:12-38``).
* :class:`HyperCubeDistribution` — regular-grid PMF over the unit square/cube
  (reference ``src/core/cube_distrb.cpp``), used for envmap importance
  sampling (2D) and secondary-edge guiding (3D).

Both are pytrees so they live inside jitted scene data.  Sampling tables are
always detached — the reference computes CDFs from detached quantities too.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from .types import pytree, static_field
from .math import searchsorted_1d, safe_div, SEARCHSORTED_DENSE_MAX


def _sample_dense(cdf, pmf, scaled):
    """(idx, pmf[idx], cdf[idx-1]) for one shared small table, with ZERO
    gathers: dense (lanes, N) compares + row reductions fuse into
    streaming elementwise code inside the edge-pass scans.
    """
    shape = scaled.shape
    flat = scaled.reshape(-1)
    lt = cdf[None, :] < flat[:, None]                      # (L, N)
    idx = jnp.minimum(
        jnp.sum(lt, axis=-1, dtype=jnp.int32), cdf.shape[0] - 1
    )
    lower = jnp.max(jnp.where(lt, cdf[None, :], 0.0), axis=-1)  # cdf[idx-1]
    ge = ~lt
    first = ge & jnp.concatenate(
        [jnp.ones((flat.shape[0], 1), bool), lt[:, :-1]], axis=-1
    )
    # if scaled > total (u == 1.0 edge) no 'first' is set: fall back to last
    none_set = ~jnp.any(first, axis=-1)
    p = jnp.sum(jnp.where(first, pmf[None, :], 0.0), axis=-1)
    p = jnp.where(none_set, pmf[-1], p)
    lower_last = cdf[-2] if cdf.shape[0] > 1 else jnp.float32(0.0)
    lower = jnp.where(none_set, lower_last, lower)
    return idx.reshape(shape), p.reshape(shape), lower.reshape(shape)


def _build_alias_rows(pmf):
    """Walker alias table as one packed (N, 4) f32 matrix:
    columns = (prob, alias_idx, pmf_self, pmf_alias).

    Host-side numpy (O(N), the classic two-queue construction): callable
    only on CONCRETE masses — i.e. from ``Scene.configure()`` /
    ``preprocess_secondary_edges``, both of which run outside any trace.
    Sampling then needs ONE per-lane row gather instead of log2(N)
    dependent scalar-table gathers of a binary search over the ~2M-cell
    envmap importance CDF.
    """
    import numpy as np

    p = np.asarray(pmf, np.float64)
    n = p.shape[0]
    # the alias index rides as an f32 column: exact only below 2^24
    # (same packed-f32-index contract as scene.configure_data's assert)
    assert n < (1 << 24), (
        f"{n}-entry alias table: f32-packed alias indices are exact only "
        "below 2^24 entries (core/distribution._build_alias_rows)"
    )
    total = p.sum()
    if not (total > 0.0) or n == 0:
        # degenerate: uniform fallback (matches sample_reuse's safe_div=0
        # path closely enough — such tables are never sampled usefully)
        rows = np.zeros((max(n, 1), 4), np.float32)
        rows[:, 0] = 1.0
        rows[:, 1] = np.arange(max(n, 1))
        return jnp.asarray(rows)
    scaled = p * (n / total)
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    rows = np.empty((n, 4), np.float32)
    rows[:, 0] = prob
    rows[:, 1] = alias
    rows[:, 2] = p
    rows[:, 3] = p[alias]
    return jnp.asarray(rows)


@pytree
class DiscreteDistribution:
    pmf: Any  # (N,) unnormalized masses
    cdf: Any  # (N,) inclusive cumulative sum
    # optional packed Walker alias table (N, 4): O(1)-gather sampling for
    # big tables; None => CDF search (see _build_alias_rows)
    alias_rows: Any = None

    @staticmethod
    def init(pmf) -> "DiscreteDistribution":
        pmf = jax.lax.stop_gradient(jnp.asarray(pmf, jnp.float32))
        return DiscreteDistribution(pmf=pmf, cdf=jnp.cumsum(pmf))

    def with_alias(self) -> "DiscreteDistribution":
        """Attach the alias table (requires concrete masses; host-side)."""
        if self.size <= SEARCHSORTED_DENSE_MAX:
            return self  # dense compare path is already gather-free
        return DiscreteDistribution(
            pmf=self.pmf, cdf=self.cdf,
            alias_rows=_build_alias_rows(self.pmf),
        )

    def _sample_alias(self, u, u_coin=None):
        """(idx, pmf[idx], u') via ONE (lane, 4) row gather.

        ``u_coin``: independent uniform for the alias coin flip.  A f32
        ``u`` carries 24 bits of entropy; selecting among n cells consumes
        log2(n) of them, so at envmap scale (n ~= 2^19-2^21) the residual
        fraction has only 3-5 bits — reusing it as the coin (the
        no-``u_coin`` fallback) QUANTIZES the self-vs-alias decision to
        2^(24-log2 n) levels while the returned pdf stays exact: a small
        systematic estimator bias (first-order cancelling when f/pdf is
        flat, but real — found in review 2026-08-20).  With ``u_coin``
        the coin is exact and the landing distribution is exactly
        pmf/total; ``u'`` is then the raw in-cell fraction (uniform given
        the cell and independent of the coin).  All in-tree callers pass
        the coin (call sites draw one extra sampler number when
        ``needs_coin``); the fallback exists for API compatibility.
        """
        n = self.size
        un = u * n
        j = jnp.clip(un.astype(jnp.int32), 0, n - 1)
        f = un - j.astype(jnp.float32)
        rows = jnp.take(self.alias_rows, j, axis=0)
        prob, alias, p_self, p_other = (
            rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
        )
        if u_coin is not None:
            take_self = u_coin < prob
            idx = jnp.where(take_self, j, alias.astype(jnp.int32))
            p = jnp.where(take_self, p_self, p_other)
            return idx, p, jnp.clip(f, 0.0, 1.0)
        take_self = f < prob
        idx = jnp.where(take_self, j, alias.astype(jnp.int32))
        p = jnp.where(take_self, p_self, p_other)
        u_new = jnp.clip(
            jnp.where(
                take_self,
                safe_div(f, prob),
                safe_div(f - prob, jnp.maximum(1.0 - prob, 1e-12)),
            ),
            0.0, 1.0,
        )
        return idx, p, u_new

    @property
    def needs_coin(self) -> bool:
        """True when sampling wants an extra independent uniform (the
        alias coin, see :meth:`_sample_alias`).  Trace-static: alias
        attachment is part of the pytree structure."""
        return self.alias_rows is not None

    @property
    def size(self) -> int:
        return self.pmf.shape[0]

    @property
    def total(self):
        return self.cdf[-1]

    # reference-compatible accessors (psdr.cpp:187-192)
    @property
    def sum(self):
        return self.total

    def pmf_normalized(self):
        """Normalized probability masses (reference ``pmf()``)."""
        return self.pmf / self.total

    def sample(self, u, u_coin=None):
        """Return (idx, normalized pdf) for uniform samples ``u``."""
        if self.size == 1:
            # pmf.cpp:19-22: a single-entry table returns pdf 1 even when
            # its mass is zero (0/0 -> NaN otherwise)
            return jnp.zeros(u.shape, jnp.int32), jnp.ones_like(u)
        if self.alias_rows is not None:
            idx, p, _ = self._sample_alias(u, u_coin)
            return idx, p / self.total
        scaled = u * self.total
        if self.size <= SEARCHSORTED_DENSE_MAX:
            idx, p, _ = _sample_dense(self.cdf, self.pmf, scaled)
        else:
            idx = searchsorted_1d(self.cdf, scaled)
            p = self.pmf[idx]
        return idx, p / self.total

    def sample_reuse(self, u, u_coin=None):
        """Return (idx, pdf, u') reusing the random number (pmf.cpp:30-51)."""
        if self.size == 1:
            idx = jnp.zeros(u.shape, jnp.int32)
            return idx, jnp.ones_like(u), u
        if self.alias_rows is not None:
            idx, p, u_new = self._sample_alias(u, u_coin)
            return idx, p / self.total, u_new
        scaled = u * self.total
        if self.size <= SEARCHSORTED_DENSE_MAX:
            idx, p, lower = _sample_dense(self.cdf, self.pmf, scaled)
        else:
            idx = searchsorted_1d(self.cdf, scaled)
            lower = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
            p = self.pmf[idx]
        u_new = jnp.clip(safe_div(scaled - lower, p), 0.0, 1.0)
        return idx, p / self.total, u_new


@pytree
class HyperCubeDistribution:
    """Regular-grid PMF over [0,1]^d (cube_distrb.cpp:10-64).

    ``sample_reuse(u)`` warps d-dimensional uniform samples toward
    high-mass cells and returns the pdf of the warped sample; ``pdf(p)``
    evaluates the density at a point.
    """

    res: Any = static_field()        # tuple of ints, length d
    distrb: DiscreteDistribution = None

    @staticmethod
    def init(res, mass) -> "HyperCubeDistribution":
        res = tuple(int(r) for r in res)
        n = 1
        for r in res:
            n *= r
        mass = jnp.asarray(mass, jnp.float32).reshape(n)
        return HyperCubeDistribution(res=res, distrb=DiscreteDistribution.init(mass))

    @property
    def num_cells(self) -> int:
        n = 1
        for r in self.res:
            n *= r
        return n

    def with_alias(self) -> "HyperCubeDistribution":
        """O(1)-gather cell sampling (requires concrete masses)."""
        return HyperCubeDistribution(
            res=self.res, distrb=self.distrb.with_alias()
        )

    def cell_coords(self, idx):
        """Unflatten cell index -> integer coords, row-major over res."""
        coords = []
        for r in reversed(self.res):
            coords.append(idx % r)
            idx = idx // r
        return jnp.stack(list(reversed(coords)), axis=-1)

    @property
    def needs_coin(self) -> bool:
        return self.distrb is not None and self.distrb.needs_coin

    def sample_reuse(self, samples, u_coin=None):
        """Warp (..., d) uniforms; returns (warped_samples, pdf).

        The cell is chosen with the *last* coordinate (reused), then the
        point is jittered uniformly inside the cell (cube_distrb.cpp:43-49).
        ``u_coin``: the alias coin for big tables (see DiscreteDistribution
        ``needs_coin``)."""
        d = len(self.res)
        u_last, _ = samples[..., d - 1], None
        idx, p_cell, u_last = self.distrb.sample_reuse(u_last, u_coin)
        coords = self.cell_coords(idx).astype(jnp.float32)
        res = jnp.asarray(self.res, jnp.float32)
        unit = 1.0 / res
        inner = jnp.concatenate(
            [samples[..., : d - 1], u_last[..., None]], axis=-1
        )
        warped = (coords + inner) * unit
        pdf = p_cell * float(self.num_cells)
        return warped, pdf

    def pdf(self, p):
        """Density at points p in [0,1]^d (cube_distrb.cpp:53-64)."""
        res = jnp.asarray(self.res, jnp.float32)
        ip = jnp.floor(p * res).astype(jnp.int32)
        valid = jnp.all(
            (ip >= 0) & (ip < jnp.asarray(self.res, jnp.int32)), axis=-1
        )
        ip = jnp.clip(ip, 0, jnp.asarray(self.res, jnp.int32) - 1)
        flat = ip[..., 0]
        for i in range(1, len(self.res)):
            flat = flat * self.res[i] + ip[..., i]
        total = self.distrb.total
        dens = safe_div(self.distrb.pmf[flat], total) * float(self.num_cells)
        return jnp.where(valid, dens, 0.0)
