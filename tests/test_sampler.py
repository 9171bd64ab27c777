"""Sampler contract tests.

The key invariant (reference sampler.cpp:19-30 + integrator.cpp:23-30): the
value of draw k for global sample lane j is a pure function of (seed, lane,
draw) — so any partition of lanes (crop/batch/shard) reproduces full-frame
sample values exactly.
"""

import numpy as np
import jax.numpy as jnp

from psdr_jax.core.sampler import Sampler


def test_uniform_moments():
    s = Sampler(7, jnp.arange(200_000, dtype=jnp.uint32))
    u = np.asarray(s.next_1d())
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 2e-3
    assert abs(u.var() - 1.0 / 12.0) < 2e-3


def test_draw_decorrelation():
    s = Sampler(3, jnp.arange(100_000, dtype=jnp.uint32))
    a = np.asarray(s.next_1d())
    b = np.asarray(s.next_1d())
    corr = np.corrcoef(a, b)[0, 1]
    assert abs(corr) < 0.01


def test_seed_decorrelation():
    lanes = jnp.arange(100_000, dtype=jnp.uint32)
    a = np.asarray(Sampler(0, lanes).next_1d())
    b = np.asarray(Sampler(1, lanes).next_1d())
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.01
    assert not np.allclose(a, b)


def test_lane_partition_consistency():
    """Sample values for a lane subset == the same lanes of the full set."""
    full = Sampler(11, jnp.arange(4096, dtype=jnp.uint32))
    full_vals = np.asarray(full.next_2d())
    sub_lanes = jnp.asarray([3, 17, 1000, 4095], jnp.uint32)
    sub = Sampler(11, sub_lanes)
    sub_vals = np.asarray(sub.next_2d())
    np.testing.assert_array_equal(sub_vals, full_vals[[3, 17, 1000, 4095]])


def test_determinism():
    lanes = jnp.arange(1024, dtype=jnp.uint32)
    a = np.asarray(Sampler(5, lanes).next_nd(3))
    b = np.asarray(Sampler(5, lanes).next_nd(3))
    np.testing.assert_array_equal(a, b)
