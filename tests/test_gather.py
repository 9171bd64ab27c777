"""Unit tests for the exact bf16x3 one-hot gather (ops/gather.py).

The formulation claims BITWISE equality with ``matrix[idx]`` (the three
bf16 mantissa parts reconstruct f32 exactly) and a full-significance
transpose.  These properties gate every per-hit attribute fetch in the
renderer, so they are pinned here independently of the render-level tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psdr_jax.ops.gather import gather_rows, _split3


def _table(rng, f=64, d=33):
    # mix magnitudes so bf16 rounding would be visible anywhere
    scale = rng.choice([1e-6, 1e-3, 1.0, 1e4, 3e7], (f, d))
    return jnp.asarray(rng.standard_normal((f, d)) * scale, jnp.float32)


def test_split3_reconstructs_bitwise():
    rng = np.random.default_rng(3)
    m = _table(rng)
    t3 = np.asarray(_split3(m))
    rec = (t3[:, :33].astype(np.float32) + t3[:, 33:66].astype(np.float32)
           + t3[:, 66:].astype(np.float32))
    assert np.array_equal(rec, np.asarray(m))


def test_forward_bitwise_equal_to_plain_gather():
    rng = np.random.default_rng(0)
    m = _table(rng)
    idx = jnp.asarray(rng.integers(0, 64, (4096,)), jnp.int32)
    assert bool(jnp.all(gather_rows(m, idx) == m[idx]))


def test_multidim_idx_shape_and_values():
    rng = np.random.default_rng(1)
    m = _table(rng, f=17, d=5)
    idx = jnp.asarray(rng.integers(0, 17, (8, 32)), jnp.int32)
    out = gather_rows(m, idx)
    assert out.shape == (8, 32, 5)
    assert bool(jnp.all(out == m[idx]))


def test_out_of_range_rows_are_zero():
    """one-hot drop semantics: invalid ids contribute nothing (edge passes
    mark dropped lanes with idx=-1)."""
    rng = np.random.default_rng(2)
    m = _table(rng, f=8, d=4)
    out = gather_rows(m, jnp.asarray([-1, 8, 3], jnp.int32))
    assert bool(jnp.all(out[0] == 0) and jnp.all(out[1] == 0))
    assert bool(jnp.all(out[2] == m[3]))


def test_transpose_matches_scatter_oracle():
    rng = np.random.default_rng(4)
    m = _table(rng)
    idx = jnp.asarray(rng.integers(0, 64, (2048,)), jnp.int32)
    ct = jnp.asarray(rng.standard_normal((2048, 33)), jnp.float32)
    g = jax.grad(lambda t: jnp.vdot(gather_rows(t, idx), ct))(m)
    ref = jax.grad(lambda t: jnp.vdot(t[idx], ct))(m)
    denom = jnp.abs(ref).max()
    assert float(jnp.abs(g - ref).max() / denom) < 1e-6


def test_jvp_is_exact_selection():
    rng = np.random.default_rng(5)
    m = _table(rng)
    t = _table(rng)
    idx = jnp.asarray(rng.integers(0, 64, (512,)), jnp.int32)
    _, jv = jax.jvp(lambda x: gather_rows(x, idx), (m,), (t,))
    assert bool(jnp.all(jv == t[idx]))


def test_large_table_falls_back_to_plain_gather():
    rng = np.random.default_rng(6)
    m = jnp.asarray(rng.standard_normal((3000, 3)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 3000, (64,)), jnp.int32)
    assert bool(jnp.all(gather_rows(m, idx) == m[idx]))


@pytest.mark.parametrize("val", [0.0, -0.0, 1.0, np.float32(2**-120),
                                 np.float32(3.38e38)])
def test_extreme_values_exact(val):
    m = jnp.full((4, 2), val, jnp.float32)
    out = gather_rows(m, jnp.asarray([0, 3], jnp.int32))
    assert bool(jnp.all(out == m[jnp.asarray([0, 3])]))


def test_beyond_bf16_max_stays_exact():
    """The masked-truncation split has no overflow cliff: |t| beyond the
    bf16 ROUNDING max (~3.39e38) still reconstructs exactly — the hi
    part's truncation saturates at bf16's max finite and the residual
    parts carry the remainder.  (The pre-2026-08-20 formulation NaN'd
    here; the masked split is exact everywhere above the tiny-value
    carve-out below.)"""
    m = jnp.full((4, 2), 3.4e38, jnp.float32)
    out = gather_rows(m, jnp.asarray([1], jnp.int32))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(m)[1:2])


def test_tiny_value_exactness_boundary():
    """Documented underflow carve-out of the bf16x3 split (_trunc_parts):
    exact iff the value's lowest set significand bit is >= 2^-133 —
    always for |t| >= 2^-109; f32 denormals below bf16's smallest
    subnormal reconstruct as 0.  Physical tables never get near this."""
    exact = jnp.asarray([[2.0 ** -109], [2.0 ** -126], [-2.0 ** -100]],
                        jnp.float32)
    out = gather_rows(exact, jnp.asarray([0, 1, 2], jnp.int32))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(exact))
    # below the carve-out: a denormal under 2^-133 is NOT recoverable
    tiny = jnp.full((2, 1), 2.0 ** -140, jnp.float32)
    out = np.asarray(gather_rows(tiny, jnp.asarray([0], jnp.int32)))
    assert out[0, 0] == 0.0
