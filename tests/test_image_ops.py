"""Unit tests for the image accumulation ops (ops/image.py).

The derivative-only splat (reference splat semantics: CUDA scatter_reduce
atomics, integrator.cpp:127-129) must behave as a linear scatter-add in
BOTH AD modes while its primal stays exactly zero, for every transpose
formulation (the reverse-mode gather is hand-written via linear_call to
control its lowering).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax.ops.image as im

N_PIX, N = 23, 71


def _data(seed=0):
    rng = np.random.default_rng(seed)
    idx = jnp.asarray(rng.integers(-1, N_PIX, N), jnp.int32)
    v = jnp.asarray(rng.normal(size=(N, 3)), jnp.float32)
    ct = jnp.asarray(rng.normal(size=(N_PIX, 3)), jnp.float32)
    return idx, v, ct


def _scatter_oracle(values, idx):
    img = np.zeros((N_PIX, 3), np.float32)
    for i, ix in enumerate(np.asarray(idx)):
        if ix >= 0:
            img[ix] += np.asarray(values)[i]
    return img


def test_splat_add_matches_oracle():
    idx, v, _ = _data()
    out = im.splat_add(v, idx, N_PIX)
    np.testing.assert_allclose(np.asarray(out), _scatter_oracle(v, idx),
                               rtol=1e-6)


def test_derivative_only_primal_is_zero():
    idx, v, _ = _data()
    out = im.splat_add_derivative_only(v, idx, N_PIX)
    assert np.all(np.asarray(out) == 0.0)


@pytest.mark.parametrize("variant", ["rows", "planar", "lane", "rows_bf16"])
def test_derivative_only_reverse_mode(variant, monkeypatch):
    monkeypatch.setattr(im, "SPLAT_TRANSPOSE", variant)
    idx, v, ct = _data()

    def f(x):
        return jnp.sum(im.splat_add_derivative_only(x * 3.0, idx, N_PIX) * ct)

    g = jax.grad(f)(v)
    exp = np.where(
        (np.asarray(idx) >= 0)[:, None],
        3.0 * np.asarray(ct)[np.clip(np.asarray(idx), 0, None)],
        0.0,
    )
    rtol = 1e-2 if variant == "rows_bf16" else 1e-6
    np.testing.assert_allclose(np.asarray(g), exp, rtol=rtol)


@pytest.mark.parametrize("variant", ["rows", "planar", "lane"])
def test_derivative_only_forward_mode(variant, monkeypatch):
    monkeypatch.setattr(im, "SPLAT_TRANSPOSE", variant)
    idx, v, _ = _data()

    def f(x):
        return im.splat_add_derivative_only(x * 3.0, idx, N_PIX)

    t_in = jnp.asarray(np.random.default_rng(7).normal(size=(N, 3)),
                       jnp.float32)
    _, t = jax.jvp(f, (v,), (t_in,))
    np.testing.assert_allclose(np.asarray(t), _scatter_oracle(3.0 * t_in, idx),
                               rtol=1e-5)


def test_interior_average_matches_mean():
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.normal(size=(8 * 4, 3)), jnp.float32)
    out = im.interior_average(v, 8, 4)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(v).reshape(8, 4, 3).mean(axis=1),
        rtol=1e-6, atol=1e-7,
    )
