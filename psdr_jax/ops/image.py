"""Image accumulation helpers.

The reference splats with CUDA ``scatter_reduce(Add)`` atomics
(``integrator.cpp:127-129``) — non-deterministic float order.  Here edge
samples go through XLA scatter-add (atomics on the GPU, so their order is
not deterministic either), and the interior term, whose sample->pixel map is
affine, through a plain reshape + mean.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax import custom_derivatives as _cd


def splat_add(values, idx, n_pix: int):
    """Scatter-add (..., C) values at (...,) pixel ids into (n_pix, C).

    Negative ids are dropped (mode='drop' handles out-of-range).  Leading
    index dims are arbitrary: the edge passes splat their CHUNKED
    (k, chunk, 3) value stacks directly, with no flattening relayout in
    the reverse-mode transpose gather.
    """
    idx = jnp.where(idx >= 0, idx, n_pix)  # out of range -> dropped
    img = jnp.zeros((n_pix, values.shape[-1]), values.dtype)
    return img.at[idx].add(values, mode="drop")


@functools.partial(jax.custom_jvp, nondiff_argnums=(2,))
def splat_add_derivative_only(values, idx, n_pix: int):
    """Splat for derivative-only estimators (boundary terms).

    The boundary images satisfy ``value - stop_gradient(value)`` — their
    PRIMAL is identically zero, so the primal scatter (8M+ lanes into the
    pixel grid) is skipped and zeros returned directly.  Differentiation still sees the
    true linear relationship:

    * forward mode (``jax.jvp`` grad images): the tangent rule scatter-adds
      the lane tangents — one real scatter, unavoidable there;
    * reverse mode (``jax.grad`` optimization): the transpose of that
      linear tangent rule is a GATHER of the adjoint image at ``idx`` —
      the whole pass becomes scatter-free.

    The subtraction making the value derivative-only is built in: primal
    values are ignored entirely.
    """
    del values, idx
    return jnp.zeros((n_pix, 3), jnp.float32)


# Transpose-gather formulation for the reverse-mode edge pullback.  XLA's
# automatic transpose of the tangent scatter is a row gather of the adjoint
# image at 8M+ per-lane pixel ids.  The default gathers from a bf16 copy of
# the adjoint table, halving the bytes read; the adjoint image only seeds
# the MC boundary estimators, whose own std dwarfs bf16 rounding (the
# forward/tangent splat stays f32, so jvp grad images are untouched).  The
# formulations were compared on the previous accelerator; on the H100 they
# are not measured yet.
SPLAT_TRANSPOSE = os.environ.get("PSDR_SPLAT_T", "rows_bf16")


def _gather_ct(ct, idx, n_pix: int, out_dtype=None):
    """Gather adjoint rows ``ct[idx]`` with 0.0 for dropped (idx<0) lanes.

    ``out_dtype``: dtype of the returned cotangent (the linear input's
    dtype).  When the edge pass stacks its values in bf16 (the fused
    reverse path), the rows_bf16 gather returns bf16 DIRECTLY — no
    standalone 8M-row f32 back-convert; the upcast fuses into the backward
    scan body instead.  Numerically identical: the table rounding is the
    same, and bf16->f32 converts are exact.
    """
    out_dtype = ct.dtype if out_dtype is None else out_dtype
    safe = jnp.where((idx >= 0) & (idx < n_pix), idx, n_pix)
    if SPLAT_TRANSPOSE == "planar":
        # three 1-D gathers from one zero-row-padded planar table
        ctp = jnp.concatenate([ct, jnp.zeros((1, 3), ct.dtype)])
        cf = ctp.T.reshape(-1)
        stride = n_pix + 1
        return jnp.stack(
            [cf[safe], cf[safe + stride], cf[safe + 2 * stride]], axis=-1
        ).astype(out_dtype)
    if SPLAT_TRANSPOSE == "lane":
        # gather along the 128-lane axis of the transposed table
        ctp = jnp.concatenate([ct, jnp.zeros((1, 3), ct.dtype)])
        return jnp.moveaxis(jnp.take(ctp.T, safe, axis=1), 0, -1).astype(
            out_dtype
        )
    if SPLAT_TRANSPOSE == "rows_bf16":
        # halve the per-row tile read: (8, 128) bf16 tiles are 2 KB.  The
        # adjoint image is a loss gradient consumed by MC edge estimators
        # whose own std is orders of magnitude above bf16 rounding.
        ctp = jnp.concatenate(
            [ct.astype(jnp.bfloat16), jnp.zeros((1, 3), jnp.bfloat16)]
        )
        return ctp[safe].astype(out_dtype)
    return jnp.concatenate([ct, jnp.zeros((1, 3), ct.dtype)])[safe].astype(
        out_dtype
    )


def _splat_linear(t_values, idx, n_pix: int):
    """Tangent-rule scatter with an explicitly-controlled transpose.

    The tangent stack may arrive bf16 (fused reverse path, see
    integrator/base._chunked_splat_sum stack_dtype); the image scatter
    always accumulates in f32, and the transpose hands back a cotangent in
    the stack's own dtype so no standalone full-lane convert materialises.
    """
    return _cd.linear_call(
        lambda r, t: splat_add(t.astype(jnp.float32), r, n_pix),
        lambda r, ct: _gather_ct(ct, r, n_pix, out_dtype=t_values.dtype),
        idx, t_values,
    )


def _splat_add_derivative_only_jvp(n_pix, primals, tangents):
    values, idx = primals
    t_values = tangents[0]
    out = jnp.zeros((n_pix, 3), jnp.float32)
    if type(t_values) is jax.custom_derivatives.SymbolicZero:
        # value-tangent-free differentiation (e.g. only idx depends on the
        # inputs, which is non-differentiable): skip the lane scatter
        return out, jnp.zeros((n_pix, 3), jnp.float32)
    return out, _splat_linear(t_values, idx, n_pix)


# symbolic_zeros so the SymbolicZero fast path above actually fires —
# without it zero tangents arrive materialized and pay the full scatter
splat_add_derivative_only.defjvp(
    _splat_add_derivative_only_jvp, symbolic_zeros=True
)


def interior_average(values, n_active_pix: int, spp: int):
    """(n_pix*spp, C) pixel-major samples -> (n_pix, C) mean.

    Written as a dot with a constant 1/spp vector: the equivalent
    middle-axis ``mean`` lowers to a strided reduction, far below memory
    bandwidth on the previous accelerator.
    """
    if spp == 1:
        return values
    v = values.reshape(n_active_pix, spp, values.shape[-1])
    w = jnp.full((spp,), 1.0 / spp, values.dtype)
    return jax.lax.dot_general(
        w, v, (((0,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
