"""Differentiation-friendly row gathers.

Reverse-mode AD transposes every gather of differentiable data into a
scatter-add.  For the small tables this renderer gathers per hit/sample
(triangle SoA, edge SoA, screen-edge endpoints), a one-hot matmul is the
alternative: its transpose is a single matmul into the table, with no
atomics and a fixed summation order.

``gather_rows(matrix, idx)`` — (F, D) table, integer idx of any shape →
(idx.shape + (D,)) rows.  Uses the one-hot path when F <= threshold,
falling back to a plain gather (whose backward is one scatter for the whole
packed table — still far better than one scatter per field).

Precision — the exact-bf16x3 formulation.  A selection matmul does not need
generic f32 products: split the f32 table into three bf16 parts with
non-overlapping mantissas,

    hi = bf16(t);  mid = bf16(t - hi);  lo = bf16(t - hi - mid)

(f32 has a 24-bit mantissa = 3 x 8-bit bf16 mantissas, and each residual
subtraction is exact in f32, so ``hi + mid + lo == t`` BITWISE).  The parts
are stacked along ROWS (3F, D) and the one-hot tripled to (N, 3F), so the
three exact partial products sum in the matmul's f32 accumulator: one bf16
dot, one (N, D) f32 output, bitwise-equal to ``matrix[idx]``.  The
transpose applies the same split to the cotangent columns, so reverse-mode
table gradients keep full f32 significance too.  (A plain f32 one-hot
matmul would need ``Precision.HIGHEST``; under TF32 it would round every
gathered value to 10 mantissa bits.)  The bitwise property is checked on
the card by tests/test_chip.py.

The split masks bits instead of converting (:func:`_trunc_parts`): the
convert-pair formulation ``bf16(t); t - f32(hi)`` can be collapsed by XLA's
excess-precision elision, which rewrites ``f32(bf16(x))`` back to ``x`` and
silently degrades the gather to one bf16 pass.  The masked split is also
total over f32: no bf16-max overflow cliff.

Set ``PSDR_GATHER=highest`` to fall back to the plain f32 matmul at
``Precision.HIGHEST`` when isolating numerical questions.
``PSDR_GATHER=convert`` deliberately selects the elision-prone convert-pair
split — it exists ONLY to check that the cross-backend gradient oracle
(tests/crosscheck.py) can detect that bug class; never use it for real
renders.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import custom_derivatives as _cd

ONE_HOT_MAX_ROWS = 1024


def _gather_mode():
    # read at trace time so A/B harnesses can flip it between jit compiles
    return os.environ.get("PSDR_GATHER", "bf16x3")


def _trunc_bf16(x):
    """Truncate f32 to its top 8 significand bits by masking — the result
    is exactly bf16-representable, computed WITHOUT a convert pair.

    The obvious formulation ``hi = bf16(x); r = x - f32(hi)`` is exposed
    to XLA's excess-precision elision, which may rewrite ``f32(bf16(x))``
    back to ``x``: the residual then collapses to ZERO and the "exact"
    3-part split silently degrades to one bf16 pass.  Bit masking has no
    convert for the simplifier to touch; truncation (toward zero) instead
    of round-to-nearest changes the parts but not the exactness of
    hi+mid+lo == x."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return jax.lax.bitcast_convert_type(
        u & jnp.uint32(0xFFFF0000), jnp.float32)


def _convert_parts(m):
    """The elision-prone convert-pair split, kept ONLY for oracle
    validation (PSDR_GATHER=convert): where XLA's excess-precision elision
    rewrites ``m - f32(bf16(m))`` to zero, mid/lo collapse and the "exact"
    gather silently runs one bf16 pass; on the CPU (no elision) it is
    exact."""
    hi = m.astype(jnp.bfloat16)
    r1 = m - hi.astype(jnp.float32)
    mid = r1.astype(jnp.bfloat16)
    lo = r1 - mid.astype(jnp.float32)
    return hi, mid, lo.astype(jnp.bfloat16)


def _trunc_parts(m):
    """Exact 3-way split: bf16 parts with hi+mid+lo == m BITWISE.

    f32 has a 24-bit significand = 3 x 8-bit bf16 significands; each
    masked truncation removes the top 8 remaining bits and the residual
    subtraction is exact (the operands share sign and exponent), so
    ``lo`` holds the final <= 8 bits exactly.  Converting each part to
    bf16 is exact (their low significand bits are zero by construction)
    and cannot OVERflow (bf16 shares f32's exponent range, so there is
    no bf16-max NaN cliff).  UNDERflow carve-out (measured 2026-08-20):
    bf16's smallest subnormal is 2^-133, so the split is bitwise exact
    iff the value's lowest set significand bit is >= 2^-133 — always
    true for |m| >= 2^-109 (~1.5e-33); below that the mid/lo parts can
    round (f32 denormals < 2^-133 reconstruct as 0).  Physical table
    values (radiance, positions, pdfs) sit tens of orders of magnitude
    above the carve-out."""
    hi = _trunc_bf16(m)
    r1 = m - hi
    mid = _trunc_bf16(r1)
    lo = r1 - mid
    return (hi.astype(jnp.bfloat16), mid.astype(jnp.bfloat16),
            lo.astype(jnp.bfloat16))


def _parts(m):
    if _gather_mode() == "convert":
        return _convert_parts(m)
    return _trunc_parts(m)


def _split3(m):
    """Exact 3-way bf16 split along a new trailing concat: hi+mid+lo == m."""
    return jnp.concatenate(_parts(m), axis=-1)


def _sel3(oh3, matrix):
    """Exact f32 row selection in one matmul.

    ``oh3`` is the (N, 3F) bf16 tripled one-hot; the table is split into
    bf16 parts stacked along ROWS (3F, D), so the three exact partial
    products sum inside the matmul's f32 accumulator — single (N, D) f32
    output, no widened intermediate, no part-adds.
    """
    f, d = matrix.shape
    t3 = _split3(matrix).reshape(f, 3, d).swapaxes(0, 1).reshape(3 * f, d)
    return jax.lax.dot_general(
        oh3, t3, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _scat3(oh3, ct):
    """Adjoint of :func:`_sel3`: one-hot^T @ ct, same exact-split trick.

    Splits the (N, D) f32 cotangent into bf16 parts along COLUMNS and
    contracts the tripled one-hot's lane axis: g3 (3F, D) holds the three
    partial sums, whose f32 add restores full significance (the tripled
    blocks of ``oh3`` are identical, so block k of g3 is one-hot^T @
    part_k).  Partial sums accumulate in f32 inside the matmul.
    """
    f = oh3.shape[-1] // 3
    d = ct.shape[-1]
    g3 = jax.lax.dot_general(
        oh3[:, :f], _split3(ct), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (F, 3D): block j = one-hot^T @ part_j
    return g3[..., :d] + g3[..., d:2 * d] + g3[..., 2 * d:]


def gather_rows(matrix, idx, one_hot_max_rows: int = ONE_HOT_MAX_ROWS):
    f, d = matrix.shape
    if f > one_hot_max_rows:
        return matrix[idx]
    if _gather_mode() == "highest" or matrix.dtype != jnp.float32:
        oh = jax.nn.one_hot(idx, f, dtype=matrix.dtype)
        return jax.lax.dot_general(
            oh, matrix, (((oh.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    lanes = idx.reshape(-1)
    # tripled one-hot (N, 3F): block k column k*F+r is (idx == r) — one
    # compare/select fusion, 0/1 exact in bf16
    j = jax.lax.iota(jnp.int32, 3 * f) % f
    oh3 = (lanes[:, None] == j[None, :]).astype(jnp.bfloat16)
    out = _cd.linear_call(_sel3, _scat3, oh3, matrix)
    return out.reshape(jnp.shape(idx) + (d,))
