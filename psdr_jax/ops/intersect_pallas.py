"""Closest-hit ray/triangle intersection as a Pallas kernel for the GPU.

Replaces the reference's OptiX GAS + ``jit_optix_ray_trace`` launch
(``scene_optix.cpp:265-333, 344-410``).  The kernel is written for Pallas's
Triton route (``backend="triton"``):

* one program per block of ``block_r`` rays; each ray keeps its running
  closest hit ``(t, id, u, v)`` in registers, one slot per chunk column, so
  a chunk costs elementwise work only — the per-ray reduction over the
  ``block_t`` columns runs once, after the last chunk;
* triangles are streamed from global memory in chunks of ``block_t`` inside
  a ``fori_loop``.  Every program reads the same triangles, so they stay in
  L1/L2: no staging in shared memory;
* where there is more than one chunk, a chunk whose bounding box no live
  ray of the block can reach before its current closest hit is skipped
  under ``lax.cond`` (the scene Morton-orders its triangles, so chunks are
  spatially coherent).

The hit test is :func:`ops.intersect.mt_hit`, shared with the blocked
reference; the tie rule is the reference's: smallest ``t``, then the lowest
triangle id.  Triton's float32 division may differ from XLA's in the last
bits, so results agree with the reference within a stated tolerance, not
bitwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .intersect import _INF, CLUSTER_TRIS, mt_hit

# Pairs (rays x triangles) live in one program.  Möller-Trumbore keeps
# about 15 float32 per pair live, so larger tiles spill registers.
TILE_PAIRS = 2048
NUM_WARPS = 4
# Bounding-box culling of triangle chunks; only scenes with more than one
# chunk can gain from it.  On an H100 it won on the 102k-triangle gallery
# and lost on a closed 5k-triangle sphere (PERF.md, findings).
CULL = True


def block_shape(n_tris: int):
    """``(block_r, block_t)`` for a scene of ``n_tris`` triangles: a chunk
    of at most ``CLUSTER_TRIS`` triangles (at least 16: Triton's smallest
    efficient block), and as many rays as keep the tile at
    ``TILE_PAIRS``."""
    block_t = min(CLUSTER_TRIS, max(16, pl.next_power_of_2(max(n_tris, 1))))
    return TILE_PAIRS // block_t, block_t


def _kernel(tri_ref, box_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            t0_ref, t_ref, id_ref, u_ref, v_ref, *, block_t: int,
            n_chunks: int, cull: bool):
    """tri_ref: (9, f_pad); box_ref: (6, n_chunks); rays: (block_r,) each;
    ``t0_ref``: initial closest hit per ray (-inf for dead lanes)."""
    o = tuple(r[...][:, None] for r in (ox_ref, oy_ref, oz_ref))
    d = tuple(r[...][:, None] for r in (dx_ref, dy_ref, dz_ref))
    t0 = t0_ref[...]
    block_r = t0.shape[0]
    shape = (block_r, block_t)
    cols = jax.lax.broadcasted_iota(jnp.int32, shape, 1)

    def test_chunk(k, carry):
        bt, bi, bu, bv = carry
        sl = pl.ds(k * block_t, block_t)
        comp = [tri_ref[c, sl][None, :] for c in range(9)]
        t, u, v, hit = mt_hit(comp[0:3], comp[3:6], comp[6:9], o, d)
        # strict: an equal t in a later chunk has a higher id
        closer = hit & (t < bt)
        return (jnp.where(closer, t, bt),
                jnp.where(closer, cols + k * block_t, bi),
                jnp.where(closer, u, bu),
                jnp.where(closer, v, bv))

    if cull:
        inv = tuple(1.0 / x for x in d)

        def chunk(k, carry):
            best = jnp.min(carry[0], axis=1, keepdims=True)
            t_near, t_far = None, None
            for ax in range(3):
                ta = (box_ref[ax, k] - o[ax]) * inv[ax]
                tb = (box_ref[3 + ax, k] - o[ax]) * inv[ax]
                lo, hi = jnp.minimum(ta, tb), jnp.maximum(ta, tb)
                t_near = lo if t_near is None else jnp.maximum(t_near, lo)
                t_far = hi if t_far is None else jnp.minimum(t_far, hi)
            # written as negations so a NaN slab (origin on a slab plane
            # of an axis-parallel ray) keeps the chunk
            reach = ~(t_near > t_far) & ~(t_far <= 0.0) & ~(t_near >= best)
            any_reach = jnp.max(reach.astype(jnp.int32)) > 0
            return jax.lax.cond(any_reach, lambda c: test_chunk(k, c),
                                lambda c: c, carry)
    else:
        chunk = test_chunk

    init = (jnp.broadcast_to(t0[:, None], shape),
            jnp.full(shape, -1, jnp.int32),
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32))
    bt, bi, bu, bv = jax.lax.fori_loop(0, n_chunks, chunk, init)

    t_min = jnp.min(bt, axis=1)
    big = jnp.int32(2**31 - 1)
    j = jnp.min(jnp.where(bt == t_min[:, None], bi, big), axis=1)
    j = jnp.where(j == big, -1, j)
    sel = bi == j[:, None]
    found = j >= 0
    t_ref[...] = jnp.where(found, t_min, _INF)
    id_ref[...] = j
    u_ref[...] = jnp.sum(jnp.where(sel, bu, 0.0), axis=1)
    v_ref[...] = jnp.sum(jnp.where(sel, bv, 0.0), axis=1)


def chunk_boxes(p0, e1, e2, block_t: int):
    """(6, n_chunks) lower/upper corners of each chunk of ``block_t``
    triangles (rows x, y, z, X, Y, Z), widened by a relative 1e-5 so that
    the slab test's rounding cannot cull a chunk the hit test would hit."""
    nc = p0.shape[0] // block_t
    v0 = p0.reshape(nc, block_t, 3)
    v1 = (p0 + e1).reshape(nc, block_t, 3)
    v2 = (p0 + e2).reshape(nc, block_t, 3)
    lo = jnp.minimum(jnp.minimum(v0.min(1), v1.min(1)), v2.min(1))
    hi = jnp.maximum(jnp.maximum(v0.max(1), v1.max(1)), v2.max(1))
    pad = 1e-5 * (jnp.maximum(jnp.abs(lo), jnp.abs(hi)) + (hi - lo))
    return jnp.concatenate([(lo - pad).T, (hi + pad).T], axis=0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def ray_intersect_pallas(p0, e1, e2, ray_o, ray_d, active=None,
                         interpret: bool = False):
    """Closest hit for (N, 3) rays against (F, 3) triangles.

    Returns ``(tri_id, valid, uv, t)`` — the OptiX payload contract
    (scene_optix.cpp:400-404), ids in the order given here.  ``active``:
    dead lanes take no hit.
    """
    f = p0.shape[0]
    n = ray_o.shape[0]
    block_r, block_t = block_shape(f)
    f_pad = -(-f // block_t) * block_t
    n_pad = -(-n // block_r) * block_r
    n_chunks = f_pad // block_t

    if f_pad != f:
        # zero-area padding at the last real vertex: it never hits and
        # leaves the last chunk's box as it was
        p0 = jnp.pad(p0, ((0, f_pad - f), (0, 0)), mode="edge")
        e1 = jnp.pad(e1, ((0, f_pad - f), (0, 0)))
        e2 = jnp.pad(e2, ((0, f_pad - f), (0, 0)))
    tri = jnp.concatenate([p0.T, e1.T, e2.T], axis=0).astype(jnp.float32)
    boxes = chunk_boxes(p0, e1, e2, block_t).astype(jnp.float32)

    live = jnp.ones((n,), bool) if active is None else active
    t0 = jnp.where(live, _INF, -_INF).astype(jnp.float32)

    def pad_ray(x, fill):
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    rays = [pad_ray(ray_o[:, i], 0.0) for i in range(3)] + [
        pad_ray(ray_d[:, i], 1.0) for i in range(3)
    ] + [pad_ray(t0, -_INF)]

    ray_spec = pl.BlockSpec((block_r,), lambda i: (i,))
    kernel = functools.partial(_kernel, block_t=block_t, n_chunks=n_chunks,
                               cull=CULL and n_chunks > 1)
    out_t, out_id, out_u, out_v = pl.pallas_call(
        kernel,
        grid=(n_pad // block_r,),
        in_specs=[pl.BlockSpec(tri.shape, lambda i: (0, 0)),
                  pl.BlockSpec(boxes.shape, lambda i: (0, 0))]
        + [ray_spec] * 7,
        out_specs=[ray_spec] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="ray_intersect_closest",
    )(tri, boxes, *rays)

    tri_id = out_id[:n]
    valid = tri_id >= 0
    uv = jnp.stack([out_u[:n], out_v[:n]], axis=-1)
    return tri_id, valid, uv, out_t[:n]
