"""Fused forward+adjoint inverse-rendering step (one pass, zero recompute).

The reference gets its gradient from the Dr.Jit tape: one forward sweep
records, one backward sweep replays — no rematerialization
(reference README.md:102-104).  ``jax.grad(renderD)`` cannot match that
cost structure: full-frame reverse-AD residuals exceed device memory, so the
render path remats (``jax.checkpoint``) or path-replays (integrator/prb.py),
and either way forward shading runs twice.

For PIXEL-LOCAL losses (L2/L1/relative — one term per pixel, the production
inverse-rendering case) the tape cost structure IS reachable: each interior
chunk owns a disjoint pixel set, so the loss cotangent for a chunk is
computable from that chunk's own output.  The fused step scans chunks doing

    forward chunk -> local loss + cotangent -> immediate pullback -> accum

holding ONE chunk's reverse-AD residuals at a time with no recompute at
all.  The boundary (edge) estimators have exactly-zero primal, so the full
loss-gradient image is known once the interior scan finishes; each edge
pass then gets one ``jax.vjp`` whose backward is cheap (detached values are
checkpoint-policy-saved, base.py CHECKPOINT_POLICY).

Cost: 1x interior forward + 1x adjoint (vs 2x forward + adjoint for
remat/path-replay).  Works under a single outer ``jax.jit``; identical
sample set and values as ``jax.grad`` of ``renderD``.  NOTE for guided
optimization loops: a USER-jitted closure over
``loss_and_grad`` would bake the secondary-edge guiding table at trace
time; tracing with an implicit table therefore RAISES — pass the table
as a jit argument (``warp=``, see :func:`loss_and_grad`).  The
``renderD`` path and ``parallel.make_fused_train_step`` thread the table
automatically.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import base as _base
from .base import interior_chunk


def _split_float(tree):
    """Flatten ``tree``; return (float_leaves, rebuild) where rebuild maps
    updated float leaves back into a cotangent pytree with ``float0`` zeros
    for integer/bool leaves (what ``jax.vjp`` pullbacks expect)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    is_float = [jnp.issubdtype(l.dtype, jnp.floating) for l in leaves]
    floats = [l for l, f in zip(leaves, is_float) if f]

    def rebuild(new_floats):
        it = iter(new_floats)
        out = [
            next(it) if f else np.zeros(jnp.shape(l), jax.dtypes.float0)
            for l, f in zip(leaves, is_float)
        ]
        return jax.tree_util.tree_unflatten(treedef, out)

    return floats, rebuild


def _add_float_cotangent(acc, cot):
    """acc (list of float arrays) += float leaves of cotangent pytree
    ``cot`` (which may contain float0 leaves for int/bool positions)."""
    leaves = jax.tree_util.tree_leaves(cot)
    floats = [
        l for l in leaves
        if hasattr(l, "dtype") and l.dtype != jax.dtypes.float0
    ]
    return [a + b for a, b in zip(acc, floats)]


def _interior_scan(integrator, sd, opts, sensor_id: int, seed, pixel_loss,
                   pix):
    """Fused forward+adjoint over the pixel rows ``pix`` (n_local,) int32.

    Returns ``(loss, acc_floats, image (n_local, 3), g (n_local, 3))`` —
    the local loss, the accumulated float cotangent leaves of ``sd``, the
    interior image rows and the loss-cotangent rows."""
    spp = opts.spp
    n_local = pix.shape[0]
    zero_floats, _ = _split_float(sd)
    zero_floats = [jnp.zeros_like(x) for x in zero_floats]

    if spp == 0:
        # edge-term-only configuration (renderD supports it: the interior
        # image is exactly zero); the loss cotangent is still needed to
        # pull back through the edge passes
        image = jnp.zeros((n_local, 3), jnp.float32)
        loss, pull = jax.vjp(
            lambda rows: jnp.sum(pixel_loss(rows, pix)), image
        )
        (g,) = pull(jnp.float32(1.0))
        return loss, zero_floats, image, g

    # same chunk geometry as the remat render path (pad rows render pixel
    # 0 and are masked out of the loss below)
    pix_chunks, row_valid = _base.pad_pixel_chunks(pix, spp, sd)
    n_pad = pix_chunks.size

    def body(carry, xs):
        acc, loss_acc = carry
        pix_chunk, valid = xs
        out, pull = jax.vjp(
            lambda s: interior_chunk(integrator, s, opts, sensor_id, seed,
                                     spp, True, pix_chunk),
            sd,
        )

        def masked_loss(o):
            lv = pixel_loss(o, pix_chunk)
            return jnp.sum(jnp.where(valid, lv, 0.0))

        loss_c, g = jax.value_and_grad(masked_loss)(out)
        (sdb,) = pull(g)
        acc = _add_float_cotangent(acc, sdb)
        return (acc, loss_acc + loss_c), (out, g)

    (acc, loss), (img_pad, g_pad) = jax.lax.scan(
        body, (zero_floats, jnp.float32(0.0)), (pix_chunks, row_valid)
    )
    return (loss, acc, img_pad.reshape(n_pad, 3)[:n_local],
            g_pad.reshape(n_pad, 3)[:n_local])


def fused_loss_grad(integrator, sd, opts, sensor_id: int, seed, pixel_loss):
    """Returns ``(loss, sd_bar, image)``.

    ``pixel_loss(img_rows (m, 3), pix_ids (m,)) -> (m,)`` per-pixel loss
    terms; it must be pixel-local (row i may only depend on img_rows[i]).
    ``sd_bar`` is a cotangent for ``sd`` (float0 at integer leaves), ready
    for the pullback of whatever produced ``sd``.
    """
    n_pix = opts.num_pixels
    seed = jnp.asarray(seed, jnp.uint32)
    _, rebuild = _split_float(sd)
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    loss, acc, image, g_img = _interior_scan(
        integrator, sd, opts, sensor_id, seed, pixel_loss, pix
    )

    # Boundary terms: primal is exactly zero, so they contribute to the
    # gradient only — pull the full-frame loss-cotangent image through each
    # derivative-only edge pass (integrator.cpp:179-198 / path.cpp:274-294).
    acc = _edge_pullbacks(integrator, sd, opts, sensor_id, seed, g_img, acc)
    return loss, rebuild(acc), image


def _edge_pullbacks(integrator, sd, opts, sensor_id: int, seed, g_img, acc,
                    lane_window=None):
    """Accumulate the edge-estimator cotangents into ``acc``.

    ``lane_window``: optional ``(device_idx, n_dev)`` — process only this
    device's 1/n_dev slice of each global edge-sample lane space (the
    sharded partition of render_impl_sharded, base.py)."""
    # reverse-only path: the edge-value stack's primal is ignored and its
    # cotangent is already bf16-rounded by the rows_bf16 adjoint table, so
    # stacking in bf16 is numerically free and kills the standalone 8M-row
    # f32 converts + halves the stack's HBM traffic (ops/image._gather_ct).
    from ..ops.image import SPLAT_TRANSPOSE
    stack_dtype = jnp.bfloat16 if SPLAT_TRANSPOSE == "rows_bf16" else None

    def window(total):
        if lane_window is None:
            return {}
        idx, n_dev = lane_window
        off, per = _base.shard_lane_window(total, n_dev, idx)
        return {"lane_offset": off, "lane_count": per,
                "lane_total": total}

    if opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
        kw = window(opts.num_pixels * opts.sppe)
        kw["stack_dtype"] = stack_dtype
        _, pull_e = jax.vjp(
            lambda s: integrator._render_primary_edges(s, opts, sensor_id,
                                                       seed, **kw), sd
        )
        (sdb,) = pull_e(g_img)
        acc = _add_float_cotangent(acc, sdb)
    from .base import Integrator as _Base
    has_se = (type(integrator).render_secondary_edges
              is not _Base.render_secondary_edges)
    if opts.sppse > 0 and sd.sec_edge is not None and has_se:
        kw = window(opts.num_pixels * opts.sppse)
        kw["stack_dtype"] = stack_dtype
        _, pull_s = jax.vjp(
            lambda s: integrator.render_secondary_edges(s, opts, sensor_id,
                                                        seed, **kw), sd
        )
        (sdb,) = pull_s(g_img)
        acc = _add_float_cotangent(acc, sdb)
    return acc


def fused_loss_grad_sharded(integrator, sd, opts, sensor_id: int, seed,
                            pixel_loss, pix_shard, axis: str):
    """Per-device body of the sharded fused step (inside ``shard_map``).

    ``pix_shard``: this device's CONTIGUOUS slice of the global pixel ids
    (device-order concatenation must equal the full frame).  The interior
    term runs on the shard; the loss-cotangent rows are all-gathered into
    the full-frame cotangent image (edge samples splat to arbitrary
    pixels); each device pulls back its 1/n_dev window of the edge-sample
    lanes; float cotangents and the loss are ``psum``'d — collectives that
    XLA hands to NCCL over NVLink.  Exactly the transpose of
    ``render_impl_sharded``'s partitioning, with zero recompute.

    Returns ``(loss, sd_bar, image_rows)`` — loss/sd_bar replicated,
    image rows local to the shard.
    """
    idx = jax.lax.axis_index(axis)
    n_dev = jax.lax.axis_size(axis)
    seed = jnp.asarray(seed, jnp.uint32)
    _, rebuild = _split_float(sd)

    loss, acc, image, g_local = _interior_scan(
        integrator, sd, opts, sensor_id, seed, pixel_loss, pix_shard
    )
    g_img = jax.lax.all_gather(g_local, axis).reshape(-1, 3)
    acc = _edge_pullbacks(integrator, sd, opts, sensor_id, seed, g_img, acc,
                          lane_window=(idx, n_dev))
    loss = jax.lax.psum(loss, axis)
    acc = [jax.lax.psum(a, axis) for a in acc]
    return loss, rebuild(acc), image


_WARP_AUTO = object()  # sentinel: "warp not passed explicitly"


def _under_trace() -> bool:
    """True when called inside an active jax trace (a user ``jax.jit``)."""
    from jax._src.core import trace_state_clean

    return not trace_state_clean()


def loss_and_grad(integrator, scene, params, apply_params, pixel_loss,
                  sensor_id: int = 0, seed: int = -1, warp=_WARP_AUTO):
    """One fused training step: ``(loss, param_grads, image)``.

    ``apply_params(params)`` mutates the python scene objects (same closure
    pattern as differentiating ``renderD``); gradients flow back through
    ``scene.configure_data``'s traced compile.  Jittable as a whole:
    ``jax.jit(lambda p, s: integ.loss_and_grad(scene, p, apply, loss, seed=s))``.

    ``warp``: the secondary-edge guiding table.  Left unset, the
    integrator's current table is used — and, because a guiding table
    read inside a USER ``jax.jit`` closure would be silently baked at
    trace time (a later ``preprocess_secondary_edges`` would then be
    ignored — stale gradients), tracing with an implicit table RAISES.
    For guided loops under a user jit, thread the table as a jit
    argument::

        step = jax.jit(lambda p, s, w: integ.loss_and_grad(
            sc, p, apply, ploss, seed=s, warp=w))
        step(params, seed, integ.warpper.get(0))   # fresh every call

    or skip the outer jit (the fused step is internally chunk-jitted) —
    ``renderD`` and ``parallel.make_fused_train_step`` already thread the
    table automatically.  Passing ``warp=None`` explicitly renders
    unguided.
    """
    seed, _ = integrator._norm_args(scene, seed, None, None)
    has_warpper = hasattr(integrator, "warpper")
    if warp is _WARP_AUTO:
        warp = (integrator.warpper.get(sensor_id) if has_warpper else None)
        if warp is not None and _under_trace():
            raise RuntimeError(
                "loss_and_grad is being traced (an outer jax.jit) while the "
                f"integrator holds a secondary-edge guiding table for sensor "
                f"{sensor_id}: the table would be baked into the trace as a "
                "constant and any later preprocess_secondary_edges would be "
                "silently ignored (stale gradients). Pass the table as a jit "
                "argument instead: jax.jit(lambda p, s, w: integ."
                "loss_and_grad(..., warp=w)) and feed integ.warpper.get("
                f"{sensor_id}) per call; or pass warp=None to render "
                "unguided; or drop the outer jit."
            )

    def to_sd(p):
        apply_params(p)
        return scene.configure_data(scene._active_sensors)

    sd, pull_cfg = jax.vjp(to_sd, params)
    prev = integrator.warpper if has_warpper else None
    if has_warpper:
        integrator.warpper = {**prev, sensor_id: warp}
    try:
        loss, sd_bar, image = fused_loss_grad(
            integrator, sd, scene.opts, sensor_id, jnp.uint32(seed),
            pixel_loss
        )
    finally:
        if has_warpper:
            integrator.warpper = prev
    (p_bar,) = pull_cfg(sd_bar)
    return loss, p_bar, image
