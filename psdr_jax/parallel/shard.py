"""Explicit shard_map training step for multi-chip/multi-host optimization.

``parallel.mesh.render_sharded`` relies on jit auto-sharding (pixels sharded
via input shardings).  This module is the explicit SPMD formulation for
production training loops: each device renders its pixel shard and computes
the local loss/gradients, and scene-parameter gradients are combined with
``jax.lax.psum`` over the mesh axis — a collective that XLA hands to NCCL,
over NVLink between the cards of a host and the network across hosts
(SURVEY.md §2.5).
Scene data is tiny and replicated.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_sharded_value_and_grad(loss_fn, mesh: Mesh, axis: str = "pix"):
    """Build a pmapped-style value_and_grad over a pixel-sharded loss.

    ``loss_fn(params, pix_ids, target_shard)`` must return the SUM of
    per-pixel losses for its shard (sums are psum-combinable; means are
    not).  Returns ``f(params, pix, target) -> (loss, grads)`` where ``pix``
    and ``target`` are sharded over ``axis`` and ``params`` are replicated.
    """

    def local_step(params, pix, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, pix, target)
        loss = jax.lax.psum(loss, axis)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axis), grads)
        return loss, grads

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_fused_train_step(scene, integrator, mesh: Mesh, apply_params,
                          pixel_loss, sensor_id: int = 0, axis: str = "pix"):
    """Sharded production training step with the fused forward+adjoint pass.

    Combines ``integrator.loss_and_grad``'s cost structure (one forward +
    one adjoint, zero recompute — integrator/fused.py) with
    ``render_impl_sharded``'s partitioning: each device renders its
    contiguous pixel-row shard and pulls back its 1/n_dev window of the
    edge-sample lanes; the loss-cotangent image is ``all_gather``'d (edge
    samples splat to arbitrary pixels) and parameter cotangents are
    ``psum``'d (NCCL collectives).

    ``apply_params(params)`` mutates the scene objects (the same closure
    convention as ``loss_and_grad``); ``pixel_loss(rows (m,3), pix (m,))
    -> (m,)`` must be pixel-local.  Returns ``step(params, seed) ->
    (loss, param_grads, image (n_pix, 3))``, jitted over the mesh.
    """
    from ..integrator.fused import fused_loss_grad_sharded

    opts = scene.opts
    n_pix = opts.num_pixels
    assert n_pix % mesh.devices.size == 0, (
        "device count must divide the pixel count"
    )
    active = scene._active_sensors

    def local_step(params, warp, pix_shard, seed):
        def to_sd(p):
            apply_params(p)
            return scene.configure_data(active)

        sd, pull_cfg = jax.vjp(to_sd, params)
        # install the TRACED guiding table for this trace (same fix as
        # Integrator._get_jit, 2026-08-20): preprocess_secondary_edges
        # between steps updates table VALUES without retracing, and a
        # table appearing retraces via the jit dispatch on its structure
        prev = getattr(integrator, "warpper", None)
        if prev is not None and warp is not None:
            integrator.warpper = {**prev, sensor_id: warp}
        try:
            loss, sd_bar, image = fused_loss_grad_sharded(
                integrator, sd, opts, sensor_id, seed, pixel_loss,
                pix_shard, axis,
            )
        finally:
            if prev is not None and warp is not None:
                integrator.warpper = prev
        (p_bar,) = pull_cfg(sd_bar)
        return loss, p_bar, image

    def _make_sharded():
        return jax.jit(shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(), P(axis), P()),
            out_specs=(P(), P(), P(axis, None)),
            check_vma=False,
        ))

    # keyed on the scene's Morton-permutation version: refresh_tri_perm
    # bakes a new static triangle ordering, which a cached trace would
    # silently keep using (Scene.refresh_tri_perm docstring)
    cache = {}
    pix = jax.device_put(
        jnp.arange(n_pix, dtype=jnp.int32), NamedSharding(mesh, P(axis))
    )

    def step(params, seed: int = -1):
        v = getattr(scene, "_perm_version", 0)
        if v not in cache:
            cache.clear()
            cache[v] = _make_sharded()
        s, _ = integrator._norm_args(scene, seed, None, None)
        warp = getattr(integrator, "warpper", {}).get(sensor_id)
        return cache[v](params, warp, pix, jnp.uint32(s))

    return step


def train_step_example(scene, integrator, mesh: Mesh, param_get, param_set,
                       target, seed: int = 0, axis: str = "pix"):
    """One sharded loss+grad evaluation against a target image.

    ``param_get()`` -> pytree of parameters; ``param_set(params)`` writes
    them back onto the scene objects (the mutate-then-trace convention).
    """
    opts = scene.opts
    n_pix = opts.num_pixels
    n_dev = mesh.devices.size
    assert n_pix % n_dev == 0

    def loss_fn(params, pix, target_shard):
        param_set(params)
        sd = scene.configure_data(scene._active_sensors)
        if opts.sppe > 0 or opts.sppse > 0:
            # edge-sample lanes partitioned across the axis + psum'd image
            img = integrator.render_impl_sharded(
                sd, opts, 0, jnp.uint32(seed), pix, axis
            )
        else:
            img = integrator.render_impl(
                sd, opts, 0, jnp.uint32(seed), pix, "D"
            )
        return jnp.sum(jnp.square(img - target_shard))

    step = make_sharded_value_and_grad(loss_fn, mesh, axis)
    pix = jax.device_put(
        jnp.arange(n_pix, dtype=jnp.int32), NamedSharding(mesh, P(axis))
    )
    target = jax.device_put(
        jnp.asarray(target), NamedSharding(mesh, P(axis, None))
    )
    return step(param_get(), pix, target)
