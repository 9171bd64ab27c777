"""Integrator base: interior render loop + primary-edge boundary term
(reference: src/integrator/integrator.cpp).

``renderC`` computes the primal image; ``renderD`` additionally adds the
derivative-only boundary terms (``value - stop_gradient(value)``) so that
``jax.jvp``/``jax.grad`` of ``renderD`` produce the full path-space gradient
while its primal equals ``renderC``.

Jitting strategy: each (integrator, render-kind, options, scene-treedef)
combination traces once; scene data flows as a pytree argument so parameter
updates never retrigger compilation.
"""

from __future__ import annotations

import functools
import os as _os
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.types import Ray, RenderOption
from ..core.object import Object
from ..core.sampler import Sampler
from ..core.math import scrub_nonfinite
from ..ops.image import splat_add, splat_add_derivative_only, interior_average
from ..ops.intersect import is_large_scene
from ..scene.scene import Scene, SceneData
from ..sensor.sensor import sample_primary_edge

# Sampler stream salts for the three independent estimators
# (reference: three Sampler instances, scene.cpp:52).
STREAM_INTERIOR = 0
STREAM_PRIMARY = 1
STREAM_SECONDARY = 2

# Primary-edge pass: evaluate Li(ray_n)‖Li(ray_p) as ONE double-width
# batch with common random numbers, vs two sequential calls matching the
# reference's draw order.  Routed per scene class ("auto"): large scenes
# (ops.intersect.is_large_scene) stack, small scenes run sequentially.
# The routing was tuned on the previous accelerator; on the H100 it is not
# measured yet.  PSDR_PE_STACK=0/1 forces one behavior for both classes.
_ps = _os.environ.get("PSDR_PE_STACK", "auto")
_PE_STACK = None if _ps == "auto" else (_ps != "0")


def pe_stack_enabled(sd) -> bool:
    """Whether the PE pass evaluates the ray pair double-width (see the
    _PE_STACK routing note above)."""
    if _PE_STACK is not None:
        return _PE_STACK
    return is_large_scene(sd)


# SE pass analogue: run the two independent detached intersections of
# eval_secondary_edge (p0 -> emitter visibility, p0 -> receiver) as ONE
# double-width call.  Same routing as the PE pair; not measured on the
# H100.
_sp = _os.environ.get("PSDR_SE_PAIR", "auto")
_SE_PAIR = None if _sp == "auto" else (_sp != "0")


def se_pair_enabled(sd) -> bool:
    if _SE_PAIR is not None:
        return _SE_PAIR
    return is_large_scene(sd)


# Liveness-sort the secondary-edge lanes before the expensive body, so
# that dead lanes gather into whole blocks (integrator/edge.py).  Per-lane
# draws are pure functions of the lane id, so the estimator is unchanged.
# Default OFF: it cost more than it saved on the previous accelerator;
# not measured on the H100.
_ss = _os.environ.get("PSDR_SE_SORT", "0")
_SE_SORT = None if _ss == "auto" else (_ss != "0")


def se_sort_enabled(sd) -> bool:
    if _SE_SORT is not None:
        return _SE_SORT
    return not is_large_scene(sd)

# Reverse-AD memory/recompute strategy for the interior bounce loop:
#   "chunk"  — jax.checkpoint around each lane chunk (recompute the whole
#              chunk, incl. intersections, in the backward sweep),
#   "bounce" — jax.checkpoint around each bounce (store bounce-boundary
#              states; recompute only within-bounce intermediates),
#   "none"   — store everything (XLA decides; needs the most HBM),
#   "prb"    — custom_vjp path-replay (integrator/prb.py): payloads saved,
#              zero re-intersections in the backward; reverse-mode only.
# "chunk" stays the default because forward-mode grad images (jax.jvp)
# cannot go through custom_vjp; reverse-mode loops may set PSDR_REMAT=prb.
# The modes' relative cost is not measured on the H100.
REMAT_MODE = _os.environ.get("PSDR_REMAT", "chunk")

# Remat policy for every jax.checkpoint in the render path: intermediates
# tagged checkpoint_name(x, "psdr_saved") — detached intersection payloads
# (scene.py ray_intersect) and detached edge radiances — are SAVED instead
# of recomputed.  Without this the backward sweep re-launches every
# intersection kernel and, in the edge passes, re-runs the two detached
# full-Li evaluations whose VALUES (delta_l) the boundary gradient needs.
# Saving them makes those whole subgraphs dead in the remat (DCE'd), at
# ~13 B/lane per intersection payload.
CHECKPOINT_POLICY = jax.checkpoint_policies.save_only_these_names(
    "psdr_saved"
)


def _remat(fn):
    return jax.checkpoint(fn, policy=CHECKPOINT_POLICY)

# Max sample lanes materialised at once inside one fused program.  Larger
# frames are processed as an in-jit loop over lane chunks: reverse-mode
# residuals for a full frame exceed device memory, and `jax.checkpoint`
# around each chunk bounds backward memory to one chunk's activations.
# The interior and edge passes have different working sets, so each gets
# its own knob, and large scenes (ops.intersect.is_large_scene) their own
# values (the ``*_BVH`` variables: the names date from the tile BVH that
# once served large scenes).  All values were tuned on the previous accelerator; on the H100
# they are not measured yet.
CHUNK_LANES = int(_os.environ.get("PSDR_CHUNK_LANES", 32 * 1024))
EDGE_CHUNK_LANES = int(
    _os.environ.get("PSDR_EDGE_CHUNK_LANES", 1 << 15)
)
# Edge-pass chunk size for large scenes.
EDGE_CHUNK_LANES_LARGE = int(
    _os.environ.get("PSDR_EDGE_CHUNK_BVH", 1 << 19)
)
# Interior chunk size for large scenes, bounded by the reverse-AD working
# set.
CHUNK_LANES_LARGE = int(_os.environ.get("PSDR_CHUNK_BVH", 1 << 18))
# Forward-only (never-differentiated) interior renders of large scenes have
# no reverse-AD working set, so they take bigger chunks still.
FWD_CHUNK_LANES_LARGE = int(_os.environ.get("PSDR_FWD_CHUNK_BVH", 1 << 20))


def _chunked_pixel_map(render_chunk, pix, spp: int, checkpoint: bool,
                       sd=None, diff: bool = True):
    """Map a per-pixel-chunk renderer over the pixel set, chunked in-jit.

    ``checkpoint``: wrap each chunk in ``jax.checkpoint`` so a reverse-AD
    sweep holds one chunk's residuals at a time.  Callers pass False only
    when the body bounds its own reverse-AD memory (the PRB custom_vjp
    chunk, or PathTracer's per-bounce remat) or when the primal is never
    differentiated — NOT merely because some other REMAT_MODE was
    requested: an integrator that cannot honour the requested mode must
    still fall back to chunk checkpointing, else a full-frame jax.grad
    stacks every chunk's residuals (= REMAT_MODE=none, which OOMs HBM).
    """
    n_pix = pix.shape[0]
    max_pix = _chunk_max_pix(spp, sd, diff)
    if n_pix <= max_pix:
        return render_chunk(pix)
    pix_chunks, _ = pad_pixel_chunks(pix, spp, sd, diff)
    body = _remat(render_chunk) if checkpoint else render_chunk
    out = jax.lax.map(body, pix_chunks)
    return out.reshape(pix_chunks.size, -1)[:n_pix]


def interior_chunk_lanes(sd, diff: bool = True) -> int:
    """Interior-pass chunk size routed on the scene's size (same
    predicate as :func:`edge_chunk_lanes`) and on whether the render is
    differentiated.  Chunking is partition-exact (global-lane RNG), so
    every regime produces bitwise-identical images."""
    if is_large_scene(sd):
        return CHUNK_LANES_LARGE if diff else FWD_CHUNK_LANES_LARGE
    return CHUNK_LANES


def _chunk_max_pix(spp: int, sd=None, diff: bool = True) -> int:
    return max(interior_chunk_lanes(sd, diff) // max(spp, 1), 1)


def pad_pixel_chunks(pix, spp: int, sd=None, diff: bool = True):
    """Zero-pad ``pix`` to a whole number of interior-chunk-sized chunks.

    ONE definition of the chunk geometry, shared by the remat render path
    above and the fused forward+adjoint scan (integrator/fused.py) — the
    two must never diverge in how they partition the pixel set (both route
    through :func:`interior_chunk_lanes` on the same ``sd``).  Returns
    ``(pix_chunks (k, max_pix), row_valid (k, max_pix))``; pad rows render
    pixel 0 and must be masked out by the caller's reduction.
    """
    n_pix = pix.shape[0]
    max_pix = _chunk_max_pix(spp, sd, diff)
    k = -(-n_pix // max_pix)
    n_pad = k * max_pix
    pix_chunks = jnp.concatenate(
        [pix, jnp.zeros((n_pad - n_pix,), pix.dtype)]
    ).reshape(k, max_pix)
    row_valid = (jnp.arange(n_pad, dtype=jnp.int32) < n_pix).reshape(
        k, max_pix
    )
    return pix_chunks, row_valid


def shard_lane_window(total: int, n_dev, idx):
    """ONE definition of the per-device edge-lane partition (ceil-divide
    windows): ``(lane_offset, lane_count)`` for device ``idx`` of
    ``n_dev``.  Shared by render_impl_sharded and the fused sharded
    pullback (integrator/fused.py) — the sharded forward render and the
    sharded fused step must window the global lane space identically."""
    per = -(-total // n_dev)
    return idx * per, per


def edge_chunk_lanes(sd) -> int:
    """Edge-pass chunk size routed on the scene's size (see
    EDGE_CHUNK_LANES[_LARGE] above)."""
    if is_large_scene(sd):
        return EDGE_CHUNK_LANES_LARGE
    return EDGE_CHUNK_LANES


def _chunked_splat_sum(chunk_vals, n_samples: int, n_pix: int,
                       lane_offset=None, lane_total: int = None,
                       stack_dtype=None, chunk_lanes: int = None):
    """Splat edge-sample chunks into an (n_pix, 3) image.

    ``chunk_vals(lane_chunk, active)`` -> ``(values (chunk, 3), idx (chunk,))``
    with ``idx = -1`` for dropped lanes.  Chunks are rematerialised in the
    backward pass (checkpoint) so edge-pass gradients never hold more than
    one chunk of residuals; all chunks' values are collected and splatted
    with ONE scatter-add at the end, not one per chunk.

    ``lane_offset``/``lane_total``: process the lane window
    [offset, offset + n_samples) of a global lane space of size
    ``lane_total`` (used to partition edge lanes across devices; the offset
    may be traced, the count must be static).

    ``stack_dtype``: dtype of the stacked value array (None = keep f32).
    The fused reverse path passes bf16: the values' PRIMAL is ignored
    (derivative-only splat) and the reverse-mode cotangent is already
    bf16-rounded by the rows_bf16 adjoint table, so stacking in bf16 is
    numerically free — it halves the stack's HBM traffic and lets the
    bf16 ct flow into the backward scan without a standalone 8M-row
    convert (ops/image._gather_ct).  Never set it on the jvp/forward-mode
    path: there the stack carries the REAL tangents and would round them.
    """
    if lane_total is None:
        lane_total = n_samples
    if stack_dtype is not None:
        inner = chunk_vals

        def chunk_vals(lane, active):  # noqa: F811
            v, i = inner(lane, active)
            return v.astype(stack_dtype), i

    off = jnp.uint32(0) if lane_offset is None else jnp.asarray(
        lane_offset, jnp.uint32
    )
    ecl = EDGE_CHUNK_LANES if chunk_lanes is None else chunk_lanes
    if n_samples <= ecl:
        lanes = off + jnp.arange(n_samples, dtype=jnp.uint32)
        values, idx = chunk_vals(lanes, lanes < jnp.uint32(lane_total))
        return splat_add_derivative_only(values, idx, n_pix)
    k = -(-n_samples // ecl)
    n_pad = k * ecl
    lanes = off + jnp.arange(n_pad, dtype=jnp.uint32).reshape(k, ecl)
    mask = (lanes < jnp.uint32(lane_total)) & (
        jnp.arange(n_pad, dtype=jnp.uint32).reshape(k, ecl)
        < jnp.uint32(n_samples)
    )
    # edge chunks always remat unless explicitly disabled: without the
    # checkpoint, the scan stacks every chunk's residuals (OOM at full frame)
    body = chunk_vals if REMAT_MODE == "none" else _remat(chunk_vals)

    def scan_body(carry, xs):
        return carry, body(xs[0], xs[1])

    _, (values, idx) = jax.lax.scan(scan_body, 0, (lanes, mask))
    # splat the STACKED (k, chunk, 3) values directly, without a
    # flattening relayout (see ops/image.splat_add)
    return splat_add_derivative_only(values, idx, n_pix)


def _opts_key(opts: RenderOption):
    return (opts.width, opts.height, opts.spp, opts.sppe, opts.sppse)


def interior_lane_setup(width: int, height: int, spp: int, seed, pix_chunk):
    """Global-sample-index lanes, interior-stream sampler and jittered
    screen samples for one pixel chunk.

    The global sample index (``pixel_id * spp + s``) is the batch_pix seed
    contract (reference integrator.cpp:23-30): any pixel partition
    reproduces the full-frame sample set exactly.  ONE definition, shared
    by the remat render path (``interior_chunk``) and the path-replay
    custom_vjp forward (integrator/prb.py) — the prb backward replays the
    exact sampler schedule of the forward, so these must never diverge.
    """
    m = pix_chunk.shape[0]
    sample_pix = jnp.repeat(pix_chunk, spp)
    lane = sample_pix.astype(jnp.uint32) * jnp.uint32(spp) + jnp.tile(
        jnp.arange(spp, dtype=jnp.uint32), m
    )
    sampler = Sampler(seed + jnp.uint32(STREAM_INTERIOR), lane)
    x = (sample_pix % width).astype(jnp.float32)
    y = (sample_pix // width).astype(jnp.float32)
    base = jnp.stack([x, y], axis=-1)
    samples = (base + sampler.next_2d()) / jnp.asarray(
        [width, height], jnp.float32
    )
    return m, sampler, samples


def interior_chunk(integrator, sd, opts, sensor_id: int, seed, spp: int,
                   diff: bool, pix_chunk):
    """Render one pixel chunk of the interior estimator -> (m, 3) rows.

    Shared by the remat render path (`_render_interior`) and the fused
    forward+adjoint step (integrator/fused.py).  The global sample index
    makes any pixel partition reproduce the full-frame sample set exactly
    (batch_pix contract, reference psdr.cpp:420-421)."""
    sensor = sd.sensors[sensor_id]
    m, sampler, samples = interior_lane_setup(
        opts.width, opts.height, spp, seed, pix_chunk
    )
    ray = sensor.sample_primary_ray(samples, diff=diff)
    active = jnp.ones((m * spp,), bool)
    value = integrator.Li(sd, sampler, ray, active, diff)
    value = scrub_nonfinite(value)
    return interior_average(value, m, spp)


class Integrator(Object):
    """Base class; subclasses implement Li (and optionally secondary edges)."""

    def __init__(self):
        self._jit_cache = {}

    # -- subclass interface --------------------------------------------------
    def Li(self, sd: SceneData, sampler: Sampler, ray: Ray, active,
           diff: bool):
        raise NotImplementedError

    def render_secondary_edges(self, sd, opts, sensor_id, seed,
                               lane_offset=None, lane_count=None,
                               lane_total=None, stack_dtype=None):
        """Return the derivative-only (n_pix, 3) boundary image, or None."""
        return None

    # -- public API (psdr.cpp:420-421) ----------------------------------------
    @staticmethod
    def _norm_args(scene, seed, pix_id, batch_pix):
        """Reference argument conventions (psdr.cpp:420-421): ``seed=-1``
        means use the scene seed; ``batch_pix`` is the crop-id array (or -1
        for full frame)."""
        if seed is not None:
            try:
                seed = int(seed)  # numpy/jnp scalars too, so negatives don't
            except TypeError:     # wrap silently through jnp.uint32
                pass
        if seed is None or (isinstance(seed, int) and seed < 0):
            seed = scene.seed
        if pix_id is None and batch_pix is not None and not (
            isinstance(batch_pix, int) and batch_pix < 0
        ):
            pix_id = batch_pix
        return seed, pix_id

    def renderC(self, scene: Scene, sensor_id: int = 0, seed: int = -1,
                pix_id=None, batch_pix=None):
        """Primal render (reference Integrator::renderC)."""
        from ..utils.profiling import log_time

        seed, pix_id = self._norm_args(scene, seed, pix_id, batch_pix)
        sd = jax.lax.stop_gradient(scene.data)
        fn = self._get_jit("C", _opts_key(scene.opts), sensor_id,
                           pix_id is not None)
        with log_time("Rendered", scene.opts.log_level > 0):
            out = fn(sd, self._warp_arg("C", sensor_id), jnp.uint32(seed),
                     pix_id)
            if scene.opts.log_level > 0:
                jax.block_until_ready(out)
        return out

    def renderD(self, scene: Scene, sensor_id: int = 0, seed: int = -1,
                pix_id=None, batch_pix=None):
        """Differentiable render: interior + boundary terms
        (reference Integrator::renderD).

        Re-runs the traced scene compile so gradients flow from the image to
        every scene parameter currently set on the python scene objects.
        """
        from ..utils.profiling import log_time

        seed, pix_id = self._norm_args(scene, seed, pix_id, batch_pix)
        sd = scene.configure_data(scene._active_sensors)
        fn = self._get_jit("D", _opts_key(scene.opts), sensor_id,
                           pix_id is not None)
        with log_time("Rendered", scene.opts.log_level > 0):
            out = fn(sd, self._warp_arg("D", sensor_id), jnp.uint32(seed),
                     pix_id)
            if scene.opts.log_level > 0:
                jax.block_until_ready(out)
        return out

    def loss_and_grad(self, scene: Scene, params, apply_params, pixel_loss,
                      sensor_id: int = 0, seed: int = -1, **kw):
        """Fused single-pass training step for pixel-local losses:
        ``(loss, param_grads, image)`` with one forward + one adjoint and
        zero rematerialization (integrator/fused.py; the counterpart of the
        reference's tape backward, README.md:102-104).  ``warp=``: thread
        the secondary-edge guiding table through a user jit (see
        integrator/fused.py — tracing with an implicit table raises)."""
        from .fused import loss_and_grad as _fused

        return _fused(self, scene, params, apply_params, pixel_loss,
                      sensor_id, seed, **kw)

    # -- machinery -------------------------------------------------------------
    def _get_jit(self, kind: str, opts_key, sensor_id: int, has_pix: bool):
        cache_key = (kind, opts_key, sensor_id, has_pix)
        if cache_key not in self._jit_cache:
            opts = RenderOption(
                width=opts_key[0], height=opts_key[1], spp=opts_key[2],
                sppe=opts_key[3], sppse=opts_key[4],
            )

            def run(sd, warp, seed, pix_id):
                # The secondary-edge guiding table flows in as a traced
                # ARGUMENT, temporarily installed over self.warpper for
                # the duration of this trace: a per-iteration
                # preprocess_secondary_edges updates table VALUES without
                # retracing, and a table appearing/changing shape retraces
                # automatically (jit keys on the pytree structure).
                # Reading self.warpper at trace time instead silently
                # froze the first-render table forever (found 2026-08-20).
                if warp is None or not hasattr(self, "warpper"):
                    return self.render_impl(sd, opts, sensor_id, seed,
                                            pix_id, kind)
                prev = self.warpper
                self.warpper = {**prev, sensor_id: warp}
                try:
                    return self.render_impl(sd, opts, sensor_id, seed,
                                            pix_id, kind)
                finally:
                    self.warpper = prev

            self._jit_cache[cache_key] = jax.jit(run)
        return self._jit_cache[cache_key]

    def _warp_arg(self, kind: str, sensor_id: int):
        """Current guiding table to pass into the jitted render (None for
        primal renders: the SE pass only runs when differentiating)."""
        if kind != "D":
            return None
        return getattr(self, "warpper", {}).get(sensor_id)

    def render_impl(self, sd: SceneData, opts: RenderOption, sensor_id: int,
                    seed, pix_id, kind: str):
        diff = kind == "D"
        result = self._render_interior(sd, opts, sensor_id, seed, pix_id, diff)

        def add_edges(result, edge_img):
            # edge estimators splat over the FULL pixel grid; a crop/shard
            # render takes its subset rows (exact: the edge sample set is
            # global and deterministic, so shards partition it consistently)
            if pix_id is not None:
                edge_img = edge_img[jnp.asarray(pix_id, jnp.int32)]
            return result + edge_img

        if diff and opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
            result = add_edges(
                result, self._render_primary_edges(sd, opts, sensor_id, seed)
            )
        if diff and opts.sppse > 0 and sd.sec_edge is not None:
            se = self.render_secondary_edges(sd, opts, sensor_id, seed)
            if se is not None:
                result = add_edges(result, se)
        return result

    # interior estimator (integrator.cpp:103-176)
    def _render_interior(self, sd, opts, sensor_id, seed, pix_id, diff: bool):
        if not diff:
            sd = jax.lax.stop_gradient(sd)
        if pix_id is None:
            n_pix = opts.num_pixels
            pix = jnp.arange(n_pix, dtype=jnp.int32)
        else:
            pix = jnp.asarray(pix_id, jnp.int32)
            n_pix = pix.shape[0]
        if opts.spp == 0:
            return jnp.zeros((n_pix, 3), jnp.float32)
        spp = opts.spp

        if diff and REMAT_MODE == "prb" and getattr(self, "supports_prb",
                                                    False):
            from .prb import make_prb_chunk

            prb_chunk = make_prb_chunk(self, opts, sensor_id, spp)
            return _chunked_pixel_map(
                lambda pix_chunk: prb_chunk(sd, jnp.asarray(seed, jnp.uint32),
                                            pix_chunk),
                pix, spp, checkpoint=False,  # custom_vjp replays itself
                sd=sd,
            )

        def render_chunk(pix_chunk):
            return interior_chunk(self, sd, opts, sensor_id, seed, spp, diff,
                                  pix_chunk)

        # Integrators that cannot honour the requested REMAT_MODE fall back
        # to chunk checkpointing: with PSDR_REMAT=prb (the documented
        # reverse-mode recommendation) a Direct/Collocated/Field renderD
        # must not silently lose its reverse-AD memory bound.
        bounce_remat = (REMAT_MODE == "bounce"
                        and getattr(self, "supports_bounce_remat", False))
        checkpoint = diff and REMAT_MODE != "none" and not bounce_remat
        return _chunked_pixel_map(render_chunk, pix, spp, checkpoint,
                                  sd=sd, diff=diff)

    def render_impl_sharded(self, sd: SceneData, opts: RenderOption,
                            sensor_id: int, seed, pix_shard, axis: str):
        """Per-device body for shard_map rendering: the interior term runs
        on this device's pixel shard, edge-sample lanes are partitioned
        across the mesh axis (each device does 1/n of the global edge
        queues) and the full-frame edge image is psum'd so every shard can
        take its pixel rows.  Exactly equal to the single-device render."""
        idx = jax.lax.axis_index(axis)
        n_dev = jax.lax.axis_size(axis)
        result = self._render_interior(
            sd, opts, sensor_id, seed, pix_shard, True
        )
        edge_img = jnp.zeros((opts.num_pixels, 3), jnp.float32)
        if opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
            total = opts.num_pixels * opts.sppe
            off, per = shard_lane_window(total, n_dev, idx)
            edge_img = edge_img + self._render_primary_edges(
                sd, opts, sensor_id, seed,
                lane_offset=off, lane_count=per, lane_total=total,
            )
        if opts.sppse > 0 and sd.sec_edge is not None:
            total = opts.num_pixels * opts.sppse
            off, per = shard_lane_window(total, n_dev, idx)
            se = self.render_secondary_edges(
                sd, opts, sensor_id, seed,
                lane_offset=off, lane_count=per, lane_total=total,
            )
            if se is not None:
                edge_img = edge_img + se
        edge_img = jax.lax.psum(edge_img, axis)
        return result + edge_img[jnp.asarray(pix_shard, jnp.int32)]

    # primary-edge boundary term (integrator.cpp:179-198)
    def _render_primary_edges(self, sd, opts, sensor_id, seed,
                              lane_offset=None, lane_count=None,
                              lane_total=None, stack_dtype=None):
        sensor = sd.sensors[sensor_id]
        n_samples = (opts.num_pixels * opts.sppe
                     if lane_count is None else lane_count)
        sd_det = jax.lax.stop_gradient(sd)
        from ..core.math import safe_div

        def chunk_vals(lane, active):
            sampler = Sampler(seed + jnp.uint32(STREAM_PRIMARY), lane)
            u1 = sampler.next_1d()
            pe_coin = (sampler.next_1d()
                       if sensor.edge_info.distrb.needs_coin else None)
            es = sample_primary_edge(sensor, u1, u_coin=pe_coin)
            valid = active & (es.idx >= 0)
            if pe_stack_enabled(sd_det):
                # ONE double-width Li over ray_n‖ray_p: halves the op count
                # of the pass's scan body (the tail is op-count-bound, not
                # flop-bound).  Both sides draw the same per-lane stream —
                # common random numbers, a variance REDUCTION for the
                # radiance difference (deviation from the reference's
                # sequential draws, integrator.cpp:185-186; expectation
                # unchanged).
                n = lane.shape[0]
                s2 = Sampler(seed + jnp.uint32(STREAM_PRIMARY),
                             jnp.concatenate([lane, lane]))
                s2.cnt = sampler.cnt
                ray2 = jax.tree_util.tree_map(
                    lambda a, b: jnp.concatenate([a, b]),
                    es.ray_n, es.ray_p,
                )
                li2 = self.Li(sd_det, s2, ray2,
                              jnp.concatenate([valid, valid]), diff=False)
                delta = li2[:n] - li2[n:]
            else:
                # sequential draws, matching the reference's Li(ray_n) then
                # Li(ray_p) sampler consumption (integrator.cpp:185-186)
                delta = (self.Li(sd_det, sampler, es.ray_n, valid, diff=False)
                         - self.Li(sd_det, sampler, es.ray_p, valid,
                                   diff=False))
            # The boundary gradient needs delta_l's VALUE only: save it
            # (12 B/lane) so the remat backward never re-runs the two full
            # detached Li evaluations (2*(1+2*depth) rays/lane).
            from jax.ad_checkpoint import checkpoint_name
            delta_l = checkpoint_name(
                jax.lax.stop_gradient(delta), "psdr_saved"
            )
            value = es.x_dot_n[..., None] * safe_div(
                delta_l, es.pdf[..., None]
            )
            value = scrub_nonfinite(value)
            if opts.sppe > 1:
                value = value / float(opts.sppe)
            value = value - jax.lax.stop_gradient(value)  # derivative-only
            value = jnp.where(valid[..., None], value, 0.0)
            return value, jnp.where(valid, es.idx, -1)

        return _chunked_splat_sum(chunk_vals, n_samples, opts.num_pixels,
                                  lane_offset=lane_offset,
                                  lane_total=lane_total,
                                  stack_dtype=stack_dtype,
                                  chunk_lanes=edge_chunk_lanes(sd))
