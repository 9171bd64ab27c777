"""Secondary-edge (visibility) boundary term shared by PathTracer and Direct
(reference: src/integrator/path.cpp:130-294; duplicated in direct.cpp:135-297).

The estimator samples a point p0 on a silhouette-candidate edge and a point
p2 on an emitter, completes the boundary segment by tracing p0 -> -dir to the
receiver p1, projects p1 to the sensor, and accumulates

    f(p1) * Le(p2) * base_v * W_e / pdf  *  dot(n, u2)

where only ``dot(n, u2)`` (the normal velocity of the edge point, computed by
differentiably re-intersecting the shadow ray with the emitter triangle)
carries derivatives; everything else is detached (path.cpp:171-270).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.types import Ray, EPSILON, SHADOW_EPSILON
from ..core.math import (
    normalize, norm, cross, dot, safe_div, bilinear, ray_intersect_triangle,
    scrub_nonfinite,
)
from ..core.sampler import Sampler
from ..core.distribution import HyperCubeDistribution
from ..ops.gather import gather_rows
from ..scene.scene import SceneData


def eval_secondary_edge(sd: SceneData, sensor, sample3, diff: bool,
                        u_coin=None, u_coin_emitter=None):
    """Returns (pixel_idx, value).

    ``diff=True``: value is derivative-only (``result - detach(result)``).
    ``diff=False``: value is the detached guiding integrand (no normal
    velocity factor), used by ``preprocess_secondary_edges``.
    ``u_coin``/``u_coin_emitter``: alias coins for the edge / envmap
    tables (DiscreteDistribution ``needs_coin``).
    """
    bss = sd.sample_boundary_segment_direct(sample3, u_coin=u_coin,
                                            u_coin_emitter=u_coin_emitter)
    valid = bss.is_valid

    _p0 = jax.lax.stop_gradient(bss.p0)
    _p2 = bss.p2
    _dir = normalize(_p2 - _p0)

    sd_det = jax.lax.stop_gradient(sd)

    from .base import se_pair_enabled

    if se_pair_enabled(sd_det):
        # BVH scenes: the emitter-visibility ray (p0, dir) and the
        # receiver ray (p0, -dir) are geometrically independent, so run
        # them as ONE double-width intersect and split — per-call BVH
        # machinery (sorts, tile culling, fetch lists) amortizes exactly
        # like the PE pair batching (same routing predicate).  The
        # receiver half runs under the PRE-emitter-cull mask (wider than
        # the sequential path's); every extra lane it computes is masked
        # by the identical validity chain below, so results are unchanged.
        n_lanes = valid.shape[0]
        ray2 = Ray(
            jnp.concatenate([_p0, _p0]),
            jnp.concatenate([_dir, -_dir]),
        )
        its_2w = sd_det.ray_intersect(
            ray2, jnp.concatenate([valid, valid]), mode="path", diff=False
        )
        _its2 = jax.tree_util.tree_map(lambda a: a[:n_lanes], its_2w)
        _its1 = jax.tree_util.tree_map(lambda a: a[n_lanes:], its_2w)
        valid = (
            valid
            & sd_det.is_emitter(_its2, valid)
            & _its2.valid
            & (norm(_its2.p - _p2) < SHADOW_EPSILON)
        )
        valid = valid & _its1.valid
    else:
        # visibility p0 -> p2 must reach the emitter point
        # (path.cpp:186-191)
        _its2 = sd_det.ray_intersect(
            Ray(_p0, _dir), valid, mode="path", diff=False
        )
        valid = (
            valid
            & sd_det.is_emitter(_its2, valid)
            & _its2.valid
            & (norm(_its2.p - _p2) < SHADOW_EPSILON)
        )

        # opposite ray finds the receiver p1 (path.cpp:194-196)
        _its1 = sd_det.ray_intersect(
            Ray(_p0, -_dir), valid, mode="path", diff=False
        )
        valid = valid & _its1.valid
    _p1 = _its1.p

    # project p1 to the image plane (path.cpp:199)
    sds = sensor.sample_direct(_p1)
    valid = valid & sds.is_valid

    # differentiable camera ray toward that pixel (path.cpp:203-215)
    if diff:
        camera_ray = sensor.sample_primary_ray(sds.q, diff=True)
        its1 = sd.ray_intersect(camera_ray, valid, mode="solid", diff=True)
        valid = (
            valid
            & jax.lax.stop_gradient(its1.valid)
            & (norm(jax.lax.stop_gradient(its1.p) - _p1) < SHADOW_EPSILON)
        )
        valid = valid & (sd.bsdf_slot(jax.lax.stop_gradient(its1)) >= 0)
    else:
        camera_ray = sensor.sample_primary_ray(sds.q, diff=False)
        its1 = sd_det.ray_intersect(camera_ray, valid, mode="path", diff=False)
        valid = valid & its1.valid & (norm(its1.p - _p1) < SHADOW_EPSILON)
        valid = valid & (sd_det.bsdf_slot(its1) >= 0)

    # change of variables from edge-point to image sample (path.cpp:219-227)
    dist = norm(_p2 - _p1)
    cos2 = jnp.abs(dot(bss.n, -_dir))
    e = cross(bss.edge, _dir)
    sinphi = norm(e)
    proj = normalize(cross(e, bss.n))
    sinphi2 = norm(cross(_dir, proj))
    base_v = safe_div(_its1.t, dist) * safe_div(sinphi, sinphi2) * cos2
    valid = valid & (sinphi > EPSILON) & (sinphi2 > EPSILON)

    # BSDF at the receiver, with shading-normal asymmetry correction
    # (path.cpp:229-250)
    d0 = -jax.lax.stop_gradient(camera_ray.d)
    d0_local = _its1.sh_frame.to_local(d0)
    bsdf_val = sd_det.eval_bsdf(_its1, d0_local, valid)
    correction = jnp.abs(
        safe_div(
            _its1.wi[..., 2] * dot(d0, _its1.n),
            d0_local[..., 2] * dot(_dir, _its1.n),
        )
    )
    bsdf_val = bsdf_val * correction[..., None]

    le = sd_det.Le(_its2, valid)
    value0 = bsdf_val * le * (
        base_v * sds.sensor_val * safe_div(1.0, bss.pdf)
    )[..., None]
    value0 = jnp.where(valid[..., None], value0, 0.0)

    if not diff:
        return jnp.full(valid.shape, -1, jnp.int32), value0

    # orientation sign + differentiable normal velocity (path.cpp:253-265)
    # drjit's sign is copysign-based (+-1 at an exactly-zero dot product);
    # jnp.sign would return 0 there and silently drop the lane
    n = normalize(cross(bss.n, proj))
    _sgn1 = jnp.where(dot(e, bss.edge2) >= 0.0, 1.0, -1.0)
    _sgn2 = jnp.where(dot(e, n) >= 0.0, 1.0, -1.0)
    sgn = _sgn1 * _sgn2
    value0 = value0 * sgn[..., None]

    # Only dot(n, u2) below carries derivatives; value0 and the validity
    # mask are pure values in the backward.  Save them (13 B/lane) so the
    # chunk-remat backward drops the three detached intersections, the
    # receiver BSDF eval and Le entirely (dead once their consumers are
    # saved) instead of re-running them.
    from jax.ad_checkpoint import checkpoint_name
    value0 = checkpoint_name(jax.lax.stop_gradient(value0), "psdr_saved")
    valid = checkpoint_name(valid, "psdr_saved")

    tri_idx = jnp.maximum(_its2.tri_id, 0)
    # differentiable emitter-triangle data, one packed matmul-gather
    rows = gather_rows(
        jnp.concatenate([sd.tri.p0, sd.tri.e1, sd.tri.e2], axis=1), tri_idx
    )
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    shadow_ray = Ray(its1.p, normalize(bss.p0 - its1.p))
    uv, _ = ray_intersect_triangle(v0, e1, e2, shadow_ray)
    u2 = bilinear(
        jax.lax.stop_gradient(v0),
        jax.lax.stop_gradient(e1),
        jax.lax.stop_gradient(e2),
        uv,
    )
    result = jax.lax.stop_gradient(value0) * dot(n, u2)[..., None]
    result = jnp.where(valid[..., None], result, 0.0)
    result = result - jax.lax.stop_gradient(result)  # derivative-only
    idx = jnp.where(valid, sds.pixel_idx, -1)
    return idx, result


@functools.partial(jax.jit, static_argnums=(1, 6, 7))
def _guiding_round(sd, sensor_id, seed_val, base, unit, cell_idx,
                   num_cells: int, spp_cell: int):
    """One detached evaluation sweep of the guiding grid (path.cpp:130-168).

    Module-level and jitted ONCE per (grid shape, scene structure): the
    scene data is an argument pytree, so repeated preprocessing during an
    optimization loop does not recompile."""
    num_samples = cell_idx.shape[0]
    sampler = Sampler(seed_val, jnp.arange(num_samples, dtype=jnp.uint32))
    sample3 = (base + sampler.next_nd(3)) * unit
    se_coin = (sampler.next_1d()
               if sd.sec_edge_distrb.needs_coin else None)
    em_coin = (sampler.next_1d() if sd.emitter_coin_needed else None)
    _, value0 = eval_secondary_edge(
        sd, sd.sensors[sensor_id], sample3, diff=False,
        u_coin=se_coin, u_coin_emitter=em_coin,
    )
    value0 = scrub_nonfinite(value0)
    if spp_cell > 1:
        value0 = value0 / float(spp_cell)
    mass = jnp.max(value0, axis=-1)
    return jnp.zeros(num_cells, jnp.float32).at[cell_idx].add(mass)


class SecondaryEdgeMixin:
    """Adds guided secondary-edge rendering to an integrator."""

    def __init__(self):
        self.warpper = {}  # sensor_id -> HyperCubeDistribution (3D guiding)

    def preprocess_secondary_edges(self, scene, sensor_id: int, reso,
                                   nrounds: int = 1, seed: int = 0):
        """Build the 3D guiding table by evaluating the detached boundary
        integrand on a regular grid (path.cpp:130-168)."""
        assert nrounds > 0
        sd = jax.lax.stop_gradient(scene.data)
        reso = tuple(int(r) for r in reso)
        grid = reso[:3]
        spp_cell = reso[3]
        num_cells = grid[0] * grid[1] * grid[2]
        num_samples = num_cells * spp_cell

        # cell_coords depends only on the static res tuple — no need to
        # build (and eagerly cumsum) a uniform placeholder distribution
        cell_idx = jnp.arange(num_samples, dtype=jnp.int32) // spp_cell
        base = HyperCubeDistribution(res=grid, distrb=None).cell_coords(
            cell_idx).astype(jnp.float32)
        unit = 1.0 / jnp.asarray(grid, jnp.float32)

        # one module-level jitted function: scene data / grid arrays flow
        # in as ARGUMENTS, so the per-iteration preprocess of a guided
        # optimization loop (reference tutorial pattern) reuses one
        # compiled program instead of baking sd into a fresh closure and
        # recompiling every call (cold compiles run minutes)
        result = jnp.zeros(num_cells, jnp.float32)
        for j in range(nrounds):
            result = result + _guiding_round(
                sd, sensor_id, jnp.uint32(seed + j * 7919), base, unit,
                cell_idx, num_cells, spp_cell,
            )
        if nrounds > 1:
            result = result / float(nrounds)
        # concrete masses (this runs eagerly, outside any trace): attach
        # the alias table so guided SE sampling costs one row gather per
        # lane instead of a log2(cells) CDF search (core/distribution.py)
        self.warpper[sensor_id] = HyperCubeDistribution.init(
            grid, jax.device_get(result)
        ).with_alias()

    def render_secondary_edges(self, sd: SceneData, opts, sensor_id, seed,
                               lane_offset=None, lane_count=None,
                               lane_total=None, stack_dtype=None):
        """path.cpp:274-294; returns the derivative-only (n_pix, 3) image."""
        from .base import (STREAM_SECONDARY, _chunked_splat_sum,
                           edge_chunk_lanes, se_sort_enabled)

        n_samples = (opts.num_pixels * opts.sppse
                     if lane_count is None else lane_count)
        warp = self.warpper.get(sensor_id)
        do_sort = se_sort_enabled(sd)

        def draws(sampler):
            """The chunk's sampler consumption schedule (ONE definition so
            the liveness probe and the real body can never diverge)."""
            sample3 = sampler.next_nd(3)
            if warp is not None:
                w_coin = (sampler.next_1d() if warp.needs_coin else None)
                sample3, pdf0 = warp.sample_reuse(sample3, w_coin)
            else:
                pdf0 = None
            se_coin = (sampler.next_1d()
                       if sd.sec_edge_distrb.needs_coin else None)
            em_coin = (sampler.next_1d() if sd.emitter_coin_needed else None)
            return sample3, pdf0, se_coin, em_coin

        def chunk_vals(lane, active):
            if do_sort:
                # Wavefront compaction: most boundary samples are invalid,
                # and a kernel can only shed dead lanes by whole blocks.
                # Draws are pure functions of the lane id (counter-based
                # pcg4d), so a cheap detached probe of bss.is_valid in raw
                # order + ONE (key, lane, active) sort re-runs the body on
                # liveness-sorted lanes with bitwise-identical per-lane
                # values; the splat is scatter-by-pixel so result order is
                # irrelevant.
                sd_det = jax.lax.stop_gradient(sd)
                probe = Sampler(seed + jnp.uint32(STREAM_SECONDARY), lane)
                s3, _, sec, emc = draws(probe)
                bss = sd_det.sample_boundary_segment_direct(
                    s3, u_coin=sec, u_coin_emitter=emc
                )
                key = jnp.where(bss.is_valid & active, 0, 1).astype(
                    jnp.int32)
                _, lane, act_i = jax.lax.sort(
                    (key, lane, active.astype(jnp.int32)), num_keys=1
                )
                active = act_i > 0
            sampler = Sampler(seed + jnp.uint32(STREAM_SECONDARY), lane)
            sample3, pdf0, se_coin, em_coin = draws(sampler)
            if pdf0 is None:
                pdf0 = jnp.ones(lane.shape, jnp.float32)
            idx, value = eval_secondary_edge(
                sd, sd.sensors[sensor_id], sample3, diff=True,
                u_coin=se_coin, u_coin_emitter=em_coin,
            )
            value = jnp.where(
                (pdf0 > EPSILON)[..., None],
                safe_div(value, pdf0[..., None]), value,
            )
            if opts.sppse > 1:
                value = value / float(opts.sppse)
            return value, jnp.where(active, idx, -1)

        return _chunked_splat_sum(chunk_vals, n_samples, opts.num_pixels,
                                  lane_offset=lane_offset,
                                  lane_total=lane_total,
                                  stack_dtype=stack_dtype,
                                  chunk_lanes=edge_chunk_lanes(sd))
