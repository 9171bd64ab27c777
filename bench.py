"""Benchmark: Mrays/s forward+backward on the Cornell box, on one GPU.

Canonical workload (reference README.md:42-116 + BASELINE.json): cbox
512x512, spp=32, sppe=32, sppse=32, PathTracer(3) — one training step of an
inverse-rendering loop (L2 loss + gradient w.r.t. vertex positions of a
block + light radiance) with ALL three estimators (interior + primary-edge
+ secondary-edge boundary terms).

Headline value: the fused production step (``Integrator.loss_and_grad``,
integrator/fused.py) — one forward + one adjoint with zero recompute, the
cost structure of the reference's Dr.Jit tape backward (README.md:102-104).

Output: the headline JSON line is printed as soon as it is measured; each
optional section then re-prints the full accumulated JSON (a superset), so
the last line is always the most complete.  Every line names the platform,
``device_kind``, the device count and the card's power limit.  Optional
sections:
  * ``interior_only_mrays`` — fused step, interior estimator only,
  * ``jaxgrad_full_mrays`` — ``jax.grad`` of the ``renderD`` L2 loss
    (path-replay reverse path),
  * ``envmap128_guided_*`` / ``envmap128_meshgrad_*`` — BASELINE config #3
    (Microfacet bunny + envmap; needs the reference's tutorial assets,
    recorded under ``skipped`` when they are absent),
  * ``large_scene_*`` — 100k-triangle gallery renderC,
  * ``bvh_grad_*`` — gallery-class fused fwd+bwd step, all three
    estimators.
A wall-clock budget (PSDR_BENCH_BUDGET_S, default 2400 s from process
start) skips the remaining sections and sets ``"truncated": true``.  A
section that raises is recorded under ``errors`` and makes the run exit
nonzero.

Before any timing, two gates run on the card: the intersection kernel
against the blocked reference (chip_smoke.compare_hits), and the
cross-backend gradient oracle (tests/crosscheck.py: the same training step
on the card and on the CPU, identical sample set).  A gate failure prints
a JSON line recording it and exits 1 — the bench never times wrong
numbers.  Without a GPU the bench refuses to run.

Ray accounting per pixel:
  interior:   spp   * (1 + 2*depth)          camera + depth*(shadow+bounce)
  primary:    sppe  * 2 * (1 + 2*depth)      two detached Li per edge lane
  secondary:  sppse * 3                      visibility + opposite + camera

``vs_baseline`` is the fraction of an intersection roofline: the reference
publishes no numbers (BASELINE.md), so the roofline is the only defensible
denominator.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

WIDTH = HEIGHT = 512
SPP = SPPE = SPPSE = 32
DEPTH = 3
N_ITER = 3     # steps per timed block; 3 blocks, min of the block means
N_WARMUP = 3

# Published peaks by JAX's device_kind (NVIDIA H100 SXM data sheet: float32
# outside the tensor cores, HBM3 bandwidth).  A device not in the table is
# an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}

# Float operations of one Möller-Trumbore test (ops.intersect.mt_hit):
# two cross products (18), four dot products (20), the reciprocal (1),
# the edge vector (3), three scalings (3) and u + v (1).
MT_FLOPS = 46

_T_START = time.perf_counter()


def peak_rates(device_kind: str) -> dict:
    """Published peak rates of ``device_kind``; unknown devices raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak for device_kind {device_kind!r}; add it to "
            "bench.PEAKS with its source") from None


def intersect_roofline_mrays(device_kind: str, n_tris: int) -> float:
    """Rays/s (in millions) if every ray tested every triangle at the
    card's float32 peak — an intersection-only bound: a full step also
    carries shading and AD math, so vs_baseline understates how close the
    step is to its true floor."""
    return peak_rates(device_kind)["f32_flops"] / (n_tris * MT_FLOPS) / 1e6


def device_time_breakdown(xplane_path: str, window_ns: int, top: int = 15):
    """Reduce a ``jax.profiler`` trace to device metrics: the union of the
    kernel intervals on the GPU streams (busy time), the idle share of the
    host-timed ``window_ns``, and the ``top`` kernels by total time with
    their counts.  The streams are the device planes' lines named
    ``Stream ...``; derived lines (XLA Modules / XLA Ops) would double
    count."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    spans, per_op = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                cnt, tot = per_op.get(ev.name, (0, 0.0))
                per_op[ev.name] = (cnt + 1, tot + ev.duration_ns)
    if not spans:
        raise ValueError(f"no GPU stream events in {xplane_path}")
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ops = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "busy_ms": busy / 1e6, "window_ms": window_ns / 1e6,
        "idle_share": max(0.0, 1.0 - busy / window_ns),
        "kernels": len(spans),
        "top": [{"name": n[:120], "count": c, "ms": t / 1e6}
                for n, (c, t) in ops],
    }


def _left(budget_s):
    return budget_s - (time.perf_counter() - _T_START)


def _time_fn(fn, args_for):
    """Seconds per call: warm up (compile), then the min over three blocks
    of the block mean, every call ended by block_until_ready on all of its
    outputs."""
    import jax

    for i in range(N_WARMUP):
        jax.block_until_ready(fn(*args_for(i)))
    best = float("inf")
    for blk in range(3):
        t0 = time.perf_counter()
        for i in range(N_ITER):
            jax.block_until_ready(fn(*args_for(blk * N_ITER + i + N_WARMUP)))
        best = min(best, (time.perf_counter() - t0) / N_ITER)
    return best


def _setup(**kw):
    import psdr_jax as psdr
    from scenes import make_cbox

    sc = make_cbox(width=WIDTH, height=HEIGHT, **kw)
    sc.configure()
    integ = psdr.PathTracer(max_depth=DEPTH)
    return sc, integ, sc.meshes[-1], sc.emitters[0]


def _fused_step_time(sc, integ, mesh, em, res, warp=None):
    """Time one jitted fused training step w.r.t. ``mesh`` vertices and,
    unless ``em`` is None, ``em``'s radiance (a pytree for envmaps),
    against a random target."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    bv = mesh.vertex_positions_raw
    br = None if em is None else em.radiance
    # the target is a jit ARGUMENT: a closed-over constant gets sunk into
    # every chunk iteration by XLA; real training targets are arrays
    target = jnp.asarray(
        np.random.default_rng(0).random((res * res, 3)), jnp.float32)

    def apply(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        if em is not None:
            em.radiance = jax.tree_util.tree_map(jnp.add, br, dr)

    def step(p, s, tgt, w):
        def ploss(rows, pix):
            return jnp.sum(jnp.square(rows - tgt[pix]), axis=-1)
        # the guiding table rides as a jit ARGUMENT (integrator/fused.py)
        return integ.loss_and_grad(sc, p, apply, ploss, seed=s, warp=w)[:2]

    fn = jax.jit(step)
    p0 = (jnp.zeros_like(bv), jax.tree_util.tree_map(jnp.zeros_like, br))
    dt = _time_fn(fn, lambda i: (p0, jnp.uint32(i), target, warp))
    # tracing left tracers on the mutable scene objects
    mesh.vertex_positions_raw = bv
    if em is not None:
        em.radiance = br
    return dt


def _rays_per_pixel(spp, sppe, sppse, depth):
    return (spp * (1 + 2 * depth) + sppe * 2 * (1 + 2 * depth)
            + sppse * 3)


def _headline(out, kind):
    sc, integ, mesh, em = _setup(spp=SPP, sppe=SPPE, sppse=SPPSE)
    n_tris = sum(m.num_faces for m in sc.meshes)
    rays = WIDTH * HEIGHT * _rays_per_pixel(SPP, SPPE, SPPSE, DEPTH)
    dt = _fused_step_time(sc, integ, mesh, em, WIDTH)
    mrays = rays / dt / 1e6
    out["metric"] = "cbox512_spp32_sppe32_sppse32_depth3_fwdbwd"
    out["value"] = mrays
    out["unit"] = "Mrays/s"
    out["ms_step"] = 1e3 * dt
    out["vs_baseline"] = mrays / intersect_roofline_mrays(kind, n_tris)
    out["_scene"] = (sc, mesh, em)


def _sec_interior(out, kind):
    sc, integ, mesh, em = _setup(spp=SPP)
    n_tris = sum(m.num_faces for m in sc.meshes)
    rays = WIDTH * HEIGHT * SPP * (1 + 2 * DEPTH)
    dt = _fused_step_time(sc, integ, mesh, em, WIDTH)
    out["interior_only_mrays"] = rays / dt / 1e6
    out["interior_vs_baseline"] = (
        rays / dt / 1e6 / intersect_roofline_mrays(kind, n_tris))


def _sec_jaxgrad(out, kind):
    import jax
    import jax.numpy as jnp
    import psdr_jax as psdr

    sc, mesh, em = out["_scene"]
    integ = psdr.PathTracer(max_depth=DEPTH)
    bv, br = mesh.vertex_positions_raw, em.radiance

    def loss_fn(dv, dr, seed):
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr
        img = integ.renderD(sc, 0, seed=seed)
        return jnp.sum(jnp.square(img))

    grad_fn = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))
    zv, zr = jnp.zeros_like(bv), jnp.zeros_like(br)
    dt = _time_fn(grad_fn, lambda i: (zv, zr, jnp.uint32(i)))
    mesh.vertex_positions_raw = bv
    em.radiance = br
    rays = WIDTH * HEIGHT * _rays_per_pixel(SPP, SPPE, SPPSE, DEPTH)
    out["jaxgrad_full_mrays"] = rays / dt / 1e6


class _Skipped(Exception):
    """A section whose inputs are absent; recorded under ``skipped``."""


def _envmap(out, prefix, mesh_grad_only):
    """BASELINE config #3: Microfacet bunny (4968 tris) under the 1k
    ballroom envmap, all three estimators with 3D-guided secondary edges.
    ``mesh_grad_only``: the reference-parity variant (the reference's
    envmap tutorial never differentiates the radiance table)."""
    import psdr_jax as psdr
    from scenes import make_bunny_envmap

    res = 128
    try:
        sc = make_bunny_envmap(width=res, height=res, spp=SPP, sppe=SPPE,
                               sppse=SPPSE)
    except FileNotFoundError as e:
        raise _Skipped(f"reference tutorial assets: {e}") from None
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    integ.preprocess_secondary_edges(sc, 0, [2000, 5, 5, 32], 1)
    em = None if mesh_grad_only else sc.emitter_env
    dt = _fused_step_time(sc, integ, sc.meshes[0], em, res,
                          integ.warpper.get(0))
    rays = res * res * _rays_per_pixel(SPP, SPPE, SPPSE, 1)
    out[f"{prefix}_ms_step"] = 1e3 * dt
    out[f"{prefix}_mrays"] = rays / dt / 1e6


def _sec_envmap(out, kind):
    _envmap(out, "envmap128_guided", mesh_grad_only=False)


def _sec_envmap_meshgrad(out, kind):
    _envmap(out, "envmap128_meshgrad", mesh_grad_only=True)


def _sec_large(out, kind):
    """End-to-end 100k-triangle render (gallery of icospheres), renderC."""
    import jax
    import psdr_jax as psdr
    from scenes import make_gallery

    res, spp, depth = 256, 4, 2
    sc = make_gallery(width=res, height=res, spp=spp)
    sc.configure()
    integ = psdr.PathTracer(max_depth=depth)
    sd = jax.lax.stop_gradient(sc.data)
    fn = jax.jit(lambda sd_, s: integ.render_impl(sd_, sc.opts, 0, s, None,
                                                  "C"))
    dt = _time_fn(lambda s: fn(sd, s), lambda i: (jax.numpy.uint32(i),))
    out["large_scene_tris"] = sum(m.num_faces for m in sc.meshes)
    out["large_scene_ms_frame"] = 1e3 * dt
    out["large_scene_mrays"] = res * res * spp * (1 + 2 * depth) / dt / 1e6


def _sec_bvh_grad(out, kind):
    """Gallery-class fused fwd+bwd step with all three estimators (the
    BASELINE config #5 workload shape at > 4096 triangles): gradient
    w.r.t. one edge-enabled sphere's vertices + the light radiance."""
    import psdr_jax as psdr
    from scenes import make_gallery

    res, spp, depth = 256, 4, 2
    sc = make_gallery(width=res, height=res, spp=spp, sppe=spp, sppse=spp,
                      edge_spheres=1)
    sc.configure()
    integ = psdr.PathTracer(max_depth=depth)
    dt = _fused_step_time(sc, integ, sc.meshes[6], sc.emitters[0], res)
    out["bvh_grad_tris"] = sum(m.num_faces for m in sc.meshes)
    out["bvh_grad_ms_step"] = 1e3 * dt
    out["bvh_grad_mrays"] = (res * res * _rays_per_pixel(spp, spp, spp, depth)
                             / dt / 1e6)


def _kernel_gate():
    """The intersection kernel vs the blocked reference on the headline
    scene's camera and bounce rays (tolerance: chip_smoke.compare_hits)."""
    import jax
    from chip_smoke import camera_rays, compare_hits, ray_set, scene_tris
    from psdr_jax.ops.intersect import ray_intersect_detached
    from scenes import make_cbox

    sc = make_cbox(width=64, height=64)
    sc.configure()
    tri = scene_tris(sc)
    key = jax.random.PRNGKey(1)
    ray, active = ray_set(tri, *camera_rays(sc, 1 << 16, key), key)
    return compare_hits(
        ray_intersect_detached(*tri, ray, active, backend="pallas"),
        ray_intersect_detached(*tri, ray, active, backend="brute"))


def _oracle_gate():
    """Cross-backend gradient oracle: the card vs the CPU child."""
    import tempfile
    import crosscheck

    path = os.path.join(tempfile.mkdtemp(prefix="psdr_oracle_"), "cpu.npz")
    proc = crosscheck.start_cpu_child(path)
    card = crosscheck.compute_beside(proc)
    rel = crosscheck.compare(crosscheck.finish_cpu_child(proc, path), card)
    assert crosscheck.within_tolerance(rel), rel
    return rel


def _emit(out):
    clean = {k: v for k, v in out.items() if not k.startswith("_")}
    print(json.dumps(clean), flush=True)


def main():
    # the jax.grad section uses the path-replay backward, the recommended
    # reverse-mode configuration (integrator/base.py REMAT_MODE)
    os.environ.setdefault("PSDR_REMAT", "prb")
    for p in (HERE, os.path.join(HERE, "tests")):
        sys.path.insert(0, p)
    import jax
    from chip_smoke import nvidia_smi_line

    budget_s = float(os.environ.get("PSDR_BENCH_BUDGET_S", "2400"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"bench: no GPU (JAX found {dev.platform})\n")
        return 2
    kind = dev.device_kind
    peak_rates(kind)  # an unknown card stops the bench before any timing
    out = {"platform": dev.platform, "device_kind": kind,
           "device_count": len(jax.devices()),
           "gpu_name_power_limit": nvidia_smi_line()}

    for name, gate in (("kernel_gate", _kernel_gate),
                       ("oracle", _oracle_gate)):
        try:
            rel = gate()
        except AssertionError as e:
            out[name] = f"FAILED: {e}"
            _emit(out)
            return 1
        out[name] = "ok"
        sys.stderr.write(f"{name} ok: {rel}\n")

    _headline(out, kind)
    _emit(out)

    failed = False
    for name, fn, min_s in (
        ("interior", _sec_interior, 120),
        ("jaxgrad", _sec_jaxgrad, 120),
        ("envmap", _sec_envmap, 240),
        ("bvh_grad", _sec_bvh_grad, 240),
        ("envmap_meshgrad", _sec_envmap_meshgrad, 240),
        ("large", _sec_large, 180),
    ):
        if _left(budget_s) < min_s:
            out["truncated"] = True
            sys.stderr.write(f"budget exhausted before section {name}\n")
            _emit(out)
            break
        try:
            fn(out, kind)
        except _Skipped as e:
            out.setdefault("skipped", []).append(f"{name}: {e}")
        except Exception as e:  # noqa: BLE001 recorded; the run fails
            failed = True
            out.setdefault("errors", []).append(f"{name}: {e!r}")
            sys.stderr.write(f"section {name} failed: {e!r}\n")
        _emit(out)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
