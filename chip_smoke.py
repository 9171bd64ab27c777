#!/usr/bin/env python3
"""On-card smoke run: the main path of psdr_jax on one NVIDIA GPU.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --four-cards    # the sharded path on four cards only

Phases, in order; any failure exits nonzero:

1. device — a GPU must be present (never carries on on the CPU); prints
   its kind, the device count and ``nvidia-smi``'s name and power limit;
2. kernel — the Triton intersection kernel vs the blocked reference
   (``ray_intersect_brute``) at real widths, plus their times;
3. numerics — the card-only tests (``pytest -m chip``): the exact one-hot
   gather, float32 matmul precision, the analytic gradient oracles and the
   cross-backend oracle (its CPU half in a child that opens no card);
4. main path — the README workload as a trainer (Cornell box 512x512,
   spp=sppe=sppse=32, PathTracer(3), L2 loss, gradients w.r.t. block
   vertices and emitter radiance) through ``Integrator.loss_and_grad``
   under ``optax.adam``; the headline step timed with the kernel and with
   ``PSDR_INTERSECT=brute`` in turns (the kernel's decision rule); then one
   forward-mode gradient image.

``--four-cards`` runs only the sharded fused step and ``render_sharded``
against their single-device counterparts.  The last line of standard
output is one JSON object: ``{"ok": true, "device": {...}}``.

``--rehearse`` runs every phase at a tiny size on whatever JAX finds (the
kernel through the Pallas interpreter) to check the control flow; it never
exits 0 and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.join(HERE, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

import psdr_jax as psdr  # noqa: E402  (sets the compile cache first)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# Kernel vs reference: ids agree on at least this share of rays; where they
# differ and both hit, |dt| <= T_REL * t; elsewhere t/u/v agree to T_REL
# relative (absolute below 1).  The arithmetic is float32 elementwise with
# no matmul; the slack covers fused multiply-adds and Triton's division.
ID_AGREE = 0.9999
T_REL = 1e-5

SIZE = {  # full size / --rehearse size
    "cbox_rays": ((32768, 1 << 20), (512, 1024)),
    "sphere": ((4, 1 << 20), (2, 1024)),         # (icosphere subdiv, rays)
    "gallery": ((80, 3, 1 << 18), (2, 1, 1024)),  # (spheres, subdiv, rays)
    "head": ((512, 32, 3), (32, 2, 2)),           # (width, spp, depth)
    "jvp": 256,
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def median_time(fn, reps: int):
    """Median seconds of ``reps`` calls, each ended by block_until_ready."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


# ---------------------------------------------------------------------------
# Phase 2: the kernel against the plain reference
# ---------------------------------------------------------------------------

def compare_hits(got, ref):
    """Check a kernel payload against the reference under the tolerance
    above.  Returns a dict of agreement statistics; raises AssertionError."""
    gi, gv, guv, gt = (np.asarray(x) for x in got)
    ri, rv, ruv, rt = (np.asarray(x) for x in ref)
    same = gi == ri
    agree = float(same.mean())
    both = ~same & gv & rv
    flips = int((~same & (gv != rv)).sum())
    hit = same & rv

    def rel(a, b):
        return np.abs(a - b) / np.maximum(np.abs(b), 1.0)

    t_diff = float(rel(gt[both], rt[both]).max(initial=0.0))
    t_err = float(rel(gt[hit], rt[hit]).max(initial=0.0))
    uv_err = float(rel(guv[hit], ruv[hit]).max(initial=0.0))
    stats = {"rays": int(gi.size), "hit_share": float(rv.mean()),
             "id_agree": agree, "hit_miss_flips": flips,
             "t_rel_where_ids_differ": t_diff, "t_rel": t_err,
             "uv_rel": uv_err}
    assert agree >= ID_AGREE, stats
    assert t_diff <= T_REL and t_err <= T_REL and uv_err <= T_REL, stats
    return stats


def _cosine_dirs(key, n):
    """Cosine-weighted directions about the rows of ``n`` (unit normals)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, n.shape[:1])
    u2 = jax.random.uniform(k2, n.shape[:1])
    r, phi = jnp.sqrt(u1), 2.0 * jnp.pi * u2
    a = jnp.where(jnp.abs(n[:, :1]) > 0.9, jnp.asarray([[0.0, 1.0, 0.0]]),
                  jnp.asarray([[1.0, 0.0, 0.0]]))
    t = a - n * jnp.sum(a * n, -1, keepdims=True)
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    b = jnp.cross(n, t)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    return ((r * jnp.cos(phi))[:, None] * t + (r * jnp.sin(phi))[:, None] * b
            + z[:, None] * n)


def bounce_rays(tri, o, d, key):
    """Cosine bounce rays from the reference's closest hits of (o, d), on
    the side each ray came from; misses become NaN rays."""
    from psdr_jax.ops.intersect import ray_intersect_brute

    tid, valid, _, t = ray_intersect_brute(tri[0], tri[1], tri[2], o, d)
    n = jnp.cross(tri[1], tri[2])[jnp.maximum(tid, 0)]
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
    p = o + d * jnp.where(valid, t, 0.0)[:, None]
    nd = _cosine_dirs(key, n)
    nan = jnp.float32(jnp.nan)
    return (jnp.where(valid[:, None], p, nan),
            jnp.where(valid[:, None], nd, nan))


def camera_rays(sc, n, key):
    sd = jax.lax.stop_gradient(sc.data)
    u = jax.random.uniform(key, (n, 2))
    ray = sd.sensors[0].sample_primary_ray(u, diff=False)
    return ray.o, ray.d


@jax.jit
def ray_set(tri, o, d, key):
    """Half primary, half bounce rays; 1/16 of the lanes inactive and a few
    lanes NaN, like the integrators' ray sets.  Jitted: run eagerly, every
    primitive would compile on its own."""
    from psdr_jax.core.types import Ray

    n = o.shape[0]
    h = n // 2
    k1, k2 = jax.random.split(key)
    bo, bd = bounce_rays(tri, o[h:], d[h:], k1)
    o = jnp.concatenate([o[:h], bo])
    d = jnp.concatenate([d[:h], bd])
    o = o.at[::997].set(jnp.nan)
    active = jax.random.uniform(k2, (n,)) >= 1.0 / 16.0
    return Ray(o, d), active


def scene_tris(sc):
    tri = jax.lax.stop_gradient(sc.data).tri
    return tri.p0, tri.e1, tri.e2


def sphere_case(subdiv, n, key):
    """A closed icosphere mesh; rays from outside aimed into it."""
    from scenes import _icosphere

    v, f = _icosphere(subdiv)
    v = jnp.asarray(v)
    f = jnp.asarray(f)
    p0 = v[f[:, 0]]
    tri = (p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0)
    k1, k2 = jax.random.split(key)
    o = jax.random.normal(k1, (n, 3))
    o = 3.0 * o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    aim = 0.9 * jax.random.uniform(k2, (n, 3), minval=-1.0, maxval=1.0)
    d = aim - o
    return tri, o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def phase_kernel(rehearse: bool, interp: bool):
    from scenes import make_cbox, make_gallery
    from psdr_jax.ops.intersect import ray_intersect_detached

    s = 1 if rehearse else 0
    t0 = time.perf_counter()
    kernel_backend = "interpret" if interp else "pallas"
    key = jax.random.PRNGKey(0)
    cases = []
    cbox = make_cbox(width=64, height=64)
    cbox.configure()
    for n in SIZE["cbox_rays"][s]:
        key, k = jax.random.split(key)
        cases.append(("cbox", scene_tris(cbox), camera_rays(cbox, n, k)))
    subdiv, n = SIZE["sphere"][s]
    key, k = jax.random.split(key)
    tri, o, d = sphere_case(subdiv, n, k)
    cases.append(("sphere", tri, (o, d)))
    n_sph, sub, n = SIZE["gallery"][s]
    gal = make_gallery(width=64, height=64, n_spheres=n_sph, subdiv=sub)
    gal.configure()
    key, k = jax.random.split(key)
    cases.append(("gallery", scene_tris(gal), camera_rays(gal, n, k)))
    jax.block_until_ready(cases)
    log("kernel_scenes_s", time.perf_counter() - t0)

    for name, tri, (o, d) in cases:
        t0 = time.perf_counter()
        key, k = jax.random.split(key)
        ray, active = ray_set(tri, o, d, k)
        run = {
            b: jax.jit(lambda r, a, b=b: ray_intersect_detached(
                *tri, r, a, backend=b))
            for b in (kernel_backend, "brute")
        }
        got = jax.block_until_ready(run[kernel_backend](ray, active))
        ref = jax.block_until_ready(run["brute"](ray, active))
        stats = compare_hits(got, ref)
        line = {"case": name, "tris": int(tri[0].shape[0]), **stats,
                "setup_s": time.perf_counter() - t0}  # compiles included
        if not rehearse:
            reps = 5 if tri[0].shape[0] < 10000 else 3
            for b in run:
                med, _ = median_time(lambda b=b: run[b](ray, active), reps)
                line[f"ms_{b}"] = 1e3 * med
        log("kernel_vs_reference", json.dumps(line))


# ---------------------------------------------------------------------------
# Phase 3: numerics on the card
# ---------------------------------------------------------------------------

def phase_numerics(rehearse: bool):
    import pytest

    os.environ["PSDR_TEST_ON_CARD"] = "1"
    args = [os.path.join(HERE, "tests", "test_chip.py"), "-m", "chip",
            "-q", "-rA", "--durations=0", "-p", "no:cacheprovider",
            "-p", "no:randomly"]
    if rehearse:
        args += ["--co"]
    rc = pytest.main(args)
    assert rc == 0, f"card-only tests failed (pytest exit {rc})"


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def headline_problem(width, spp, depth):
    """The README trainer: scene, integrator, parameters and loss."""
    from scenes import make_cbox

    sc = make_cbox(width=width, height=width, spp=spp, sppe=spp, sppse=spp)
    sc.configure()
    integ = psdr.PathTracer(max_depth=depth)
    mesh, em = sc.meshes[-1], sc.emitters[0]
    return sc, integ, mesh, em


def make_step(sc, integ, mesh, em, bv, br):
    """``step(params, seed, target) -> (loss, grads)`` over offsets of the
    block's vertices and of the emitter radiance."""

    def apply(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def step(p, seed, target):
        def ploss(rows, pix):
            return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

        loss, grads, _ = integ.loss_and_grad(sc, p, apply, ploss, seed=seed)
        return loss, grads

    return step


def phase_main(rehearse: bool, interp: bool, power: str):
    import optax

    width, spp, depth = SIZE["head"][1 if rehearse else 0]
    sc, integ, mesh, em = headline_problem(width, spp, depth)
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jax.jit(lambda s: integ.renderC(sc, 0, seed=s))(jnp.uint32(1))
    em.radiance = br * 1.6   # start away from the truth
    br0 = em.radiance
    em.radiance = br
    step = make_step(sc, integ, mesh, em, bv, br)
    p0 = (jnp.zeros_like(bv), br0 - br)
    kernel_backend = "interpret" if interp else "pallas"

    lowered = {}
    for b in (kernel_backend, "brute"):
        os.environ["PSDR_INTERSECT"] = b  # read while tracing
        t0 = time.perf_counter()
        # a fresh lambda per backend: jit's trace cache keys on the function
        lowered[b] = jax.jit(lambda p, s, t: step(p, s, t)).lower(
            p0, jnp.uint32(0), target)
        log(f"lower[{b}]_s", time.perf_counter() - t0)
        mesh.vertex_positions_raw, em.radiance = bv, br  # drop tracers
    os.environ.pop("PSDR_INTERSECT")

    def compile_timed(b):
        t0 = time.perf_counter()
        exe = lowered[b].compile()
        return exe, time.perf_counter() - t0

    # the two compiles run side by side (XLA releases the GIL)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = dict(zip(lowered, pool.map(compile_timed, lowered)))
    compiled = {b: exe for b, (exe, _) in done.items()}
    for b, (_, secs) in done.items():
        log(f"compile[{b}]_s", secs, "(both compiled at once)")
    log("memory_analysis", compiled[kernel_backend].memory_analysis())

    # Adam toward the target rendered at the true radiance
    opt = optax.adam(1.0)
    params, state = p0, opt.init(p0)
    err = [float(jnp.linalg.norm(params[1]))]
    times = []
    for i in range(6 if not rehearse else 3):
        t0 = time.perf_counter()
        loss, grads = compiled[kernel_backend](params, jnp.uint32(10 + i),
                                               target)
        jax.block_until_ready((loss, grads))
        times.append(time.perf_counter() - t0)
        finite = bool(jnp.isfinite(loss)) and all(
            bool(jnp.isfinite(g).all()) for g in jax.tree_util.tree_leaves(
                grads))
        assert finite, f"step {i}: non-finite loss or gradient"
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        err.append(float(jnp.linalg.norm(params[1])))
        log(f"adam_step {i} loss {float(loss):.6g} radiance_err {err[-1]:.6g}")
    assert err[-1] < err[0], f"radiance error did not shrink: {err}"
    peak = jax.devices()[0].memory_stats()
    peak = None if peak is None else peak.get("peak_bytes_in_use")
    log("peak_bytes_in_use", peak)
    log("adam_step_ms", json.dumps([1e3 * t for t in times]),
        "median_steady_ms", 1e3 * float(np.median(times[1:])), "|", power)

    # the kernel's decision rule: the headline step with the kernel and
    # with the reference, in turns (brute, kernel, kernel, brute)
    meds = {kernel_backend: [], "brute": []}
    for b in ("brute", kernel_backend, kernel_backend, "brute"):
        med, _ = median_time(
            lambda b=b: compiled[b](p0, jnp.uint32(3), target),
            1 if rehearse else 5)
        meds[b].append(1e3 * med)
    log("headline_step_ms", json.dumps(meds), "|", power)

    # forward-mode gradient image (README example)
    w = SIZE["jvp"] if not rehearse else 16
    sc2 = __import__("scenes").make_cbox(width=w, height=w, spp=spp,
                                         sppe=spp, sppse=spp)
    sc2.configure()
    integ2 = psdr.PathTracer(max_depth=depth)
    m0 = sc2.param_map["Mesh[0]"]
    base = jnp.asarray(m0.to_world_raw)

    def render(tx):
        m0.to_world_raw = base.at[0, 3].add(tx)
        return integ2.renderD(sc2, 0, seed=0)

    t0 = time.perf_counter()
    img, dimg = jax.jit(lambda: jax.jvp(render, (jnp.float32(0.0),),
                                        (jnp.float32(1.0),)))()
    jax.block_until_ready(dimg)
    m0.to_world_raw = base
    dimg = np.asarray(dimg)
    log("jvp_image_s", time.perf_counter() - t0, "abs_sum",
        float(np.abs(dimg).sum()))
    assert np.isfinite(np.asarray(img)).all() and np.isfinite(dimg).all()
    assert np.abs(dimg).sum() > 0.0, "forward-mode gradient image is zero"


# ---------------------------------------------------------------------------
# --four-cards: the sharded path
# ---------------------------------------------------------------------------

def phase_four_cards(rehearse: bool):
    from psdr_jax.parallel import make_fused_train_step
    from psdr_jax.parallel.mesh import make_device_mesh, render_sharded

    assert len(jax.devices()) >= 4, "--four-cards needs four devices"
    width, spp, depth = SIZE["head"][1 if rehearse else 0]
    sc, integ, mesh, em = headline_problem(width, spp, depth)
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jnp.asarray(
        np.random.default_rng(0).random((width * width, 3)), jnp.float32)
    step = make_step(sc, integ, mesh, em, bv, br)
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
    dmesh = make_device_mesh(4)

    loss1, g1 = jax.jit(step)(p0, jnp.uint32(7), target)
    mesh.vertex_positions_raw, em.radiance = bv, br

    def apply(p):
        mesh.vertex_positions_raw = bv + p[0]
        em.radiance = br + p[1]

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    sharded = make_fused_train_step(sc, integ, dmesh, apply, ploss)
    loss4, g4, _ = sharded(p0, 7)
    mesh.vertex_positions_raw, em.radiance = bv, br
    rel_loss = abs(float(loss4) - float(loss1)) / abs(float(loss1))
    rel_grad = max(
        float(jnp.abs(a - b).sum() / (jnp.abs(b).sum() + 1e-30))
        for a, b in zip(jax.tree_util.tree_leaves(g4),
                        jax.tree_util.tree_leaves(g1)))
    log("fused_step_4_vs_1", json.dumps({"rel_loss": rel_loss,
                                         "rel_grad": rel_grad}))
    # scatter-adds run as atomics on the GPU: the summation order differs
    # between runs and partitions, so agreement is to a tolerance, not
    # bitwise as on the CPU
    assert rel_loss <= 1e-5 and rel_grad <= 1e-3, (rel_loss, rel_grad)

    single = np.asarray(integ.renderC(sc, 0, seed=3))
    quad = np.asarray(render_sharded(integ, sc, dmesh, sensor_id=0, seed=3))
    rel_img = float(np.abs(quad - single).sum() / np.abs(single).sum())
    log("render_sharded_4_vs_1", json.dumps({"rel_img": rel_img}))
    assert rel_img <= 1e-5, rel_img
    for dev in jax.devices()[:4]:
        stats = dev.memory_stats() or {}
        log("peak_bytes_in_use", dev.id, stats.get("peak_bytes_in_use"))


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; never exits 0")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); nothing run",
              file=sys.stderr)
        return 2
    interp = dev.platform != "gpu"
    log("device_kind", dev.device_kind, "count", len(jax.devices()))
    power = "not read" if interp else nvidia_smi_line()
    log("nvidia-smi", power)

    if args.four_cards:
        phases = [("four_cards", lambda: phase_four_cards(args.rehearse))]
    else:
        phases = [
            ("kernel", lambda: phase_kernel(args.rehearse, interp)),
            ("numerics", lambda: phase_numerics(args.rehearse)),
            ("main", lambda: phase_main(args.rehearse, interp, power)),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn()
        except Exception:  # noqa: BLE001 reported, then the run fails
            traceback.print_exc()
            failed.append(name)
            log(f"== phase {name} FAILED after {time.perf_counter() - t0:.1f} s")
            break
        else:
            log(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if args.rehearse:
        log("rehearsal done (no result is printed off the card)")
        return 3
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
