"""Interleaved same-process A/B over integrator tuning knobs on one GPU.

Fresh-process timings drift, so a knob decision comes from this harness:
compile every variant once, then alternate timed blocks, each step ended
by block_until_ready on all outputs.  The workload is bench.py's headline
fused step (cbox 512x512, spp=sppe=sppse=32, PathTracer(3)).

Usage: python -u scripts/ab_knobs.py   (refuses to run without a GPU)
Edit VARIANTS below (module attributes of integrator/base.py are patched
before each compile and read at trace time).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import psdr_jax as psdr
import psdr_jax.integrator.base as base
from chip_smoke import nvidia_smi_line
from scenes import make_cbox

# (name, {module attr: value})
VARIANTS = [
    ("base_32k_32k", {}),
    ("interior_16k", {"CHUNK_LANES": 16384}),
    ("interior_64k", {"CHUNK_LANES": 65536}),
    ("edge_64k", {"EDGE_CHUNK_LANES": 65536}),
]

REPS = int(os.environ.get("AB_REPS", "4"))
ITERS = int(os.environ.get("AB_ITERS", "3"))


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit("ab_knobs: no GPU; timings off the card are not measured")
    print(jax.devices()[0].device_kind, "|", nvidia_smi_line(), flush=True)
    sc = make_cbox(width=512, height=512, spp=32, sppe=32, sppse=32)
    sc.configure()
    integ = psdr.PathTracer(max_depth=3)
    mesh, em = sc.meshes[-1], sc.emitters[0]
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jnp.asarray(
        np.random.default_rng(0).random((512 * 512, 3)), jnp.float32
    )

    def apply(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
    rays = 512 * 512 * (32 * 7 + 32 * 2 * 7 + 32 * 3)
    defaults = {k: getattr(base, k)
                for _, kv in VARIANTS for k in kv}

    fns = {}
    for name, kv in VARIANTS:
        for k, v in {**defaults, **kv}.items():
            setattr(base, k, v)

        def step(p, s, tgt, _integ=integ):
            def ploss(rows, pix):
                return jnp.sum(jnp.square(rows - tgt[pix]), axis=-1)
            return _integ.loss_and_grad(sc, p, apply, ploss, seed=s)[:2]

        fn = jax.jit(step)
        jax.block_until_ready(fn(p0, jnp.uint32(0), target))
        mesh.vertex_positions_raw, em.radiance = bv, br
        fns[name] = fn
        print("compiled", name, flush=True)
    for k, v in defaults.items():
        setattr(base, k, v)

    acc = {n: [] for n in fns}
    for rep in range(REPS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for i in range(ITERS):
                jax.block_until_ready(
                    fn(p0, jnp.uint32(rep * 31 + i + 1), target))
            acc[name].append((time.perf_counter() - t0) / ITERS)
    for name, ts in acc.items():
        ms = [1e3 * t for t in ts]
        print(f"{name}: median {np.median(ms):.1f} / min {min(ms):.1f} "
              f"ms/step ({rays / np.median(ms) / 1e3:.1f} Mrays/s at the "
              f"median)  reps={['%.1f' % x for x in ms]}", flush=True)


if __name__ == "__main__":
    main()
