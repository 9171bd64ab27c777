"""Device-time breakdown of bench.py's headline fused step on one GPU.

Compiles the step (a compile-cache hit after chip_smoke.py or bench.py in
the same checkout), warms it up, traces ``--steps`` steps with
``jax.profiler`` and reduces the trace with ``bench.device_time_breakdown``:
busy time, idle share of the traced window and the top kernels with their
counts.  The trace and a JSON summary go to ``--out``.

    python scripts/profile_step.py [--out out/profile] [--steps 3]

Refuses to run without a GPU.
"""

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from chip_smoke import headline_problem, make_step, nvidia_smi_line  # noqa


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "profile"))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_step: no GPU; a CPU trace has no device time")

    sc, integ, mesh, em = headline_problem(bench.WIDTH, bench.SPP,
                                           bench.DEPTH)
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jnp.asarray(np.random.default_rng(0).random(
        (bench.WIDTH * bench.HEIGHT, 3)), jnp.float32)
    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
    t0 = time.perf_counter()
    fn = jax.jit(make_step(sc, integ, mesh, em, bv, br)).lower(
        p0, jnp.uint32(0), target).compile()
    compile_s = time.perf_counter() - t0
    for i in range(2):
        jax.block_until_ready(fn(p0, jnp.uint32(i), target))

    with jax.profiler.trace(args.out):
        t0 = time.perf_counter_ns()
        for i in range(args.steps):
            jax.block_until_ready(fn(p0, jnp.uint32(10 + i), target))
        window = time.perf_counter_ns() - t0
    path = sorted(glob.glob(os.path.join(
        args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    res = bench.device_time_breakdown(path, window)
    res.update({"steps": args.steps, "compile_s": compile_s,
                "device_kind": jax.devices()[0].device_kind,
                "gpu_name_power_limit": nvidia_smi_line()})
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
