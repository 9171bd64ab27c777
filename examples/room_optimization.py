"""Scene-level optimization on the room scene (BASELINE config #5).

A psdr-room-style workload: ~14 meshes, mixed BSDF families (diffuse /
microfacet / rough conductor), ALL THREE estimators (interior +
primary-edge + secondary-edge), and joint gradients for a mesh pose (the
red box's translation) and the emitter radiance — optimized with Adam
through the sharded fused training step (one forward + one adjoint,
parameter cotangents psum'd over the device mesh).  Vertex-position
gradients on this scene are pinned by tests/test_room.py; they are left
out of the demo loss because an unregularized 72-dof vertex field can
absorb the pose residual (over-parameterization), which obscures the
convergence story.

Run (CPU, 8 virtual devices):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/room_optimization.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax.numpy as jnp
import numpy as np
import optax

import psdr_jax as psdr
from scenes import make_room


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} ({jax.devices()[0].platform})")

    sc = make_room(width=64, height=64, spp=4, sppe=4, sppse=4)
    sc.configure()
    integ = psdr.PathTracer(max_depth=2)

    redbox = sc.meshes[12]      # diffuse red box on the table (pose)
    em = sc.emitters[0]
    base_raw = redbox.to_world_raw
    base_r = em.radiance

    def apply(p):
        redbox.to_world_raw = base_raw.at[0, 3].add(p["tx"])
        em.radiance = base_r * jnp.exp(p["log_gain"])

    # ground truth: red box shifted by 12 cm, light dimmed 26%.
    # renderC reads the configure-time scene cache, so re-configure after
    # editing parameters (the reference tutorials' pattern) and reset after.
    truth = {"tx": jnp.float32(0.12), "log_gain": jnp.float32(-0.3)}
    apply(truth)
    sc.configure()
    # fixed sample set (seed=1 throughout, the reference-tutorial pattern):
    # the loss is then deterministic and Adam converges cleanly
    target = jnp.asarray(np.asarray(integ.renderC(sc, 0, seed=1)))
    apply({"tx": jnp.float32(0.0), "log_gain": jnp.float32(0.0)})
    sc.configure()

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    params = {"tx": jnp.float32(0.0), "log_gain": jnp.float32(0.0)}

    if n_dev > 1:
        from psdr_jax.parallel.mesh import make_device_mesh
        from psdr_jax.parallel.shard import make_fused_train_step

        mesh = make_device_mesh(n_dev)
        step = make_fused_train_step(sc, integ, mesh, apply, ploss)
    else:
        def step(p, seed):
            return integ.loss_and_grad(sc, p, apply, ploss, seed=seed)

    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    for it in range(80):
        loss, grads, _ = step(params, seed=1)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        if it % 10 == 0 or it == 79:
            print(f"iter {it:3d}  loss {float(loss):10.4f}  "
                  f"tx {float(params['tx']):+.4f} (goal +0.1200)  "
                  f"log_gain {float(params['log_gain']):+.4f} (goal -0.3)",
                  flush=True)

    assert abs(float(params["tx"]) - 0.12) < 0.05, "pose did not converge"
    assert abs(float(params["log_gain"]) + 0.3) < 0.1, \
        "light gain did not converge"
    print("converged")


if __name__ == "__main__":
    main()
