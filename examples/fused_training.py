"""Production inverse-rendering loop with the fused forward+adjoint step.

The fused step (``Integrator.loss_and_grad``, integrator/fused.py) computes
loss, parameter gradients and the rendered image in ONE forward + ONE
adjoint sweep with zero recompute — the cost structure of the reference's
Dr.Jit tape backward (reference README.md:102-104) — for any pixel-local
loss.  With more than one device it shards over a ``jax.sharding.Mesh``
(``parallel.shard.make_fused_train_step``): pixel rows and edge-sample
lanes are partitioned per device and parameter cotangents are ``psum``'d
(an NCCL all-reduce over NVLink on a GPU host).

Run (CPU, 8 virtual devices):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/fused_training.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import jax.numpy as jnp
import numpy as np
import optax

import psdr_jax as psdr
from scenes import make_cbox


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} ({jax.devices()[0].platform})")

    w = 32
    sc = make_cbox(width=w, height=w, spp=4, sppe=2, sppse=2)
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    em = sc.emitters[0]
    box = sc.meshes[-1]
    base_r = em.radiance
    base_v = box.vertex_positions_raw

    # target: the unperturbed scene; start from wrong radiance + shifted box
    target = jnp.asarray(np.asarray(integ.renderC(sc, 0, seed=11)))
    params = {
        "radiance": base_r * 1.8,
        "dx": jnp.float32(40.0),  # cbox units (box is ~165 wide)
    }

    def apply_params(p):
        em.radiance = p["radiance"]
        box.vertex_positions_raw = base_v + jnp.array(
            [1.0, 0.0, 0.0], jnp.float32
        ) * p["dx"]

    def pixel_loss(rows, pix_ids):
        return jnp.sum(jnp.square(rows - target[pix_ids]), axis=-1)

    if n_dev > 1 and (w * w) % n_dev == 0:
        from psdr_jax.parallel.mesh import make_device_mesh
        from psdr_jax.parallel.shard import make_fused_train_step

        mesh = make_device_mesh(n_dev)
        step = make_fused_train_step(sc, integ, mesh, apply_params,
                                     pixel_loss)
        print(f"sharded fused step over a {n_dev}-device mesh")
    else:
        step = jax.jit(
            lambda p, s: integ.loss_and_grad(
                sc, p, apply_params, pixel_loss, seed=s
            )
        )
        print("single-device fused step")

    # per-parameter Adam scales: geometry moves in cbox units (~0-550),
    # radiance in radiance units — one global lr cannot serve both
    opt = optax.multi_transform(
        {"geom": optax.adam(8.0), "light": optax.adam(0.4)},
        {"radiance": "light", "dx": "geom"},
    )
    opt_state = opt.init(params)
    for it in range(40):
        loss, grads, _ = step(params, 11 + it)  # fresh sample set per step
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        if it % 5 == 0 or it == 39:
            print(f"iter {it:3d}  loss {float(loss):10.4f}  "
                  f"dx {float(params['dx']):7.3f}  "
                  f"radiance err {float(jnp.abs(params['radiance'] - base_r).max()):.3f}")

    assert float(jnp.abs(params["dx"])) < 0.5 * 40.0
    assert float(jnp.abs(params["radiance"] - base_r).max()) < 0.5 * float(
        jnp.abs(base_r * 0.8).max()
    )
    print("recovered box position and radiance")


if __name__ == "__main__":
    main()
