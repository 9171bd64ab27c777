"""Inverse rendering: recover wall albedo + light radiance with Adam.

Mirrors the reference's downstream optimization workflow (README.md:113-115
points users at torch Adam; here the loop is jax + optax, with the loss and
gradient in one fused jit).

Run: python examples/inverse_albedo.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import numpy as np
import jax.numpy as jnp
import optax

import psdr_jax as psdr
from scenes import make_cbox


def main():
    sc = make_cbox(width=64, height=64, spp=8)
    sc.configure()
    integrator = psdr.PathTracer(max_depth=2)
    bsdf = sc.param_map["BSDF[id=white]"]
    em = sc.emitters[0]
    true_alb = jnp.asarray(bsdf.reflectance.data)
    true_rad = jnp.asarray(em.radiance)
    target = np.asarray(integrator.renderC(sc, 0, seed=3))

    def loss_fn(alb, log_rad, seed):
        bsdf.reflectance.data = alb
        em.radiance = jnp.exp(log_rad)
        img = integrator.renderD(sc, 0, seed=seed)
        return jnp.mean(jnp.square(img - target))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))

    params = (true_alb * 0.3, jnp.log(true_rad * 3.0))
    opt = optax.adam(5e-2)
    state = opt.init(params)
    for it in range(100):
        loss, g = grad_fn(params[0], params[1], jnp.uint32(it))
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params = (jnp.clip(params[0], 0.0, 1.0), params[1])
        if it % 10 == 0:
            print(f"iter {it:3d}  loss {float(loss):.3e}")

    bsdf.reflectance.data = true_alb
    em.radiance = true_rad
    print("recovered albedo:", np.asarray(params[0]).ravel(),
          "(true", np.asarray(true_alb).ravel(), ")")
    print("recovered radiance:", np.asarray(jnp.exp(params[1])),
          "(true", np.asarray(true_rad), ")")


if __name__ == "__main__":
    main()
