"""Secondary-edge guiding (reference tutorial secondary_edge_guiding.ipynb):
build the 3D guiding table before renderD so boundary samples concentrate
where the integrand has mass.

Run: python examples/secondary_edge_guiding.py
"""

import os
import sys
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import numpy as np
import jax.numpy as jnp

import psdr_jax as psdr
from scenes import make_cbox


def main():
    sc = make_cbox(width=64, height=64, spp=4, sppe=0, sppse=4)
    sc.configure()
    integrator = psdr.PathTracer(max_depth=1)

    # reference call shape: preprocess_secondary_edges(sc, 0, [x,y,z,spp], n)
    t0 = time.time()
    integrator.preprocess_secondary_edges(sc, 0, [16, 4, 4, 8], nrounds=1)
    print(f"guiding table built in {time.time() - t0:.2f}s")

    mesh = sc.param_map["Mesh[7]"]
    base = mesh.to_world_raw

    def render(tx, seed):
        mesh.to_world_raw = base.at[0, 3].add(tx)
        return integrator.renderD(sc, 0, seed=seed)

    grads = []
    for seed in range(4):
        _, d = jax.jvp(lambda t: jnp.mean(render(t, seed)),
                       (jnp.float32(0.0),), (jnp.float32(1.0),))
        grads.append(float(d))
    print("guided d(mean)/dtx per seed:", ["%.3e" % g for g in grads])


if __name__ == "__main__":
    main()
