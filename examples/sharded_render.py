"""Multi-chip rendering: shard the pixel axis over a jax.sharding.Mesh.

On a CPU host this runs on a virtual 8-device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8); on a GPU host the
same code shards over the cards and the final gather runs over NVLink.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
         python examples/sharded_render.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import numpy as np

import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh, render_sharded
from scenes import make_cbox


def main():
    print("devices:", len(jax.devices()), jax.devices()[0].platform)
    sc = make_cbox(width=128, height=128, spp=8)
    sc.configure()
    integrator = psdr.PathTracer(max_depth=2)

    single = np.asarray(integrator.renderC(sc, 0, seed=2))
    mesh = make_device_mesh()
    sharded = np.asarray(render_sharded(integrator, sc, mesh, seed=2))
    print("sharded == single-device:",
          np.allclose(sharded, single, rtol=1e-6, atol=1e-7))


if __name__ == "__main__":
    main()
