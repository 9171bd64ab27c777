"""Batch/crop rendering (reference tutorial batch_render.ipynb): render a
pixel subset with the same seed and verify it is bitwise-consistent with the
full frame — the contract that also makes multi-chip sharding exact.

Run: python examples/batch_render.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import numpy as np
import jax.numpy as jnp

import psdr_jax as psdr
from scenes import make_cbox


def main():
    sc = make_cbox(width=128, height=128, spp=8)
    sc.configure()
    integrator = psdr.PathTracer(max_depth=2)

    full = np.asarray(integrator.renderC(sc, 0, seed=5))

    # a 32x32 crop starting at (48, 48)
    ys, xs = np.mgrid[48:80, 48:80]
    crop_ids = jnp.asarray((ys * 128 + xs).ravel(), jnp.int32)
    crop = np.asarray(integrator.renderC(sc, 0, seed=5, batch_pix=crop_ids))

    exact = np.array_equal(crop, full[np.asarray(crop_ids)])
    print("crop == full-frame slice (bitwise):", exact)
    assert exact


if __name__ == "__main__":
    main()
