"""AOV extraction (reference tutorial different_integrator.ipynb):
depth / normals / uv / silhouette / segmentation images.

Run: python examples/field_aovs.py [outdir]
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import numpy as np

import psdr_jax as psdr
from psdr_jax.utils.image import write_ppm
from scenes import make_cbox


def main(outdir="out"):
    os.makedirs(outdir, exist_ok=True)
    sc = make_cbox(width=128, height=128, spp=4)
    sc.configure()
    for field in ("depth", "geoNormal", "shNormal", "uv", "silhouette",
                  "segmentation", "position"):
        img = np.asarray(
            psdr.FieldExtractionIntegrator(field).renderC(sc, 0)
        ).reshape(128, 128, 3)
        lo, hi = img.min(), img.max()
        vis = (img - lo) / (hi - lo + 1e-9)
        write_ppm(os.path.join(outdir, f"aov_{field}.ppm"), vis, gamma=1.0)
        print(f"{field:12s} range [{lo:.3g}, {hi:.3g}]")


if __name__ == "__main__":
    main(*sys.argv[1:])
