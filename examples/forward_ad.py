"""Forward-mode gradient image on the Cornell box.

Mirrors the reference tutorial ``tutorials/Forward_AD.ipynb``: render the
cbox, then compute the forward-mode derivative image w.r.t. an x-translation
of the tall block — the sum of the interior, primary-edge and secondary-edge
terms (spp/sppe/sppse = 32).

Run: python examples/forward_ad.py [outdir]
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

import numpy as np
import jax.numpy as jnp

import psdr_jax as psdr
from psdr_jax.utils.image import write_image, write_ppm
from scenes import make_cbox


def main(outdir="out"):
    os.makedirs(outdir, exist_ok=True)
    sc = make_cbox(width=256, height=256, spp=32, sppe=32, sppse=32)
    sc.configure()
    integrator = psdr.PathTracer(max_depth=3)

    img = np.asarray(integrator.renderC(sc, 0, seed=0)).reshape(256, 256, 3)
    write_ppm(os.path.join(outdir, "cbox.ppm"), img)

    mesh = sc.param_map["Mesh[7]"]  # tall block
    base = mesh.to_world_raw

    def render(tx):
        mesh.to_world_raw = base.at[0, 3].add(tx)
        return integrator.renderD(sc, 0, seed=0)

    _, dimg = jax.jvp(render, (jnp.float32(0.0),), (jnp.float32(1.0),))
    dimg = np.asarray(dimg).reshape(256, 256, 3)
    write_image(os.path.join(outdir, "cbox_grad.npy"), dimg)
    # signed-gradient preview: red = positive, blue = negative
    scale = np.quantile(np.abs(dimg), 0.995) + 1e-9
    vis = np.stack([np.maximum(dimg[..., 0], 0),
                    np.zeros_like(dimg[..., 0]),
                    np.maximum(-dimg[..., 0], 0)], -1) / scale
    write_ppm(os.path.join(outdir, "cbox_grad.ppm"), vis)
    print("wrote", outdir + "/cbox.ppm and cbox_grad.{npy,ppm}")
    print("grad image abs-mean:", float(np.abs(dimg).mean()))


if __name__ == "__main__":
    main(*sys.argv[1:])
