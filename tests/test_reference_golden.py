"""Cross-implementation goldens vs the reference's own published outputs.

The reference ships no test suite, but its tutorials embed rendered output
images (SURVEY.md §4: "tutorials as de-facto integration tests").
``Forward_AD.ipynb`` publishes (a) the sRGB cbox render and (b) the
forward-mode gradient image for an x-translation of the luminaire + small
ball (viridis, vmin/vmax ±0.1).  These tests rebuild the *exact* tutorial
scene through our API — loading the reference's own OBJ assets at runtime —
and require our renders to match those published images in 16×16 block
means.  This is the BASELINE.json gate "rendered images and pixel-gradient
images must be allclose to psdr-jit's renderD/forward_to output" checked
against the only reference artifacts that exist.

The reference assets stay in /root/reference (read at runtime, never
copied); the whole module skips when they are absent.

BASELINE config #2 (the README.md:42-116 inverse-rendering example at
512², depth 3, all three estimators) has NO external golden and cannot
get one here (noted 2026-08-20): the reference is CUDA+OptiX-only — this
machine has no NVIDIA GPU or driver (`nvidia-smi` absent), so a one-off
reference run is infeasible, and the reference publishes no rendered
artifact for that config (its README shows code, not output).  Config #2
is instead gated by (a) the tutorial goldens here — same scene assets and
integrator at 256²/depth-1 — (b) the envmap goldens
(test_envmap_golden.py) for config #3, and (c) internal cross-path
consistency at the full workload: prb == chunk == fused == jvp
(test_fused.py, test_prb.py) plus the analytic edge oracles
(test_grad_edges.py).
"""

import base64
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import psdr_jax as psdr

_NB = "/root/reference/tutorials/Forward_AD.ipynb"
_DATA = "/root/reference/tutorials/data/cbox"

pytestmark = pytest.mark.skipif(
    not (os.path.exists(_NB) and os.path.isdir(_DATA)),
    reason="reference tutorial assets not available",
)


def _notebook_pngs():
    """The two embedded matplotlib figures (cells 5 and 6)."""
    nb = json.load(open(_NB))
    out = []
    for cell in nb["cells"]:
        for o in cell.get("outputs", []):
            png = o.get("data", {}).get("image/png")
            if png:
                out.append(base64.b64decode(png))
    assert len(out) == 2, "Forward_AD.ipynb should embed 2 figures"
    return out


def _crop_imshow(png_bytes):
    """Crop the imshow axes region out of a matplotlib figure PNG.

    The figure background is pure white; the image axes is the rectangle
    of rows/columns with long non-white runs.  The gradient figure also
    contains a colorbar, so the column window is clamped to the primal
    figure's square (both figures share the same axes geometry).
    """
    from PIL import Image
    import io

    a = np.asarray(Image.open(io.BytesIO(png_bytes)).convert("RGB"))
    nonwhite = a.astype(int).sum(-1) < 720
    rows = np.where(nonwhite.sum(1) > 250)[0]
    cols = np.where(nonwhite.sum(0) > 250)[0]
    r0, r1 = rows.min(), rows.max() + 1
    c0 = cols.min()
    c1 = min(cols.max() + 1, c0 + (r1 - r0) + 1)  # exclude any colorbar
    return a[r0:r1, c0:c1].astype(np.float32) / 255.0


def _block_means(img, n=16):
    h, w = img.shape[:2]
    ys = np.linspace(0, h, n + 1).astype(int)
    xs = np.linspace(0, w, n + 1).astype(int)
    return np.array([
        [img[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean(axis=(0, 1))
         for j in range(n)]
        for i in range(n)
    ])


def _to_srgb(l):
    """image_util.py linear_to_srgb (the tutorial's tone map)."""
    l = np.clip(l, 0.0, 1.0)
    return np.where(l <= 0.00313066844250063,
                    l * 12.92, 1.055 * l ** (1.0 / 2.4) - 0.055)


RES = 256  # tutorial renders 512²; block means are resolution-agnostic


def _build_tutorial_scene(spp, sppe=0, sppse=0):
    """Forward_AD.ipynb cells 1-4, verbatim through our API."""
    sc = psdr.Scene()
    sc.opts.width = sc.opts.height = RES
    sc.opts.spp, sc.opts.sppe, sc.opts.sppse = spp, sppe, sppse

    sensor = psdr.PerspectiveCamera(60, 0.000001, 10000000.0)
    sensor.to_world = jnp.asarray(
        [[1.0, 0.0, 0.0, 278.0],
         [0.0, 1.0, 0.0, 273.0],
         [0.0, 0.0, 1.0, -500.0],
         [0.0, 0.0, 0.0, 1.0]], jnp.float32)
    sc.add_Sensor(sensor)

    for bid, refl in [("sphere_large", [0.2, 0.9, 0.9]), ("back", 0.5),
                      ("light", 0.5), ("sphere_small", [0.9, 0.6, 0.1]),
                      ("white", [0.95] * 3), ("green", [0.2, 0.9, 0.2]),
                      ("red", [0.9, 0.2, 0.2])]:
        sc.add_BSDF(psdr.DiffuseBSDF(refl), bid)

    eye = jnp.eye(4, dtype=jnp.float32)
    sc.add_Mesh(f"{_DATA}/cbox_luminaire.obj", eye.at[1, 3].set(-0.5),
                "light", psdr.AreaLight([20.0, 20.0, 8.0]))
    for name, bid in [("smallball", "sphere_small"),
                      ("largeball", "sphere_large"), ("floor", "white"),
                      ("ceiling", "white"), ("back", "back"),
                      ("greenwall", "green"), ("redwall", "red")]:
        sc.add_Mesh(f"{_DATA}/cbox_{name}.obj", eye, bid, None)
    sc.configure()
    return sc


def test_render_matches_published_tutorial_image():
    ref = _crop_imshow(_notebook_pngs()[0])
    sc = _build_tutorial_scene(spp=8)
    integ = psdr.PathTracer(1)
    img = np.asarray(integ.renderC(sc, 0, seed=0)).reshape(RES, RES, 3)
    diff = np.abs(_block_means(_to_srgb(img)) - _block_means(ref))
    # measured 0.0037 mean / 0.025 max at spp=8 (residual = our MC noise +
    # the figure's PNG downscale); a materials/geometry/radiometry bug
    # moves whole blocks by >0.1
    assert diff.mean() < 0.012, diff.mean()
    assert diff.max() < 0.06, diff.max()


def test_forward_grad_matches_published_tutorial_image():
    """forward_to grad image (cell 6): translate luminaire + small ball in
    x; compare against the published viridis rendering at vmin/vmax ±0.1."""
    cm = pytest.importorskip("matplotlib.cm")
    ref = _crop_imshow(_notebook_pngs()[1])
    sc = _build_tutorial_scene(spp=8, sppe=8, sppse=8)
    integ = psdr.PathTracer(1)

    m0, m1 = sc.param_map["Mesh[0]"], sc.param_map["Mesh[1]"]
    tw0, tw1 = m0.to_world_raw, m1.to_world_raw

    def render(P):
        m0.set_transform(tw0.at[0, 3].add(P * 100.0))
        m1.set_transform(tw1.at[0, 3].add(P * 100.0))
        return integ.renderD(sc, 0, seed=0)

    _, dimg = jax.jvp(render, (jnp.float32(0.0),), (jnp.float32(1.0),))
    g = np.asarray(dimg).reshape(RES, RES, 3).mean(axis=2)
    ours = cm.viridis(np.clip((g + 0.1) / 0.2, 0.0, 1.0))[..., :3]
    diff = np.abs(_block_means(ours) - _block_means(ref))
    # measured 0.008 mean / 0.053 max at (8,8,8): boundary-term MC noise
    # dominates; a sign/term error flips whole blobs (|diff| ~ 0.5)
    assert diff.mean() < 0.03, diff.mean()
    assert diff.max() < 0.15, diff.max()
