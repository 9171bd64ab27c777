"""Golden-image regression net.

A committed reference render of the procedural Cornell box catches silent
estimator changes across refactors.  Tolerance is loose enough for cross-
platform f32 reduction-order differences but tight enough that any change
to sampling, shading, or intersection logic trips it — if a change is
INTENTIONAL, regenerate with:

    python -c "import jax; jax.config.update('jax_platforms','cpu'); \
        import sys; sys.path.insert(0,'tests'); import numpy as np; \
        import psdr_jax as psdr; from scenes import make_cbox; \
        sc = make_cbox(width=32, height=32, spp=4); sc.configure(); \
        np.save('tests/golden_cbox32.npy', np.asarray( \
            psdr.PathTracer(2).renderC(sc, 0, seed=0), np.float32))"
"""

import os

import numpy as np

import psdr_jax as psdr
from scenes import make_cbox

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cbox32.npy")


def test_cbox_matches_golden():
    sc = make_cbox(width=32, height=32, spp=4)
    sc.configure()
    img = np.asarray(psdr.PathTracer(2).renderC(sc, 0, seed=0), np.float32)
    golden = np.load(GOLDEN)
    # identical sample streams -> differences can only be op-reordering ULPs
    np.testing.assert_allclose(img, golden, rtol=1e-4, atol=1e-5)


def test_pfm_roundtrip(tmp_path):
    from psdr_jax.utils.image import read_image, write_image

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 10, (9, 7, 3)).astype(np.float32)
    path = str(tmp_path / "x.pfm")
    write_image(path, img)
    back = read_image(path)
    np.testing.assert_allclose(back, img, rtol=1e-6)
