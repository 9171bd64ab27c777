"""Card-only tests: numerics that only the GPU can get wrong.

Every test here takes the ``gpu`` fixture and skips without a GPU.  On the
card they run in ``chip_smoke.py``'s own process (its numerics phase), which
sets ``PSDR_TEST_ON_CARD=1`` so the conftest leaves the backend alone:

    python chip_smoke.py

The bodies delegate to the CPU suite's tests, so each contract has one
definition: the exact one-hot gather, the analytic boundary-gradient
oracles and the FD-vs-AD interior check, plus float32 matmul precision
(TF32 would break it) and the cross-backend oracle.
"""

import os
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.chip


def test_one_hot_gather_bitwise_on_card(gpu):
    import test_gather as tg

    tg.test_split3_reconstructs_bitwise()
    tg.test_forward_bitwise_equal_to_plain_gather()
    tg.test_multidim_idx_shape_and_values()
    tg.test_beyond_bf16_max_stays_exact()
    for val in (0.0, -0.0, 1.0, np.float32(2**-120), np.float32(3.38e38)):
        tg.test_extreme_values_exact(val)


def test_f32_matmul_is_not_tf32_on_card(gpu):
    """Under the package's matmul precision a float32 product agrees with
    float64 to 1e-6; TF32 (10 mantissa bits) would miss by ~1e-3."""
    import jax.numpy as jnp
    import psdr_jax  # noqa: F401  (sets the precision)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    got = np.asarray(jnp.asarray(a) @ jnp.asarray(b), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-6, err


def test_primary_edge_oracle_on_card(gpu):
    import test_grad_edges as ge

    ge.test_primary_edge_gradient_analytic()


def test_secondary_edge_oracle_on_card(gpu):
    import test_grad_edges as ge

    ge.test_secondary_edge_gradient_analytic()


def test_interior_fd_vs_ad_on_card(gpu):
    import test_grad_interior as gi
    from scenes import make_cbox

    sc = make_cbox(width=16, height=16, spp=4)
    sc.configure()
    gi.test_albedo_gradient_fd(sc)


def test_cross_backend_oracle_on_card(gpu):
    """Loss, image and gradients of one training step on the card vs the
    same step on the CPU (identical sample set)."""
    import crosscheck

    path = os.path.join(tempfile.mkdtemp(prefix="psdr_oracle_"), "cpu.npz")
    proc = crosscheck.start_cpu_child(path)
    card = crosscheck.compute_beside(proc)
    rel = crosscheck.compare(crosscheck.finish_cpu_child(proc, path), card)
    print("cross-backend oracle:", rel)
    assert crosscheck.within_tolerance(rel), rel
