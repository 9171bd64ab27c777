"""Interpret-mode tests of the Triton intersection kernel.

The kernel (``ops/intersect_pallas.py``) compiles only for a GPU, so on the
CPU these tests run it with ``interpret=True`` — the same kernel code,
executed by the Pallas interpreter — and check the OptiX payload contract
(reference scene_optix.cpp:400-404) against the numpy oracle and the blocked
reference.  On the card ``chip_smoke.py`` compares the compiled kernel.

Covered: triangle counts around the chunk size and large enough for many
chunks, ray counts that need padding, NaN/inf rays, active masks,
degenerate triangles, the tie rule (smallest t, then lowest id), a closest
hit in a later chunk than an earlier hit, chunk culling on and off, and
the block-shape choice.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psdr_jax.core.types import Ray
from psdr_jax.ops import intersect_pallas as ip
from psdr_jax.ops.intersect import ray_intersect_brute, ray_intersect_detached
from tests.test_intersect import _numpy_oracle, _random_scene, _check_against_oracle


def _run(p0, e1, e2, ro, rd, **kw):
    return ip.ray_intersect_pallas(
        jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(ro), jnp.asarray(rd), interpret=True, **kw,
    )


def _brute(p0, e1, e2, ro, rd):
    return ray_intersect_brute(*(jnp.asarray(x) for x in (p0, e1, e2, ro, rd)))


def _assert_same_hits(got, ref):
    """Kernel vs reference: same ids, t/u/v to float32 rounding."""
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    hit = np.asarray(ref[1])
    np.testing.assert_allclose(np.asarray(got[3])[hit],
                               np.asarray(ref[3])[hit], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[2])[hit],
                               np.asarray(ref[2])[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_tri", [1, 31, 32, 33, 5120])
def test_kernel_matches_brute_over_triangle_counts(n_tri):
    n_ray = 300 if n_tri > 1000 else 700
    p0, e1, e2, ro, rd = _random_scene(n_tri=n_tri, n_ray=n_ray, seed=n_tri)
    if n_tri > 1000:  # smaller triangles, so hits stay a fraction
        e1 *= 0.1
        e2 *= 0.1
    got = _run(p0, e1, e2, ro, rd)
    assert np.asarray(got[1]).any()
    _assert_same_hits(got, _brute(p0, e1, e2, ro, rd))


@pytest.mark.parametrize("n_ray", [1, 63, 65, 257])
def test_kernel_pads_ray_counts(n_ray):
    p0, e1, e2, ro, rd = _random_scene(n_tri=40, n_ray=n_ray, seed=7)
    got = _run(p0, e1, e2, ro, rd)
    assert got[0].shape == (n_ray,) and got[2].shape == (n_ray, 2)
    _assert_same_hits(got, _brute(p0, e1, e2, ro, rd))


@pytest.mark.parametrize("cull", [True, False])
def test_kernel_matches_oracle_with_and_without_culling(cull):
    """Chunks are culled only where there is more than one of them."""
    n_tri = 200 if cull else 24
    assert (ip.block_shape(n_tri)[1] < n_tri) == cull
    p0, e1, e2, ro, rd = _random_scene(n_tri=n_tri, n_ray=513, seed=10)
    tri_id, valid, uv, t = _run(p0, e1, e2, ro, rd)
    assert np.asarray(valid).any()
    _check_against_oracle(tri_id, uv, t, p0, e1, e2, ro, rd)


def test_closest_hit_in_a_later_chunk():
    """A far hit in chunk 0 and a nearer one in chunk 1 (and the reverse):
    the running closest hit must carry across chunks."""
    _, bt = ip.block_shape(64)
    n_tri = 2 * bt
    p0 = np.zeros((n_tri, 3), np.float32)
    e1 = np.tile(np.asarray([[2.0, 0.0, 0.0]], np.float32), (n_tri, 1))
    e2 = np.tile(np.asarray([[0.0, 2.0, 0.0]], np.float32), (n_tri, 1))
    for j in range(n_tri):
        z = 10.0 + j * 0.01 if j < bt else 5.0 + (j - bt) * 0.001
        p0[j] = (-1.0, -1.0, z)
    p0[5, 2] = 1.0          # chunk-0 triangle nearer than all of chunk 1
    p0[bt + 7, 2] = 0.5     # chunk-1 triangle nearest of all
    ro = np.zeros((4, 3), np.float32)
    rd = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    ro[1] = (-0.1, -0.1, 0.0)
    ro[2] = (0.0, 0.0, 2.0)   # above both special triangles
    ro[3] = (0.0, 0.0, 9.0)   # above all of chunk 1
    tri_id, _, _, t = (np.asarray(x) for x in _run(p0, e1, e2, ro, rd))
    assert tri_id[0] == bt + 7 and abs(t[0] - 0.5) < 1e-5
    assert tri_id[1] == bt + 7 and abs(t[1] - 0.5) < 1e-5
    assert tri_id[2] == bt and abs(t[2] - 3.0) < 1e-5
    assert tri_id[3] == 0 and abs(t[3] - 1.0) < 1e-5


def test_ties_go_to_the_lowest_id():
    """Coincident triangles in one chunk and across chunks: the reference's
    rule is smallest t, then the lowest id."""
    _, bt = ip.block_shape(64)
    n_tri = 2 * bt
    p0 = np.tile(np.asarray([[-1.0, -1.0, 3.0]], np.float32), (n_tri, 1))
    e1 = np.tile(np.asarray([[2.0, 0.0, 0.0]], np.float32), (n_tri, 1))
    e2 = np.tile(np.asarray([[0.0, 2.0, 0.0]], np.float32), (n_tri, 1))
    p0[:3, 2] = 4.0          # the first three lie behind the rest
    ro = np.zeros((3, 3), np.float32)
    rd = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    got = _run(p0, e1, e2, ro, rd)
    assert (np.asarray(got[0]) == 3).all()
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  np.asarray(_brute(p0, e1, e2, ro, rd)[0]))


def test_cluster_culling_keeps_results():
    """Chunks far outside every ray's path are skipped without changing
    results: two spatially separated clusters, rays aimed at one."""
    rng = np.random.default_rng(13)
    n = 128
    p0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p0[64:, 0] += 1000.0
    e1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    ro = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    rd = rng.normal(size=(200, 3)).astype(np.float32)
    rd[:, 0] = -np.abs(rd[:, 0]) - 0.5
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tri_id, valid, uv, t = _run(p0, e1, e2, ro, rd)
    oid, ouv, ot = _numpy_oracle(p0, e1, e2, ro, rd)
    np.testing.assert_array_equal(np.asarray(tri_id), oid)
    hit = oid >= 0
    np.testing.assert_allclose(np.asarray(t)[hit], ot[hit], rtol=1e-4)


def test_axis_parallel_rays_on_a_slab_plane_are_not_culled():
    """A ray parallel to an axis whose origin lies on a chunk box's face
    gives a NaN slab distance; the chunk must still be tested."""
    p0 = np.asarray([[0.0, -1.0, 2.0]] * 40, np.float32)
    e1 = np.asarray([[1.0, 0.0, 0.0]] * 40, np.float32)
    e2 = np.asarray([[0.0, 2.0, 0.0]] * 40, np.float32)
    p0[:, 2] += np.arange(40, dtype=np.float32)
    ro = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]], np.float32)
    rd = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    tri_id = np.asarray(_run(p0, e1, e2, ro, rd)[0])
    ref = np.asarray(_brute(p0, e1, e2, ro, rd)[0])
    np.testing.assert_array_equal(tri_id, ref)
    assert (tri_id == 0).all()


def test_degenerate_triangles_and_miss_rays():
    """Zero-area triangles and all-miss rays give tri_id == -1."""
    p0 = np.asarray([[-1, -1, 2.0], [0, 0, 0]], np.float32)
    e1 = np.asarray([[2, 0, 0], [0, 0, 0]], np.float32)  # tri 1 degenerate
    e2 = np.asarray([[0, 2, 0], [0, 0, 0]], np.float32)
    ro = np.zeros((3, 3), np.float32)
    rd = np.asarray([[0, 0, 1], [0, 0, -1], [1, 0, 0]], np.float32)
    tri_id, valid, uv, t = _run(p0, e1, e2, ro, rd)
    tri_id = np.asarray(tri_id)
    assert tri_id[0] == 0
    assert tri_id[1] == -1 and not bool(valid[1])
    assert tri_id[2] == -1
    assert np.asarray(t)[1] >= 1e30


def test_nan_inf_rays_miss_by_construction():
    """The kernel's conjunctive hit test makes any NaN/inf coordinate miss,
    even without an active mask."""
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    ro = np.zeros((8, 3), np.float32)
    rd = np.tile(np.asarray([[0, 0, 1.0]], np.float32), (8, 1))
    ro[1, 0] = np.nan
    rd[2, 2] = np.nan
    ro[3, 1] = np.inf
    rd[4, 0] = -np.inf
    rd[5] = np.nan
    tri_id, valid, uv, t = _run(p0, e1, e2, ro, rd)
    tri_id = np.asarray(tri_id)
    for i in (1, 2, 3, 4, 5):
        assert tri_id[i] == -1 and not bool(valid[i]), i
    assert np.isfinite(np.asarray(t)[[1, 2, 3, 4, 5]]).all()


def test_inactive_lanes_take_no_hit():
    p0, e1, e2, ro, rd = _random_scene(n_tri=64, n_ray=130, seed=21)
    active = np.arange(130) % 3 != 0
    got = _run(p0, e1, e2, ro, rd, active=jnp.asarray(active))
    ref = _brute(p0, e1, e2, ro, rd)
    assert not np.asarray(got[1])[~active].any()
    assert (np.asarray(got[3])[~active] >= 1e30).all()
    np.testing.assert_array_equal(np.asarray(got[0])[active],
                                  np.asarray(ref[0])[active])


def test_detached_entry_point_kernel_matches_brute():
    """The scene-layer entry point through the kernel (interpreted) and
    through the reference: NaN rays and an active mask on (..., 3) rays."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=48, n_ray=96, seed=4)
    ro[5] = np.nan
    rd[9, 1] = np.inf
    ray = Ray(jnp.asarray(ro).reshape(8, 12, 3),
              jnp.asarray(rd).reshape(8, 12, 3))
    active = jnp.asarray(np.arange(96).reshape(8, 12) % 5 != 0)
    tri = [jnp.asarray(x) for x in (p0, e1, e2)]
    got = ray_intersect_detached(*tri, ray, active, backend="interpret")
    ref = ray_intersect_detached(*tri, ray, active, backend="brute")
    assert got[0].shape == (8, 12) and got[2].shape == (8, 12, 2)
    _assert_same_hits([x.reshape((96,) + x.shape[2:]) for x in got],
                      [x.reshape((96,) + x.shape[2:]) for x in ref])


@pytest.mark.parametrize("n_tri,expect_t", [(1, 16), (16, 16), (17, 32),
                                            (32, 32), (33, 32), (102412, 32)])
def test_block_shape_choice(n_tri, expect_t):
    block_r, block_t = ip.block_shape(n_tri)
    assert block_t == expect_t
    assert block_r * block_t == ip.TILE_PAIRS
    assert block_r & (block_r - 1) == 0  # Triton blocks are powers of two


def test_chunk_boxes_contain_their_triangles():
    """Each chunk's box holds all three vertices of its triangles, and the
    edge padding of a partial last chunk leaves that chunk's box as it was."""
    p0, e1, e2, _, _ = _random_scene(n_tri=40, n_ray=1, seed=8)
    bt = ip.block_shape(40)[1]
    pad = ((0, 2 * bt - 40), (0, 0))
    pp0 = np.pad(p0, pad, mode="edge")
    pe1, pe2 = np.pad(e1, pad), np.pad(e2, pad)
    boxes = np.asarray(ip.chunk_boxes(*(jnp.asarray(x) for x in
                                       (pp0, pe1, pe2)), bt))
    assert boxes.shape == (6, 2)
    for k in range(2):
        sl = slice(k * bt, min((k + 1) * bt, 40))
        verts = np.concatenate([p0[sl], p0[sl] + e1[sl], p0[sl] + e2[sl]])
        assert (boxes[:3, k] <= verts.min(0)).all()
        assert (boxes[3:, k] >= verts.max(0)).all()
        np.testing.assert_allclose(boxes[:3, k], verts.min(0), atol=1e-4)
        np.testing.assert_allclose(boxes[3:, k], verts.max(0), atol=1e-4)
