"""Mesh topology / configure tests (reference: src/shape/mesh.cpp)."""

import numpy as np
import jax
import jax.numpy as jnp

import psdr_jax as psdr
from psdr_jax.shape.mesh import (
    build_edge_list, process_mesh, sample_position,
)
from psdr_jax.core.sampler import Sampler


QUAD_V = np.asarray(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
)
QUAD_F = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)


def test_edge_list_quad():
    """A 2-triangle quad has 5 edges: 4 boundary + 1 shared diagonal
    (mesh.cpp:112-149 build semantics)."""
    e = build_edge_list(QUAD_F)
    assert e.shape == (5, 5)
    boundary = e[e[:, 3] < 0]
    interior = e[e[:, 3] >= 0]
    assert boundary.shape[0] == 4
    assert interior.shape[0] == 1
    # the diagonal is (0, 2) shared by faces 0 and 1
    assert tuple(interior[0, :2]) == (0, 2)
    assert {interior[0, 2], interior[0, 3]} == {0, 1}
    # third vertex comes from face0 (the lower-indexed face)
    f0 = interior[0, 2]
    third = interior[0, 4]
    assert third in QUAD_F[f0]
    assert third not in (0, 2)


def test_edge_list_closed_mesh_no_boundary():
    """A tetrahedron is closed: all 6 edges have two faces."""
    f = np.asarray([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    e = build_edge_list(f)
    assert e.shape == (6, 5)
    assert (e[:, 3] >= 0).all()


def test_process_mesh_normals_areas():
    tri, vn = process_mesh(jnp.asarray(QUAD_V), jnp.asarray(QUAD_F))
    np.testing.assert_allclose(np.asarray(tri.face_area), [0.5, 0.5], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(tri.face_normal), [[0, 0, 1], [0, 0, 1]], atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(vn), [[0, 0, 1]] * 4, atol=1e-6)


def test_transform_stack():
    """World data reflects to_world_left @ raw @ right (mesh.h:96-98)."""
    m = psdr.Mesh()
    m.load_raw(QUAD_V, QUAD_F)
    m.to_world_raw = np.asarray(psdr.transform.translate(jnp.asarray([1.0, 0, 0])))
    m.set_transform(np.asarray(psdr.transform.scale(jnp.asarray([2.0, 2.0, 2.0]))))
    md = m.configure_data()
    # scale(2) @ translate(1,0,0): v0 -> (2, 0, 0)
    np.testing.assert_allclose(
        np.asarray(md.vertex_positions[0]), [2.0, 0.0, 0.0], atol=1e-6
    )
    np.testing.assert_allclose(float(md.total_area), 4.0, rtol=1e-6)


def test_sample_position_uniform():
    m = psdr.Mesh()
    m.load_raw(QUAD_V, QUAD_F)
    md = m.configure_data()
    u = Sampler(0, jnp.arange(100_000, dtype=jnp.uint32)).next_2d()
    ps = sample_position(md, u)
    p = np.asarray(ps.p)
    assert p[:, 0].min() >= -1e-6 and p[:, 0].max() <= 1 + 1e-6
    # uniform over the unit square
    assert abs(p[:, 0].mean() - 0.5) < 5e-3
    assert abs(p[:, 1].mean() - 0.5) < 5e-3
    np.testing.assert_allclose(np.asarray(ps.pdf), 1.0, rtol=1e-5)


def test_obj_roundtrip(tmp_path):
    m = psdr.Mesh()
    m.load_raw(QUAD_V, QUAD_F)
    path = str(tmp_path / "quad.obj")
    m.dump(path)
    m2 = psdr.Mesh().load(path)
    np.testing.assert_allclose(
        np.asarray(m2.vertex_positions_raw), QUAD_V, atol=1e-5
    )
    np.testing.assert_array_equal(m2.face_indices, QUAD_F)


def test_vertex_gradient_flows_through_configure():
    """d(total_area)/d(vertex) must be exact (differentiable scene compile)."""
    m = psdr.Mesh()
    m.load_raw(QUAD_V, QUAD_F)

    def area(v):
        return m.configure_data(vertex_positions_raw=v).total_area

    g = jax.grad(area)(jnp.asarray(QUAD_V))
    # moving vertex 1 (corner (1,0)) in +x grows triangle 0:
    # area of tri(0,1,2) wrt x1 = d(0.5*x1*?)  -> FD check instead
    eps = 1e-3
    vp = jnp.asarray(QUAD_V).at[1, 0].add(eps)
    vm = jnp.asarray(QUAD_V).at[1, 0].add(-eps)
    fd = (float(area(vp)) - float(area(vm))) / (2 * eps)
    np.testing.assert_allclose(float(g[1, 0]), fd, rtol=1e-3, atol=1e-5)


def test_tri_perm_staleness_monitor():
    """Two initially-overlapping meshes share Morton clusters; pulling one
    far away makes those clusters span the gap — staleness detects it and
    refresh_tri_perm rebuilds the ordering."""
    import psdr_jax as psdr
    from psdr_jax.core import transform as xf

    rng = np.random.default_rng(0)
    sc = psdr.Scene()
    sc.opts.width = sc.opts.height = 8
    sc.opts.spp = 1
    sc.add_Sensor(psdr.PerspectiveCamera(40.0))
    sc.add_BSDF(psdr.DiffuseBSDF([0.5] * 3), "d")
    # two OVERLAPPING blobs, >256 faces total so the perm is built: Morton
    # interleaves their triangles into shared clusters
    for k in range(2):
        m = psdr.Mesh()
        m.enable_edges = False
        v = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        f = rng.integers(0, 200, (200, 3)).astype(np.int32)
        m.load_raw(v, f)
        sc.add_Mesh(m, None, "d")
    sc.configure()
    assert sc._tri_perm is not None
    assert abs(sc.tri_perm_staleness() - 1.0) < 1e-6
    assert not sc.refresh_tri_perm()

    # drag mesh 1 far away: every mixed cluster now spans the gap
    sc.meshes[1].to_world_raw = jnp.asarray(
        np.asarray(xf.translate(jnp.asarray([100.0, 0.0, 0.0]))), jnp.float32
    )
    stale = sc.tri_perm_staleness()
    assert stale > 1.25, stale
    assert sc.refresh_tri_perm()
    assert abs(sc.tri_perm_staleness() - 1.0) < 1e-6
    assert sc._data is None  # cached scene data invalidated
