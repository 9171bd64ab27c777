"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The deterministic per-lane sample streams make any pixel partition reproduce
the full-frame sample set exactly (SURVEY.md §2.5) — so a sharded render must
equal the single-device render bitwise-ish.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh, render_sharded
from scenes import make_cbox


@pytest.fixture(scope="module")
def cbox():
    sc = make_cbox(width=32, height=32, spp=4)
    sc.configure()
    return sc


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_matches_single(cbox):
    integ = psdr.PathTracer(max_depth=1)
    single = np.asarray(integ.renderC(cbox, 0, seed=3))
    mesh = make_device_mesh(8)
    sharded = np.asarray(
        render_sharded(integ, cbox, mesh, sensor_id=0, seed=3)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-7)


def test_sharded_bvh_path_matches_single(monkeypatch):
    """Sharding x the intersection kernel: a many-chunk scene rendered
    through the Triton kernel (PSDR_INTERSECT=interpret runs the kernel
    program through the Pallas interpreter) on the 8-device mesh equals
    the single-device render."""
    from scenes import make_gallery

    monkeypatch.setenv("PSDR_INTERSECT", "interpret")
    sc = make_gallery(width=16, height=16, spp=1, n_spheres=4, subdiv=1)
    sc.configure()
    n_tris = sum(m.num_faces for m in sc.meshes)
    assert n_tris > 256  # many kernel chunks, culling on
    integ = psdr.PathTracer(max_depth=1)
    single = np.asarray(integ.renderC(sc, 0, seed=3))
    mesh = make_device_mesh(8)
    sharded = np.asarray(
        render_sharded(integ, sc, mesh, sensor_id=0, seed=3)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-7)


def test_sharded_envmap_alias_matches_single():
    """shard_map x (envmap alias importance tables, packed bilinear
    fetches, microfacet BSDF, the 4968-tri bunny through the kernel): the
    sharded differentiable render equals single-device.  Covers the paths
    the cbox-class sharding tests never touch."""
    import os
    from scenes import make_bunny_envmap

    try:
        sc = make_bunny_envmap(width=16, height=16, spp=2, sppe=2, sppse=2)
    except FileNotFoundError:
        pytest.skip("reference tutorial assets unavailable")
    old = os.environ.get("PSDR_INTERSECT")
    os.environ["PSDR_INTERSECT"] = "interpret"
    try:
        sc.configure()
        integ = psdr.PathTracer(max_depth=1)
        single = np.asarray(integ.renderD(sc, 0, seed=5))
        mesh = make_device_mesh(8)
        sharded = np.asarray(
            render_sharded(integ, sc, mesh, sensor_id=0, seed=5, kind="D")
        )
    finally:
        if old is None:
            os.environ.pop("PSDR_INTERSECT", None)
        else:
            os.environ["PSDR_INTERSECT"] = old
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-7)


def test_sharded_grad_matches_single(cbox):
    """Gradient of the sharded render == gradient of the single render."""
    sc = make_cbox(width=16, height=16, spp=4, sppe=4, sppse=4)
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    mesh_obj = sc.meshes[-1]
    base = mesh_obj.to_world_raw
    mesh = make_device_mesh(8)

    def mean_single(tx):
        mesh_obj.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(integ.renderD(sc, 0, seed=0))

    def mean_sharded(tx):
        mesh_obj.to_world_raw = base.at[0, 3].add(tx)
        return jnp.mean(
            render_sharded(integ, sc, mesh, sensor_id=0, seed=0, kind="D")
        )

    _, g1 = jax.jvp(mean_single, (jnp.float32(0.0),), (jnp.float32(1.0),))
    _, g2 = jax.jvp(mean_sharded, (jnp.float32(0.0),), (jnp.float32(1.0),))
    mesh_obj.to_world_raw = base
    np.testing.assert_allclose(float(g2), float(g1), rtol=1e-4, atol=1e-9)
