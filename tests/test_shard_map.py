"""Explicit shard_map training step: psum-combined gradients over the
virtual 8-device mesh must match the single-device gradient exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh
from psdr_jax.parallel.shard import train_step_example
from scenes import make_cbox


def test_shard_map_grad_matches_single_with_edges():
    """Edge lanes partitioned across devices + psum'd edge image must give
    the same gradient as the single-device renderD."""
    sc = make_cbox(width=16, height=16, spp=4, sppe=4, sppse=4)
    sc.configure()
    integ = psdr.PathTracer(1)
    mesh_obj = sc.meshes[-1]
    base_raw = mesh_obj.to_world_raw
    target = np.asarray(integ.renderC(sc, 0, seed=9)) * 0.8

    def param_get():
        return {"tx": jnp.float32(0.0)}

    def param_set(p):
        mesh_obj.to_world_raw = base_raw.at[0, 3].add(p["tx"])

    mesh = make_device_mesh(8)
    loss_sh, grads_sh = train_step_example(
        sc, integ, mesh, param_get, param_set, target, seed=9
    )

    def loss_fn(tx):
        mesh_obj.to_world_raw = base_raw.at[0, 3].add(tx)
        img = integ.renderD(sc, 0, seed=9)
        return jnp.sum(jnp.square(img - target))

    loss_1, grad_1 = jax.value_and_grad(loss_fn)(jnp.float32(0.0))
    mesh_obj.to_world_raw = base_raw

    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(
        float(grads_sh["tx"]), float(grad_1), rtol=1e-3, atol=1e-7
    )
    assert abs(float(grad_1)) > 0


def test_shard_map_grad_matches_single():
    sc = make_cbox(width=16, height=16, spp=4)
    sc.configure()
    integ = psdr.PathTracer(1)
    em = sc.emitters[0]
    base_r = em.radiance
    target = np.asarray(integ.renderC(sc, 0, seed=9)) * 0.8

    def param_get():
        return {"radiance": base_r}

    def param_set(p):
        em.radiance = p["radiance"]

    mesh = make_device_mesh(8)
    loss_sh, grads_sh = train_step_example(
        sc, integ, mesh, param_get, param_set, target, seed=9
    )

    # single-device reference
    def loss_fn(r):
        em.radiance = r
        img = integ.renderD(sc, 0, seed=9)
        return jnp.sum(jnp.square(img - target))

    loss_1, grad_1 = jax.value_and_grad(loss_fn)(base_r)
    em.radiance = base_r

    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grads_sh["radiance"]), np.asarray(grad_1), rtol=1e-4
    )
    assert np.abs(np.asarray(grad_1)).max() > 0
