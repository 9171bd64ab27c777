"""Inverse-rendering workflow tests (BASELINE configs #4 and #5).

#4: multi-sensor batch rendering + Adam optimization of BSDF albedo and
    emitter radiance.
#5 (scaled down): vertex/translation recovery with edge terms, with the
    loss+gradient jitted and the pixel axis shardable.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

import psdr_jax as psdr
from scenes import make_cbox


def _two_sensor_cbox(w=16, spp=4):
    sc = make_cbox(width=w, height=w, spp=spp)
    cam2 = psdr.PerspectiveCamera(39.0, 1e-6, 1e7)
    cam2.to_world = np.asarray(
        [[0.9397, 0, 0.342, 100.0], [0, 1, 0, 273.0],
         [-0.342, 0, 0.9397, -700.0], [0, 0, 0, 1.0]], np.float32
    )
    sc.add_Sensor(cam2)
    sc.configure()
    return sc


def test_multi_sensor_renders_differ():
    sc = _two_sensor_cbox()
    integ = psdr.PathTracer(1)
    a = np.asarray(integ.renderC(sc, 0, seed=0))
    b = np.asarray(integ.renderC(sc, 1, seed=0))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.allclose(a, b)


def test_adam_recovers_albedo_and_radiance():
    """Config #4: joint albedo+radiance recovery from 2 views."""
    sc = _two_sensor_cbox(w=16, spp=4)
    integ = psdr.PathTracer(1)
    bsdf = sc.param_map["BSDF[id=white]"]
    em = sc.emitters[0]
    true_alb = jnp.asarray(bsdf.reflectance.data)
    true_rad = jnp.asarray(em.radiance)
    targets = [np.asarray(integ.renderC(sc, s, seed=7)) for s in (0, 1)]

    def loss_fn(alb, rad, seed):
        bsdf.reflectance.data = alb
        em.radiance = rad
        l = 0.0
        for s in (0, 1):
            img = integ.renderD(sc, s, seed=seed)
            l = l + jnp.mean(jnp.square(img - targets[s]))
        return l

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))

    alb = true_alb * 0.4
    rad = true_rad * 2.5
    opt = optax.adam(5e-2)
    # optimize log-radiance alongside albedo for scale robustness
    params = (alb, jnp.log(rad))
    state = opt.init(params)

    losses = []
    for it in range(60):
        a, lr = params
        loss, g = grad_fn(a, jnp.exp(lr), jnp.uint32(7))
        g = (g[0], g[1] * jnp.exp(lr))  # chain rule to log space
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params = (jnp.clip(params[0], 0.0, 1.0), params[1])
        losses.append(float(loss))

    alb, rad = params[0], jnp.exp(params[1])
    bsdf.reflectance.data = true_alb
    em.radiance = true_rad
    assert losses[-1] < 0.05 * losses[0], losses[::10]
    np.testing.assert_allclose(np.asarray(alb).ravel(),
                               np.asarray(true_alb).ravel(), atol=0.15)
    np.testing.assert_allclose(np.asarray(rad), np.asarray(true_rad),
                               rtol=0.25)


@pytest.mark.slow
def test_translation_recovery_with_edges():
    """Config #5 (scaled down): recover a block translation; the gradient
    needs the boundary terms (the interior term alone under-estimates
    silhouette motion)."""
    sc = make_cbox(width=24, height=24, spp=4, sppe=4, sppse=4)
    sc.configure()
    integ = psdr.PathTracer(1)
    mesh = sc.meshes[-1]
    base_raw = mesh.to_world_raw
    target = np.asarray(integ.renderC(sc, 0, seed=11))

    def loss_fn(tx, seed):
        mesh.to_world_raw = base_raw.at[0, 3].add(tx)
        img = integ.renderD(sc, 0, seed=seed)
        return jnp.mean(jnp.square(img - target))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    tx = jnp.float32(40.0)  # cbox units; initial offset
    opt = optax.adam(8.0)
    state = opt.init(tx)
    path = [float(tx)]
    for it in range(40):
        loss, g = grad_fn(tx, jnp.uint32(11 + it))
        updates, state = opt.update(g, state)
        tx = optax.apply_updates(tx, updates)
        path.append(float(tx))
    mesh.to_world_raw = base_raw
    assert abs(path[-1]) < 0.35 * abs(path[0]), path[::8]
