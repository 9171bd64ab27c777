"""BASELINE config #5: room-scale scene (psdr-room style).

~14 meshes, mixed BSDF families (diffuse / microfacet / rough conductor),
FULL edge terms (sppe+sppse), simultaneous vertex-position + pose +
radiance gradients, sharded across the virtual 8-device mesh — the
scene-level optimization gate from BASELINE.md.  The sharded fused
training step must match single-device ``jax.grad(renderD)``.
"""

import numpy as np
import jax
import jax.numpy as jnp

import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh
from psdr_jax.parallel.shard import make_fused_train_step
from scenes import make_room

W = H = 16


def _scene():
    sc = make_room(width=W, height=H, spp=2, sppe=2, sppse=2)
    sc.configure()
    return sc


def test_room_renders_and_is_lit():
    sc = _scene()
    img = np.asarray(psdr.PathTracer(2).renderC(sc, 0, seed=3))
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # lit interior, not a black void
    assert len(sc.meshes) >= 10
    assert img.max() > 1.0    # light panel visible


def test_room_sharded_fused_step_matches_single_device():
    """Vertex + pose + radiance gradients, full edge terms, 8-device
    sharded fused step == single-device jax.grad(renderD)."""
    sc = _scene()
    integ = psdr.PathTracer(1)
    brass = sc.meshes[11]       # rotated brass block (pose parameter)
    prism = sc.meshes[13]       # blue prism (vertex parameter)
    em = sc.emitters[0]
    base_raw = brass.to_world_raw
    base_v = prism.vertex_positions_raw
    base_r = em.radiance
    target = jnp.asarray(
        np.asarray(psdr.PathTracer(1).renderC(sc, 0, seed=11)) * 0.9
    )

    def apply(p):
        brass.to_world_raw = base_raw.at[0, 3].add(p["tx"])
        prism.vertex_positions_raw = base_v + p["dv"]
        em.radiance = base_r + p["dr"]

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    p0 = {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(base_v),
          "dr": jnp.zeros_like(base_r)}

    mesh = make_device_mesh(8)
    step = make_fused_train_step(sc, integ, mesh, apply, ploss)
    loss_sh, g_sh, img_sh = step(p0, seed=11)

    def loss_fn(p):
        apply(p)
        img = integ.renderD(sc, 0, seed=11)
        return jnp.sum(jnp.square(img - target))

    loss_1, g_1 = jax.value_and_grad(loss_fn)(p0)
    brass.to_world_raw = base_raw
    prism.vertex_positions_raw = base_v
    em.radiance = base_r

    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    for k in p0:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_1[k]), rtol=2e-3, atol=1e-6,
            err_msg=k,
        )
    # every parameter class actually receives signal
    assert abs(float(g_1["tx"])) > 0
    assert float(jnp.abs(g_1["dv"]).max()) > 0
    assert float(jnp.abs(g_1["dr"]).max()) > 0


def test_room_batch_pix_bitwise_consistency():
    """The crop/batch seed contract holds on the multi-mesh scene too."""
    sc = _scene()
    integ = psdr.PathTracer(1)
    full = np.asarray(integ.renderC(sc, 0, seed=5))
    rows = np.asarray(
        integ.renderC(sc, 0, seed=5, pix_id=jnp.arange(64, 160))
    )
    np.testing.assert_array_equal(rows, full[64:160])
