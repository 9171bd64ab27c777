"""Ray-triangle intersection backend tests.

The detached intersection contract is the OptiX payload
(reference scene_optix.cpp:400-404): (global_tri_id, valid, uv, t).
Both backends (blocked JAX brute force and the Triton kernel, see
test_intersect_pallas.py) must agree with a plain numpy O(N*F) oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psdr_jax.core.types import Ray, RAY_EPSILON
from psdr_jax.ops.intersect import ray_intersect_brute, ray_intersect_detached


def _numpy_oracle(p0, e1, e2, ro, rd):
    """Reference closest hit, numpy double precision."""
    p0, e1, e2 = (np.asarray(x, np.float64) for x in (p0, e1, e2))
    ro, rd = np.asarray(ro, np.float64), np.asarray(rd, np.float64)
    n, f = ro.shape[0], p0.shape[0]
    best_t = np.full(n, 1e30)
    best_id = np.full(n, -1, np.int32)
    best_uv = np.zeros((n, 2))
    for j in range(f):
        h = np.cross(rd, e2[j])
        a = (e1[j] * h).sum(-1)
        live = np.abs(a) > 1e-12
        fden = np.where(live, 1.0 / np.where(a == 0, 1.0, a), 0.0)
        s = ro - p0[j]
        u = fden * (s * h).sum(-1)
        q = np.cross(s, e1[j])
        v = fden * (rd * q).sum(-1)
        t = fden * (e2[j] * q).sum(-1)
        hit = live & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > RAY_EPSILON)
        closer = hit & (t < best_t)
        best_t = np.where(closer, t, best_t)
        best_id = np.where(closer, j, best_id)
        best_uv[closer] = np.stack([u, v], -1)[closer]
    return best_id, best_uv, best_t


def _random_scene(n_tri=97, n_ray=513, seed=0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.7, 0.7, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.7, 0.7, (n_tri, 3)).astype(np.float32)
    ro = rng.uniform(-2, 2, (n_ray, 3)).astype(np.float32)
    rd = rng.normal(size=(n_ray, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return p0, e1, e2, ro, rd


def _check_against_oracle(tri_id, uv, t, p0, e1, e2, ro, rd):
    oid, ouv, ot = _numpy_oracle(p0, e1, e2, ro, rd)
    tri_id, uv, t = np.asarray(tri_id), np.asarray(uv), np.asarray(t)
    # ids may differ only where two hits are within f32 noise of each other
    close_call = np.abs(t - ot) < 1e-4 * np.maximum(1.0, np.abs(ot))
    agree = (tri_id == oid) | (close_call & (tri_id >= 0) == (oid >= 0))
    assert agree.mean() > 0.995, f"id mismatch rate {1 - agree.mean():.4f}"
    same = tri_id == oid
    np.testing.assert_allclose(t[same & (oid >= 0)], ot[same & (oid >= 0)],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(uv[same & (oid >= 0)], ouv[same & (oid >= 0)],
                               rtol=1e-2, atol=1e-3)


def test_brute_matches_oracle():
    p0, e1, e2, ro, rd = _random_scene()
    tri_id, valid, uv, t = ray_intersect_brute(
        jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(ro), jnp.asarray(rd),
    )
    assert np.asarray(valid).any()
    _check_against_oracle(tri_id, uv, t, p0, e1, e2, ro, rd)


def test_brute_blocked_paths_agree():
    """Exercise the multi-ray-chunk and multi-tri-chunk code paths."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=300, n_ray=3000, seed=1)
    args = [jnp.asarray(x) for x in (p0, e1, e2, ro, rd)]
    a = ray_intersect_brute(*args, ray_chunk=512, tri_chunk=64)
    b = ray_intersect_brute(*args, ray_chunk=4096, tri_chunk=512)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_allclose(np.asarray(a[3]), np.asarray(b[3]), rtol=1e-5)


def test_detached_entrypoint_masks_nan_rays():
    p0, e1, e2, ro, rd = _random_scene(n_tri=16, n_ray=32, seed=2)
    ro[0] = np.nan
    tri_id, valid, uv, t = ray_intersect_detached(
        jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2),
        Ray(jnp.asarray(ro), jnp.asarray(rd)),
    )
    assert not bool(valid[0])
    assert int(tri_id[0]) == -1


def test_detached_respects_active_mask():
    p0, e1, e2, ro, rd = _random_scene(n_tri=16, n_ray=64, seed=3)
    active = jnp.asarray(np.arange(64) % 2 == 0)
    tri_id, valid, uv, t = ray_intersect_detached(
        jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2),
        Ray(jnp.asarray(ro), jnp.asarray(rd)), active=active,
    )
    assert not np.asarray(valid)[1::2].any()


def test_detached_scrubs_rays_for_bvh_scale_scenes(monkeypatch):
    """Each backend gets the dead lanes in the form it needs, at every
    scene size: the blocked reference (whose min-reductions a NaN t would
    poison) gets harmless substitute rays, the kernel gets the lanes
    flagged dead in its active mask."""
    import psdr_jax.ops.intersect as inter
    from psdr_jax.ops import intersect_pallas as ip

    f = inter.LARGE_SCENE_TRIS + 8
    rng = np.random.default_rng(5)
    p0 = jnp.asarray(rng.uniform(-1, 1, (f, 3)), jnp.float32)
    e1 = jnp.asarray(rng.uniform(-1, 1, (f, 3)), jnp.float32)
    e2 = jnp.asarray(rng.uniform(-1, 1, (f, 3)), jnp.float32)
    ro = np.zeros((16, 3), np.float32)
    rd = np.tile(np.asarray([[0, 0, 1.0]], np.float32), (16, 1))
    ro[3] = np.nan
    rd[7] = np.inf

    seen = {}

    def fake(name):
        def run(p0, e1, e2, o2, d2, active=None, **kw):
            seen[name] = (np.asarray(o2), np.asarray(d2),
                          None if active is None else np.asarray(active))
            n = o2.shape[0]
            return (jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool),
                    jnp.zeros((n, 2), jnp.float32), jnp.full((n,), 1e30))
        return run

    monkeypatch.setattr(ip, "ray_intersect_pallas", fake("kernel"))
    monkeypatch.setattr(inter, "ray_intersect_brute", fake("brute"))
    ray = Ray(jnp.asarray(ro), jnp.asarray(rd))
    inter.ray_intersect_detached(p0, e1, e2, ray, backend="pallas")
    inter.ray_intersect_detached(p0, e1, e2, ray, backend="brute")
    o, d, _ = seen["brute"]
    assert np.isfinite(o).all() and np.isfinite(d).all()
    _, _, active = seen["kernel"]
    assert active is not None
    assert not active[3] and not active[7] and active.sum() == 14


@pytest.mark.parametrize("platform,env,expect", [
    ("gpu", None, "pallas"),
    ("cpu", None, "brute"),
    ("gpu", "brute", "brute"),
    ("cpu", "interpret", "interpret"),
    ("gpu", "pallas", "pallas"),
])
def test_backend_dispatch(monkeypatch, platform, env, expect):
    """Only a GPU gets the compiled kernel unasked; PSDR_INTERSECT
    overrides; nothing falls back to the reference on a GPU."""
    import psdr_jax.ops.intersect as inter

    monkeypatch.setattr(inter.jax, "default_backend", lambda: platform)
    if env is None:
        monkeypatch.delenv("PSDR_INTERSECT", raising=False)
    else:
        monkeypatch.setenv("PSDR_INTERSECT", env)
    assert inter.intersect_backend() == expect
    assert inter.intersect_backend("brute") == "brute"


def test_backend_dispatch_rejects_unknown_values(monkeypatch):
    import psdr_jax.ops.intersect as inter

    monkeypatch.setenv("PSDR_INTERSECT", "tile-bvh")
    with pytest.raises(ValueError):
        inter.intersect_backend()


def test_detached_dispatch_reaches_the_kernel_on_gpu(monkeypatch):
    """With the backend reported as a GPU the scene-layer entry point
    calls the kernel (here swapped for its interpreted form)."""
    import psdr_jax.ops.intersect as inter
    from psdr_jax.ops import intersect_pallas as ip

    calls = []
    real = ip.ray_intersect_pallas

    def spy(*a, **kw):
        calls.append(kw.get("interpret"))
        return real(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(inter.jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("PSDR_INTERSECT", raising=False)
    monkeypatch.setattr(ip, "ray_intersect_pallas", spy)
    p0, e1, e2, ro, rd = _random_scene(n_tri=20, n_ray=40, seed=6)
    got = inter.ray_intersect_detached(
        *(jnp.asarray(x) for x in (p0, e1, e2)),
        Ray(jnp.asarray(ro), jnp.asarray(rd)))
    assert calls == [False]
    ref = ray_intersect_brute(*(jnp.asarray(x) for x in (p0, e1, e2, ro, rd)))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_large_scene_predicate():
    import psdr_jax.ops.intersect as inter

    class _SD:
        def __init__(self, n):
            self.face_mesh_id = np.zeros((n,), np.int32)

    assert not inter.is_large_scene(None)
    assert not inter.is_large_scene(_SD(inter.LARGE_SCENE_TRIS))
    assert inter.is_large_scene(_SD(inter.LARGE_SCENE_TRIS + 1))
