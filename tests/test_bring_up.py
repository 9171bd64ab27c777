"""The GPU bring-up's CPU-side contracts: where the compile cache lands,
that the on-card entry points refuse to run without a card, that the smoke
run's phases run through at a tiny size, the bench's
peak table, and that gradients through the intersection kernel equal
gradients through the blocked reference."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("import jax, psdr_jax; "
          "print(repr(jax.config.jax_compilation_cache_dir)); "
          "print(jax.config.jax_persistent_cache_min_compile_time_secs)")


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "PSDR_NO_COMPILE_CACHE", "PSDR_TEST_ON_CARD")}
    env.update(kw)
    return env


def _probe_cache(**kw):
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(**kw), capture_output=True, text=True,
                         check=True).stdout.split("\n")
    return eval(out[0]), float(out[1])  # noqa: S307 (our own repr)


@pytest.mark.parametrize("env,expect", [
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, "/somewhere/else"),
    ({"JAX_PLATFORMS": "cpu"}, None),
    ({"PSDR_NO_COMPILE_CACHE": "1"}, None),
])
def test_compile_cache_placement(env, expect):
    """Unset platforms: one fixed path inside the checkout; a set
    JAX_COMPILATION_CACHE_DIR is used as it is; CPU runs stay uncached."""
    cache_dir, min_secs = _probe_cache(**env)
    assert cache_dir == expect
    if expect is not None:
        assert min_secs == 0.0  # every executable is cached


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


def test_chip_smoke_refuses_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repository, the
    script fails before it prints any result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(JAX_PLATFORMS="cpu", PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


def test_chip_smoke_rehearsal_runs_every_phase():
    """``--rehearse`` runs every phase at a tiny size on the CPU (the kernel
    through the Pallas interpreter): it checks the phases' control flow,
    never exits 0 and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                          cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 3, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert _no_result(proc.stdout)
    for name in ("kernel", "numerics", "main"):
        assert f"== phase {name} ok" in proc.stdout, name
    assert "headline_step_ms" in proc.stdout


def test_bench_peak_table_refuses_unknown_device():
    sys.path.insert(0, ROOT)
    import bench

    assert bench.peak_rates("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    for kind in ("NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="no published peak"):
            bench.peak_rates(kind)
    with pytest.raises(ValueError):
        bench.intersect_roofline_mrays("cpu", 32)


def test_bench_roofline_scales_with_triangles():
    sys.path.insert(0, ROOT)
    import bench

    kind = "NVIDIA H100 80GB HBM3"
    a = bench.intersect_roofline_mrays(kind, 32)
    assert a == pytest.approx(67e12 / (32 * bench.MT_FLOPS) / 1e6)
    assert bench.intersect_roofline_mrays(kind, 64) == pytest.approx(a / 2)


def test_bench_refuses_without_gpu():
    proc = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                          env=_env(JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


def _grads_through(backend, fused):
    """Gradients of an L2 loss w.r.t. block vertices and light radiance on
    a small cbox, every intersection through ``backend``."""
    import jax
    import jax.numpy as jnp
    import psdr_jax as psdr
    from scenes import make_cbox

    os.environ["PSDR_INTERSECT"] = backend
    try:
        sc = make_cbox(width=8, height=8, spp=2, sppe=2, sppse=2)
        sc.configure()
        integ = psdr.PathTracer(max_depth=1)
        mesh, em = sc.meshes[-1], sc.emitters[0]
        bv, br = mesh.vertex_positions_raw, em.radiance
        target = jnp.full((64, 3), 0.2, jnp.float32)

        def apply(p):
            mesh.vertex_positions_raw = bv + p[0]
            em.radiance = br + p[1]

        p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
        if fused:
            def ploss(rows, pix):
                return jnp.sum(jnp.square(rows - target[pix]), axis=-1)
            loss, g, _ = integ.loss_and_grad(sc, p0, apply, ploss, seed=3)
        else:
            def f(p):
                apply(p)
                return jnp.sum(jnp.square(integ.renderD(sc, 0, seed=3)
                                          - target))
            loss, g = jax.value_and_grad(f)(p0)
        apply(p0)
        mesh.vertex_positions_raw, em.radiance = bv, br
        return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]
    finally:
        os.environ.pop("PSDR_INTERSECT")


@pytest.mark.parametrize("fused", [False, True], ids=["renderD", "fused"])
def test_gradients_through_kernel_equal_reference(fused):
    """jax.grad of renderD and the fused step: the (interpreted) kernel and
    the blocked reference give the same hits, hence the same loss and
    gradients up to float32 rounding."""
    lk, gk = _grads_through("interpret", fused)
    lb, gb = _grads_through("brute", fused)
    assert np.isfinite(lk) and lk > 0
    np.testing.assert_allclose(lk, lb, rtol=1e-5)
    for a, b in zip(gk, gb):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())
