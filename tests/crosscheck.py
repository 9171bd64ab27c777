"""Cross-backend gradient oracle workload.

One deterministic small-cbox training step — loss + parameter gradients
with ALL THREE estimators (interior + primary-edge + secondary-edge) —
computed with the same algorithm on any backend.  The card-only test
(tests/test_chip.py) and bench.py run it on the GPU in-process and on the
CPU in a child process and compare: both backends consume the IDENTICAL
sample set (counter-based pcg4d sampler, fixed seed), so there is zero
Monte-Carlo noise between them and the comparison isolates BACKEND float
semantics: TF32 matmuls, a broken exact-gather split, reductions in
another order.

Why CPU f32 (not f64): the pipeline's dtypes are explicitly f32
throughout, so x64 mode would not change them; same-dtype CPU execution is
the exact oracle for backend semantic divergence.  Residual GPU-vs-CPU
differences come from f32 reduction order (atomic scatter-adds on the GPU)
and a handful of chaotic visibility-test lanes; the tolerances are in
``TOL`` below.

Subprocess entry::

    JAX_PLATFORMS=cpu python tests/crosscheck.py --cpu out.npz

forces the CPU platform and writes loss/grads to ``out.npz``.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (_HERE, os.path.dirname(_HERE)):  # tests/ and the repo root
    if _p not in sys.path:
        sys.path.insert(0, _p)

WIDTH = 48
DEPTH = 2
SPP = SPPE = SPPSE = 4
SEED = 5

# GPU-vs-CPU tolerances: relative loss, sum-abs image and max-leaf
# sum-abs gradient divergence (see ``compare``).  Calibrated on an H100
# (PERF.md): a healthy tree measured loss 4.9e-5 / 5.4e-5, image
# 1.2e-3 / 1.2e-3 and gradient 5.3e-3 / 6.6e-3 (eager / jitted step);
# each bound sits about ten times above that.
TOL = {"loss": 5e-4, "img": 1e-2, "grad": 0.05}


def within_tolerance(rel) -> bool:
    return bool(rel["finite"]) and all(rel[k] < v for k, v in TOL.items())


def compute(width: int = WIDTH, depth: int = DEPTH, spp: int = SPP,
            sppe: int = SPPE, sppse: int = SPPSE, seed: int = SEED):
    """Returns ``(loss: float, grads: list[np.ndarray], image: np.ndarray)``
    for the canonical oracle workload on the current default backend."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import psdr_jax as psdr
    from scenes import make_cbox

    sc = make_cbox(width=width, height=width, spp=spp, sppe=sppe,
                   sppse=sppse)
    sc.configure()
    integ = psdr.PathTracer(max_depth=depth)
    mesh, em = sc.meshes[-1], sc.emitters[0]
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jnp.asarray(
        np.random.default_rng(0).random((width * width, 3)), np.float32
    )

    def apply(p):
        dv, dr = p
        mesh.vertex_positions_raw = bv + dv
        em.radiance = br + dr

    def ploss(rows, pix):
        return jnp.sum(jnp.square(rows - target[pix]), axis=-1)

    p0 = (jnp.zeros_like(bv), jnp.zeros_like(br))
    try:
        # one jitted program: run eagerly, the step would compile every
        # primitive on its own (hundreds of compiles on a GPU)
        step = jax.jit(lambda p: integ.loss_and_grad(sc, p, apply, ploss,
                                                     seed=seed))
        loss, grads, image = step(p0)
    finally:
        mesh.vertex_positions_raw = bv
        em.radiance = br
    return (float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            np.asarray(image))


def compare(a, b):
    """Relative divergences between two ``compute`` results: dict with
    ``loss`` (rel), ``grad`` (max over leaves of sum-abs-diff / sum-abs),
    ``img`` (sum-abs rel), ``finite``."""
    import numpy as np

    la, ga, ia = a
    lb, gb, ib = b
    rel_loss = abs(la - lb) / (abs(la) + 1e-12)
    rel_grad = max(
        float(np.abs(x - y).sum() / (np.abs(x).sum() + 1e-12))
        for x, y in zip(ga, gb)
    )
    rel_img = float(np.abs(ia - ib).sum() / (np.abs(ia).sum() + 1e-12))
    finite = (np.isfinite(lb) and np.isfinite(ib).all()
              and all(np.isfinite(g).all() for g in gb))
    return {"loss": rel_loss, "grad": rel_grad, "img": rel_img,
            "finite": bool(finite)}


def start_cpu_child(path):
    """Start the CPU half in a child process that opens no card; returns
    the ``subprocess.Popen``.  The caller computes its half meanwhile."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PSDR_TEST_ON_CARD", None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu", path],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def compute_beside(proc):
    """:func:`compute` on this process's backend while ``proc`` (from
    :func:`start_cpu_child`) runs; the child is stopped if it raises."""
    try:
        return compute()
    except BaseException:
        proc.kill()
        proc.wait()
        raise


def finish_cpu_child(proc, path, timeout: float = 1200.0):
    """Wait for :func:`start_cpu_child`'s child and load its result."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    if proc.returncode != 0:
        tail = (err or b"").decode(errors="replace")[-800:]
        raise RuntimeError(f"cpu oracle child failed: {tail}")
    return load(path)


def save(path, result):
    import numpy as np

    loss, grads, image = result
    np.savez(path, loss=np.float64(loss), image=image,
             **{f"g{i}": g for i, g in enumerate(grads)})


def load(path):
    import numpy as np

    with np.load(path) as z:
        grads = [z[f"g{i}"] for i in range(sum(k.startswith("g")
                                               for k in z.files))]
        return float(z["loss"]), grads, z["image"]


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    if "--cpu" in args:
        args.remove("--cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
    out_path = args[0]
    save(out_path, compute())
    print("crosscheck written:", out_path)
