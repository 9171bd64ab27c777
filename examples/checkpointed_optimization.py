"""Checkpoint / resume for inverse-rendering optimization.

The reference has no framework-level checkpointing (SURVEY.md §5) — its
persistence is Mesh.dump() + EXR writes, with determinism from explicit
seeds.  Here the same determinism contract plus orbax gives full
resume-exactly semantics for long optimizations: parameters, optimizer
state, and iteration counter round-trip through a checkpoint directory.

Run: JAX_PLATFORMS=cpu python examples/checkpointed_optimization.py
"""

import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import shutil
import tempfile

import numpy as np
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp

import psdr_jax as psdr
from scenes import make_cbox


def main():
    ckpt_dir = tempfile.mkdtemp(prefix="psdr_ckpt_")
    sc = make_cbox(width=32, height=32, spp=4)
    sc.configure()
    integ = psdr.PathTracer(1)
    bsdf = sc.param_map["BSDF[id=white]"]
    true_alb = jnp.asarray(bsdf.reflectance.data)
    target = np.asarray(integ.renderC(sc, 0, seed=3))

    def loss_fn(alb, seed):
        bsdf.reflectance.data = alb
        img = integ.renderD(sc, 0, seed=seed)
        return jnp.mean(jnp.square(img - target))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(5e-2)

    mngr = ocp.CheckpointManager(ckpt_dir)

    def run(start_state, start_it, n_iters):
        params, opt_state = start_state
        for it in range(start_it, n_iters):
            loss, g = grad_fn(params, jnp.uint32(it))
            updates, opt_state = opt.update(g, opt_state)
            params = optax.apply_updates(params, updates)
            mngr.save(it, args=ocp.args.StandardSave(
                {"params": params, "opt_state": opt_state}))
        mngr.wait_until_finished()
        return params, opt_state, float(loss)

    init = (true_alb * 0.3, opt.init(true_alb * 0.3))

    # straight run of 20 iters
    p_full, _, loss_full = run(init, 0, 20)

    # interrupted run: 10 iters, then restore and continue to 20
    run(init, 0, 10)
    restored = mngr.restore(9, args=ocp.args.StandardRestore(
        {"params": init[0], "opt_state": init[1]}))
    p_resumed, _, loss_resumed = run(
        (restored["params"], restored["opt_state"]), 10, 20)

    same = np.allclose(np.asarray(p_full), np.asarray(p_resumed), atol=1e-6)
    print(f"final loss: straight {loss_full:.3e}  resumed {loss_resumed:.3e}")
    print("resume == straight run:", same)
    bsdf.reflectance.data = true_alb
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert same


if __name__ == "__main__":
    main()
