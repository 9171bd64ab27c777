"""Multi-host inverse rendering with ``jax.distributed`` (2 processes).

The reference scales by adding GPUs behind drjit's single-process CUDA
stream; the answer here is SPMD over a global device mesh — each
host runs THIS SAME script, ``jax.distributed.initialize`` stitches the
hosts into one mesh, and the shard_map training step partitions pixel
rows + edge-sample lanes per device and ``psum``s parameter cotangents
over NVLink within a host and the network between hosts
(parallel/shard.py).  The global-lane RNG contract
(SURVEY.md §2.5, integrator/base.py) makes the sharded estimator EQUAL
to the single-host one — scaling changes wall-clock, never the numbers
(asserted by tests/test_multiprocess.py).

On a real cluster each host launches with its own
``coordinator_address``/``num_processes``/``process_id``.  Without a
cluster, this example demonstrates
the same code path by spawning a second local process, each side holding
4 virtual CPU devices:

    python examples/multihost_training.py            # coordinator, spawns peer
    (the peer runs the same file with PSDR_MH_PID=1)
"""

import os
import socket
import subprocess
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

N_PROC = 2
DEV_PER_PROC = 4


def main(pid: int, port: str):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROC, process_id=pid,
    )
    import jax.numpy as jnp
    import numpy as np
    import optax

    import psdr_jax as psdr
    from psdr_jax.parallel.mesh import make_device_mesh
    from psdr_jax.parallel.shard import make_fused_train_step
    from scenes import make_cbox

    log = print if pid == 0 else (lambda *a, **k: None)
    log(f"processes: {jax.process_count()}, "
        f"global devices: {len(jax.devices())}")

    w = 32
    sc = make_cbox(width=w, height=w, spp=4, sppe=2, sppse=2)
    sc.configure()
    integ = psdr.PathTracer(max_depth=1)
    em = sc.emitters[0]
    base_r = em.radiance
    target = jnp.asarray(np.asarray(integ.renderC(sc, 0, seed=11)))
    params = {"radiance": base_r * 1.6}

    def apply_params(p):
        em.radiance = p["radiance"]

    def pixel_loss(rows, pix_ids):
        return jnp.sum(jnp.square(rows - target[pix_ids]), axis=-1)

    mesh = make_device_mesh(N_PROC * DEV_PER_PROC)
    step = make_fused_train_step(sc, integ, mesh, apply_params, pixel_loss)

    opt = optax.adam(0.4)
    opt_state = opt.init(params)
    for it in range(25):
        loss, grads, _ = step(params, 11 + it)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        if it % 5 == 0 or it == 24:
            log(f"iter {it:3d}  loss {float(loss):10.4f}  radiance err "
                f"{float(jnp.abs(params['radiance'] - base_r).max()):.3f}")

    err = float(jnp.abs(params["radiance"] - base_r).max())
    assert err < 0.5 * float(jnp.abs(base_r * 0.6).max()), err
    log("recovered emitter radiance across 2 hosts")
    jax.distributed.shutdown()


if __name__ == "__main__":
    if os.environ.get("PSDR_MH_PID"):
        main(int(os.environ["PSDR_MH_PID"]), os.environ["PSDR_MH_PORT"])
    else:
        with socket.socket() as s:  # free port for the coordinator
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        env = dict(os.environ, PSDR_MH_PID="1", PSDR_MH_PORT=port)
        peer = subprocess.Popen([sys.executable, "-u", __file__], env=env)
        try:
            main(0, port)
        finally:
            # never mask the coordinator's traceback, never orphan the
            # peer: if it doesn't exit on its own (e.g. we failed before
            # initialize and it is still blocked there), kill it
            try:
                peer.wait(timeout=120)
            except subprocess.TimeoutExpired:
                peer.kill()
                peer.wait()
        sys.exit(peer.returncode)
