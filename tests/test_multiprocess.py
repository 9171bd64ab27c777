"""Multi-host (multi-process) execution of the sharded training step.

SURVEY.md §2.5 names multi-host execution as a first-class component.
This test spawns TWO
separate OS processes connected through ``jax.distributed.initialize``
(coordinator + worker), each owning 4 virtual CPU devices, and runs the
shard_map training step over the resulting 8-device global mesh — the
code path two hosts run, with cross-process collectives in place of the
network between them.

The global-lane RNG contract makes the sharded estimate equal the
single-process one; we assert the distributed loss+grad matches a
single-process 8-virtual-device run.
"""

import os
import socket
import subprocess
import sys
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh
from psdr_jax.parallel.shard import train_step_example
from scenes import make_cbox

_HERE = os.path.dirname(os.path.abspath(__file__))

_WORKER = r"""
import os, sys, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc

import numpy as np
import jax.numpy as jnp
sys.path.insert(0, %(here)r)
import psdr_jax as psdr
from psdr_jax.parallel.mesh import make_device_mesh
from psdr_jax.parallel.shard import train_step_example
from scenes import make_cbox

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

mesh = make_device_mesh(4 * nproc)  # global mesh spanning both processes
loss, grads = train_step_example(
    sc, integ, mesh, param_get, param_set, target, seed=9
)
out = {"loss": float(loss), "tx": float(grads["tx"])}
if pid == 0:
    print("RESULT " + json.dumps(out))
jax.distributed.shutdown()
""" % {"here": _HERE}


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_training_step_matches_single():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", "-c", _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    result_line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    assert result_line, f"no RESULT from coordinator:\n{outs[0]}"
    dist = json.loads(result_line[0][len("RESULT "):])

    # single-process reference on the same 8-virtual-device topology
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
    loss, grads = train_step_example(
        sc, integ, mesh, param_get, param_set, target, seed=9
    )
    np.testing.assert_allclose(dist["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(dist["tx"], float(grads["tx"]),
                               rtol=1e-4, atol=1e-8)
