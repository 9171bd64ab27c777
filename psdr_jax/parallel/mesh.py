"""Multi-chip scaling: pixels/paths sharded over a jax.sharding.Mesh.

The reference has *no* distributed parallelism (SURVEY.md §2.5) — its scaling
knob is pixel batching (``__render_batch``, integrator.cpp:139-176).  Here the
same seam becomes the shard axis: the deterministic global-sample-index RNG
(see ``core.sampler``) makes any partition of the pixel set reproduce the
full-frame estimate exactly, so sharding pixels over devices is bitwise
consistent with single-chip rendering.

Scene data is tiny (KBs-MBs) and replicated; the image is partial-summed per
shard and combined with a ``psum`` (an NCCL all-reduce over NVLink).  The
mesh is one flat ``pix`` axis: the cards of a host are joined all to all.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_device_mesh(n_devices: int | None = None, axis: str = "pix") -> Mesh:
    devices = np.asarray(jax.devices()[: n_devices or len(jax.devices())])
    return Mesh(devices, (axis,))


def render_sharded(integrator, scene, mesh: Mesh, sensor_id: int = 0,
                   seed: int = 0, kind: str = "C", axis: str = "pix"):
    """Full-frame render with pixels sharded across ``mesh``.

    Every device renders its pixel block with globally-seeded sample streams;
    the (n_pix, 3) image comes out sharded and is gathered lazily by JAX.
    """
    opts = scene.opts
    n_pix = opts.num_pixels
    n_dev = mesh.devices.size
    assert n_pix % n_dev == 0, "pixel count must divide the device count"

    pix = jnp.arange(n_pix, dtype=jnp.int32)
    pix = jax.device_put(pix, NamedSharding(mesh, P(axis)))

    if kind == "C":
        img = integrator.renderC(scene, sensor_id, seed, pix_id=pix)
    else:
        img = integrator.renderD(scene, sensor_id, seed, pix_id=pix)
    return img
