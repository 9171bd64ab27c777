"""psdr_jax — a path-space differentiable renderer in JAX.

A from-scratch rebuild of the capabilities of ``psdr-jit`` (path-space
differentiable rendering: interior + primary-edge + secondary-edge integrals)
for an accelerator driven from JAX (an NVIDIA GPU):

* wavefront path tracing over SoA sample arrays (``jax.jit`` fused),
* ray/triangle intersection as a Pallas kernel compiled through Triton
  (with a plain-JAX reference that also serves the CPU),
* AD via ``jax.grad`` / ``jax.jvp`` with ``stop_gradient`` placed at the same
  mathematical seams as the reference's C/D (detach) type split,
* pixels/paths sharded over a ``jax.sharding.Mesh`` for multi-device scaling.

Public API mirrors the reference pybind11 module (``/root/reference/src/psdr.cpp:100-441``)
so users of psdr-jit can migrate: ``Scene``, ``RenderOption``, ``Mesh``,
``DiffuseBSDF``/``MicrofacetBSDF``/..., ``AreaLight``, ``EnvironmentMap``,
``PerspectiveCamera``, ``OrthographicCamera``, ``PathTracer``, ``Direct``,
``CollocatedIntegrator``, ``FieldExtractionIntegrator``, ``Bitmap1fD``, ``Bitmap3fD``.
"""

import os as _os

import jax as _jax

# A physically-based differentiable renderer needs true f32 linear algebra:
# on Hopper, float32 matmuls (the transform stacks, the one-hot gathers of
# ops/gather.py) otherwise run on the tensor cores in TF32 (10 mantissa
# bits), which corrupts world transforms at scene scale and silently
# degrades geometry gradients.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the render/loss programs are large, and the
# cache turns every repeat compile — across processes — into a disk read
# (the role of drjit's ~/.drjit kernel cache in the reference).  Where
# JAX_COMPILATION_CACHE_DIR is set, JAX uses that directory and nothing is
# set here.  Otherwise the cache lives at one fixed path inside the
# checkout (the path is part of the cache key, so it must not move).  CPU
# runs stay uncached: their compiles are fast, and XLA's CPU loader warns
# on every cached executable.  Opt out with PSDR_NO_COMPILE_CACHE=1.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
_PLATFORMS = (_jax.config.jax_platforms
              or _os.environ.get("JAX_PLATFORMS", ""))

if not _os.environ.get("PSDR_NO_COMPILE_CACHE") and _PLATFORMS != "cpu":
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache every executable, including the sub-second eager ops that
    # Scene.configure() dispatches; explicit env settings win
    for _k, _v in (("jax_persistent_cache_min_compile_time_secs", 0.0),
                   ("jax_persistent_cache_min_entry_size_bytes", 0)):
        if not _os.environ.get(_k.upper()):
            _jax.config.update(_k, _v)

from .core.types import RenderOption, Ray, Frame, Intersection
from .core.object import Object
from .core.bitmap import Bitmap1f, Bitmap3f
from .core.records import (
    SampleRecord,
    PositionSample,
    SensorDirectSample,
)

# Reference-compatible aliases (drjit C/D type-pair naming): the reference
# exposes detached/attached variants of each record type; here both map to
# the single traced pytree.
Bitmap1fD = Bitmap1f
Bitmap3fD = Bitmap3f
RayC = RayD = Ray
FrameC = FrameD = Frame
# the reference's Interaction base (intersection.h:7-20) is subsumed by the
# single Intersection pytree here
Interaction = Intersection
InteractionC = InteractionD = Intersection
IntersectionC = IntersectionD = Intersection
SampleRecordC = SampleRecordD = SampleRecord
PositionSampleC = PositionSampleD = PositionSample

from .core import transform
from .core.sampler import Sampler
from .core.distribution import DiscreteDistribution

from .shape.mesh import Mesh
from .bsdf.bsdf import BSDF
from .bsdf import (
    DiffuseBSDF,
    MicrofacetBSDF,
    MicrofacetBSDFPerVertex,
    RoughConductorBSDF,
    RoughDielectricBSDF,
    NormalMapBSDF,
)
from .emitter import Emitter, AreaLight, EnvironmentMap
from .sensor import Sensor, PerspectiveCamera, OrthographicCamera
from .scene.scene import Scene
from .scene.loader import load_file, load_string
from .integrator.base import Integrator
from .integrator import (
    PathTracer,
    Direct,
    CollocatedIntegrator,
    FieldExtractionIntegrator,
)

import dataclasses as _dataclasses


@_dataclasses.dataclass
class EdgeSortOption:
    """Bound-but-unused in the reference (types.h:230-237, psdr.cpp:145-151);
    kept for API compatibility with scripts that construct it."""

    enable_sort: bool = False
    local_angle: float = 180.0
    global_angle: float = 90.0
    min_global_step: int = 1
    max_depth: int = 1


@_dataclasses.dataclass
class AQ_Option:
    """Adaptive-quadrature guiding options — dead code in the reference
    (types.h:240-268); accepted for compatibility, currently unused."""

    num_x: int = 1
    num_y: int = 1
    num_z: int = 1
    thold: float = 0.0
    wt1: float = 0.0
    max_depth: int = 0
    final_spp: int = 0
    RMSE_wt: float = 0.0
    eps: float = 0.0


def drjit_test():
    """AD sanity check mirroring the reference's psdr.cpp:70-86 smoke test."""
    import jax
    import jax.numpy as jnp

    g = jax.grad(lambda a: jnp.sum(a * 2.0))(jnp.arange(4.0))
    print("backward grad of sum(2a):", g)
    assert bool((g == 2.0).all())
    return True


def drjit_memory():
    """Array store/readback smoke test (reference psdr.cpp:89-98)."""
    import numpy as np
    import jax.numpy as jnp

    a = jnp.arange(1024, dtype=jnp.float32)
    b = np.asarray(a * 3.0)
    assert b[-1] == (1024 - 1) * 3.0
    return True


def optix_jit_test():
    """Intersection backend smoke test (reference psdr.cpp:65-68): two quads,
    closest-hit ids must resolve front-to-back."""
    import numpy as np
    import jax.numpy as jnp
    from .ops.intersect import ray_intersect_brute

    p0 = jnp.asarray([[-1, -1, 2], [-1, -1, 4]], jnp.float32)
    e1 = jnp.asarray([[2, 0, 0], [2, 0, 0]], jnp.float32)
    e2 = jnp.asarray([[0, 2, 0], [0, 2, 0]], jnp.float32)
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.asarray([[0, 0, 1.0]] * 4, jnp.float32)
    tri_id, valid, uv, t = ray_intersect_brute(p0, e1, e2, ro, rd)
    assert bool(valid.all()) and bool((np.asarray(tri_id) == 0).all())
    print("closest-hit ids:", np.asarray(tri_id), "t:", np.asarray(t))
    return True


__version__ = "0.4.0"

__all__ = [
    "Object",
    "RenderOption", "Ray", "RayC", "RayD", "Frame", "FrameC", "FrameD",
    "Interaction", "InteractionC", "InteractionD",
    "Intersection", "IntersectionC", "IntersectionD",
    "SampleRecord", "SampleRecordC", "SampleRecordD",
    "PositionSample", "PositionSampleC", "PositionSampleD",
    "SensorDirectSample",
    "Sampler", "DiscreteDistribution",
    "Bitmap1f", "Bitmap3f", "Bitmap1fD", "Bitmap3fD", "transform",
    "Mesh", "Scene", "load_file", "load_string",
    "BSDF", "DiffuseBSDF", "MicrofacetBSDF", "MicrofacetBSDFPerVertex",
    "RoughConductorBSDF", "RoughDielectricBSDF", "NormalMapBSDF",
    "Emitter", "AreaLight", "EnvironmentMap",
    "Sensor", "PerspectiveCamera", "OrthographicCamera",
    "Integrator", "PathTracer", "Direct", "CollocatedIntegrator",
    "FieldExtractionIntegrator",
    "EdgeSortOption", "AQ_Option",
    "drjit_test", "drjit_memory", "optix_jit_test",
]
