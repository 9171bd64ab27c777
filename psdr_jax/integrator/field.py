"""AOV extraction integrator (reference: src/integrator/field.cpp).

Fields: bsdf / segmentation / silhouette / position / depth / geoNormal /
shNormal / uv, with an optional per-object filter by mesh id string.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Integrator

_FIELDS = (
    "bsdf", "segmentation", "silhouette", "position", "depth",
    "geoNormal", "shNormal", "uv",
)


class FieldExtractionIntegrator(Integrator):
    def __init__(self, field: str):
        super().__init__()
        parts = field.split()
        assert parts and parts[0] in _FIELDS, f"Unsupported field: {field}"
        self.field = parts[0]
        self.object = parts[1] if len(parts) > 1 else ""

    def Li(self, sd, sampler, ray, active, diff: bool):
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path", diff=diff)
        active = active & its.valid
        # skip the envmap bounding mesh (field.cpp:53-56)
        active = active & (sd.bsdf_slot(its) >= 0)

        if self.object:
            # per-object filter by mesh string id (reference get_obj_mask,
            # field.cpp:58-63); "obj:<k>" selects by mesh index directly
            if self.object.startswith("obj:"):
                allowed = [int(self.object[4:])]
            else:
                allowed = [
                    i for i, mid in enumerate(sd.mesh_ids)
                    if mid == self.object
                ]
            obj_mask = jnp.zeros_like(active)
            for k in allowed:
                obj_mask = obj_mask | (its.mesh_id == k)
            active = active & obj_mask

        f = self.field
        if f == "segmentation":
            v = its.mesh_id.astype(jnp.float32)
            result = jnp.stack([v, v, v], axis=-1)
        elif f == "bsdf":
            result = sd.eval_bsdf(its, its.wi, active)
        elif f == "silhouette":
            result = jnp.ones(its.t.shape + (3,), jnp.float32)
        elif f == "position":
            result = its.p
        elif f == "depth":
            result = jnp.broadcast_to(its.t[..., None], its.t.shape + (3,))
        elif f == "geoNormal":
            result = its.n
        elif f == "shNormal":
            result = its.sh_frame.n
        elif f == "uv":
            result = jnp.stack(
                [its.uv[..., 0], its.uv[..., 1], jnp.zeros_like(its.t)], axis=-1
            )
        else:
            raise AssertionError(f)
        return jnp.where(active[..., None], result, 0.0)
