"""Scene container and traced scene compile.

Counterpart of the reference ``Scene`` (``src/scene/scene.cpp``):

* :class:`Scene` is the mutable user-facing container (``add_Mesh`` /
  ``add_BSDF`` / ``add_Sensor`` / ``param_map``, matching ``psdr.cpp``),
* :meth:`Scene.configure_data` is the traced, differentiable scene compile
  (``Scene::configure``, scene.cpp:311-600): world-space triangle SoA packing,
  emitter weights, secondary-edge tables, sensor matrices + primary edges —
  all as one pure function so ``jax.grad``/``jvp`` flow from rendered pixels
  back to vertices, transforms, reflectances, radiances and camera pose,
* intersection = detached payload (Pallas kernel) + differentiable
  reconstruction in the dual solid-angle / path-space formulations
  (``Scene::ray_intersect``, scene.cpp:612-806).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import (
    pytree, static_field, RenderOption, Ray, Frame, Intersection,
    EPSILON, EDGE_EPSILON,
)
from ..core.math import (
    normalize, norm, squared_norm, cross, dot, bilinear, bilinear2,
    safe_div, safe_sqrt, sign_eps, ray_intersect_triangle, rgb2luminance,
)
from ..core.distribution import DiscreteDistribution
from ..core.records import PositionSample, BoundarySegSample
from ..core.object import Object
from ..shape.mesh import Mesh, TriangleInfo, SecondaryEdgeInfo, MeshData
from ..emitter.area import AreaLight, AreaLightData, area_light_weight
from ..emitter.envmap import (
    EnvironmentMap, EnvironmentMapData, build_envmap_distribution,
)
from ..bsdf.bsdf import eval_dispatch, sample_dispatch, pdf_dispatch
from ..ops.intersect import ray_intersect_detached
from ..ops.gather import gather_rows


@pytree
class SceneData:
    """Everything a render needs, as one pytree of traced arrays."""

    # global triangle SoA (scene.cpp:528-542)
    tri: TriangleInfo
    tri_uv: Any              # (F, 3, 2)
    face_normal_mask: Any    # (F,) bool — per-face use_face_normals
    face_mesh_id: Any        # (F,) int32
    # per-mesh dispatch tables
    mesh_bsdf_slot: Any      # (M,) int32 (-1 none)
    mesh_emitter_slot: Any   # (M,) int32 (-1 none)
    # materials / lights / cameras
    bsdfs: Any               # tuple of BSDF pytrees (static length/types)
    emitters: Any            # tuple of emitter data pytrees
    emitters_distrb: Any     # DiscreteDistribution | None
    sensors: Any             # tuple of SensorData
    # secondary edges (scene.cpp:546-571)
    sec_edge: Any            # SecondaryEdgeInfo | None (global)
    sec_edge_distrb: Any     # DiscreteDistribution | None
    # scene AABB
    lower: Any               # (3,)
    upper: Any               # (3,)
    # static per-mesh string ids (for FieldExtraction object filters,
    # reference Mesh::get_obj_mask)
    mesh_ids: Any = static_field(default=())

    @property
    def num_meshes(self) -> int:
        return self.mesh_bsdf_slot.shape[0]

    # ------------------------------------------------------------------
    # Intersection (scene.cpp:612-806)
    # ------------------------------------------------------------------
    def gather_tri_diff(self, idx, diff: bool = True):
        """Gather all per-face fields for hit indices in ONE op.

        Packs (p0, e1, e2, n0, n1, n2, face_normal, face_area, uv0..2,
        face_indices, fn_mask, mesh_id) into one (F, 33) matrix gathered as
        a one-hot matmul (``ops/gather.py``): the backward is one matmul
        into (F, 33) instead of ~9 separate scatter-adds, and the forward
        one fetch for all fields.  Whether this beats plain row gathers on
        the H100 is not measured yet.

        The integer fields ride along as f32 columns (all values < 2^24, so
        the cast is exact) to avoid three extra int gathers per
        reconstruction.
        """
        del diff  # one-hot is the right path for primal AND diff code
        tri = self.tri
        packed = jnp.concatenate(
            [
                tri.p0, tri.e1, tri.e2, tri.n0, tri.n1, tri.n2,
                tri.face_normal, tri.face_area[:, None],
                self.tri_uv.reshape(-1, 6),
                tri.face_indices.astype(jnp.float32),
                self.face_normal_mask.astype(jnp.float32)[:, None],
                self.face_mesh_id.astype(jnp.float32)[:, None],
            ],
            axis=1,
        )  # (F, 33)
        rows = gather_rows(packed, idx)
        return (
            rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9:12],
            rows[..., 12:15], rows[..., 15:18], rows[..., 18:21],
            rows[..., 21], rows[..., 22:28].reshape(idx.shape + (3, 2)),
            jax.lax.stop_gradient(rows[..., 28:31]).astype(jnp.int32),
            jax.lax.stop_gradient(rows[..., 31]) > 0.5,
            jax.lax.stop_gradient(rows[..., 32]).astype(jnp.int32),
        )

    def ray_intersect(self, ray: Ray, active=None, mode: str = "path",
                      backend: str = "auto", diff: bool = True, tape=None):
        """Closest hit + differentiable reconstruction.

        ``mode``:
        * ``"solid"`` — solid-angle formulation: differentiable
          Möller-Trumbore re-intersection (camera rays of the interior term),
        * ``"path"`` — path-space formulation: hit point from *detached*
          barycentrics, differentiable through vertices, with material-form
          Jacobian ``J`` (all secondary rays).

        The primal values agree; only derivatives differ (scene.cpp:736-806).

        ``tape`` (integrator/prb.py IntersectTape): in record mode the
        detached payload of every intersection is appended; in replay mode
        the kernel launch is skipped and the saved payload reused — the
        path-replay backward pass reconstructs differentiable states from
        payloads without re-tracing rays.
        """
        tri = self.tri
        if tape is not None and tape.replaying:
            # payload stored as 1-D components (custom_vjp residuals
            # stacked across the chunk scan)
            tri_id, valid, pu, pv = tape.pop()
            uv_payload = jnp.stack([pu, pv], axis=-1)
        else:
            tri_id, valid, uv_payload, _t = ray_intersect_detached(
                tri.p0, tri.e1, tri.e2, ray, active, backend=backend
            )
            # Tag the detached payload so the chunk-remat backward passes
            # (jax.checkpoint with CHECKPOINT_POLICY, integrator/base.py)
            # save it instead of re-launching the intersection kernel —
            # ~13 B/lane buys back one full kernel run per intersection in
            # every rematerialized backward sweep.
            from jax.ad_checkpoint import checkpoint_name
            tri_id = checkpoint_name(tri_id, "psdr_saved")
            valid = checkpoint_name(valid, "psdr_saved")
            uv_payload = checkpoint_name(uv_payload, "psdr_saved")
            if tape is not None:
                tape.append((tri_id, valid,
                             uv_payload[..., 0], uv_payload[..., 1]))
        idx = jnp.maximum(tri_id, 0)

        (p0, e1, e2, n0, n1, n2, face_normal, face_area,
         uv_info, face_indices, fn_mask, mesh_id) = self.gather_tri_diff(
            idx, diff=diff)

        if mode == "path":
            uv = uv_payload  # detached barycentrics from the kernel
            p = bilinear(p0, e1, e2, uv)
            dirv = p - ray.o
            t = norm(dirv)
            dirv = dirv * safe_div(1.0, t)[..., None]
            J = safe_div(face_area, jax.lax.stop_gradient(face_area))
            wi_dir = -dirv
        elif mode == "solid":
            uv, t = ray_intersect_triangle(p0, e1, e2, ray)
            p = ray(t)
            J = jnp.ones_like(t)
            wi_dir = -ray.d
        else:
            raise ValueError(mode)

        sh_n = normalize(bilinear(n0, n1 - n0, n2 - n0, uv))
        sh_n = jnp.where(fn_mask[..., None], face_normal, sh_n)

        # uv interpolation + dp_du/dp_dv (scene.cpp:727-733, 752-759)
        uv0, uv1, uv2 = uv_info[..., 0, :], uv_info[..., 1, :], uv_info[..., 2, :]
        its_uv = bilinear2(uv0, uv1 - uv0, uv2 - uv0, uv)
        duv0 = uv1 - uv0
        duv1 = uv2 - uv0
        det = duv0[..., 0] * duv1[..., 1] - duv0[..., 1] * duv1[..., 0]
        inv_det = safe_div(1.0, det)
        valid_dp = det != 0.0
        dp_du = jnp.where(
            valid_dp[..., None],
            (duv1[..., 1:2] * e1 - duv0[..., 1:2] * e2) * inv_det[..., None],
            0.0,
        )
        dp_dv = jnp.where(
            valid_dp[..., None],
            (-duv1[..., 0:1] * e1 + duv0[..., 0:1] * e2) * inv_det[..., None],
            0.0,
        )
        sh_frame = Frame.from_normal(sh_n)
        s_uv = normalize(dp_du - sh_n * dot(sh_n, dp_du)[..., None])
        s = jnp.where(valid_dp[..., None], s_uv, sh_frame.s)
        t_frame = jnp.where(
            valid_dp[..., None], cross(sh_n, s), sh_frame.t
        )
        sh_frame = Frame(s=s, t=t_frame, n=sh_n)
        wi = sh_frame.to_local(wi_dir)

        return Intersection(
            valid=valid,
            t=t,
            p=p,
            n=face_normal,
            sh_frame=sh_frame,
            wi=wi,
            uv=its_uv,
            J=J,
            dp_du=dp_du,
            dp_dv=dp_dv,
            bc=uv,
            tri_id=tri_id,
            mesh_id=mesh_id,
            face_indices=face_indices,
        )

    # ------------------------------------------------------------------
    # Per-lane emitter dispatch
    # ------------------------------------------------------------------
    def emitter_slot(self, its: Intersection):
        # jnp.asarray: the table may arrive as a host constant (jax Literal)
        # when partial eval lifts param-independent int outputs out of a
        # surrounding vjp trace; Literal.__getitem__ rejects tracer indices.
        table = jnp.asarray(self.mesh_emitter_slot)
        return jnp.where(
            its.valid, table[jnp.maximum(its.mesh_id, 0)], -1
        )

    def is_emitter(self, its: Intersection, active):
        return active & its.valid & (self.emitter_slot(its) >= 0)

    def Le(self, its: Intersection, active):
        """Emitted radiance at a hit (intersection.h:31-42 vcall chain)."""
        slot = self.emitter_slot(its)
        result = jnp.zeros(its.t.shape + (3,), jnp.float32)
        for i, em in enumerate(self.emitters):
            m = active & (slot == i)
            result = jnp.where(m[..., None], em.eval(its, m), result)
        return result

    def bsdf_slot(self, its: Intersection):
        table = jnp.asarray(self.mesh_bsdf_slot)  # see emitter_slot
        return jnp.where(
            its.valid, table[jnp.maximum(its.mesh_id, 0)], -1
        )

    def eval_bsdf(self, its, wo, active):
        return eval_dispatch(self.bsdfs, self.bsdf_slot(its), its, wo, active)

    def sample_bsdf(self, its, rnd3, active):
        return sample_dispatch(self.bsdfs, self.bsdf_slot(its), its, rnd3, active)

    def pdf_bsdf(self, its, wo, active):
        return pdf_dispatch(self.bsdfs, self.bsdf_slot(its), its, wo, active)

    # ------------------------------------------------------------------
    # Emitter sampling (scene.cpp:987-1024)
    # ------------------------------------------------------------------
    @property
    def emitter_coin_needed(self) -> bool:
        """Trace-static: does emitter-position sampling want an extra
        uniform (the alias coin of a big envmap importance table)?  Call
        sites draw one more sampler number iff this is True, keeping the
        draw schedule static per scene class."""
        return any(
            getattr(getattr(em, "cell_distrb", None), "needs_coin", False)
            for em in self.emitters
        )

    def sample_emitter_position(self, ref_p, sample2, active,
                                u_coin=None) -> PositionSample:
        assert len(self.emitters) > 0, "No emitter!"
        if len(self.emitters) == 1:
            return self.emitters[0].sample_position(ref_p, sample2, active,
                                                    u_coin=u_coin)
        u = sample2[..., 1]
        e_idx, e_pdf, u = self.emitters_distrb.sample_reuse(u)
        sample2 = jnp.stack([sample2[..., 0], u], axis=-1)
        out = None
        for i, em in enumerate(self.emitters):
            m = active & (e_idx == i)
            ps = em.sample_position(ref_p, sample2, m, u_coin=u_coin)
            if out is None:
                out = ps
            else:
                out = PositionSample(
                    p=jnp.where(m[..., None], ps.p, out.p),
                    n=jnp.where(m[..., None], ps.n, out.n),
                    pdf=jnp.where(m, ps.pdf, out.pdf),
                    J=jnp.where(m, ps.J, out.J),
                    is_valid=jnp.where(m, ps.is_valid, out.is_valid),
                )
        return out.replace(pdf=out.pdf * e_pdf)

    def emitter_position_pdf(self, ref_p, its: Intersection, active):
        slot = self.emitter_slot(its)
        result = jnp.zeros(its.t.shape, jnp.float32)
        for i, em in enumerate(self.emitters):
            m = active & (slot == i)
            result = jnp.where(m, em.sample_position_pdf(ref_p, its, m), result)
        return result

    # ------------------------------------------------------------------
    # Boundary segment sampling (scene.cpp:1027-1068)
    # ------------------------------------------------------------------
    def sample_boundary_segment_direct(self, sample3, active=None,
                                       u_coin=None,
                                       u_coin_emitter=None) -> BoundarySegSample:
        """``u_coin``/``u_coin_emitter``: alias coins for the edge table /
        the envmap importance table (see DiscreteDistribution.needs_coin);
        callers draw them iff the respective ``needs_coin`` is True."""
        se = self.sec_edge
        assert se is not None, "no secondary edges configured"
        if active is None:
            active = jnp.ones(sample3.shape[:-1], bool)

        u0 = sample3[..., 0]
        edge_idx, pdf0, u0 = self.sec_edge_distrb.sample_reuse(u0, u_coin)
        # ONE packed matmul-gather for every per-edge field
        # (ops/gather.py)
        rows = gather_rows(
            jnp.concatenate(
                [se.p0, se.e1, se.n0, se.n1, se.p2,
                 se.is_boundary.astype(jnp.float32)[:, None]],
                axis=1,
            ),
            edge_idx,
        )
        p0_edge = rows[..., 0:3]
        e1 = rows[..., 3:6]
        n0 = jax.lax.stop_gradient(rows[..., 6:9])
        n1 = jax.lax.stop_gradient(rows[..., 9:12])
        p2_third = jax.lax.stop_gradient(rows[..., 12:15])
        is_boundary = jax.lax.stop_gradient(rows[..., 15]) > 0.5

        p0 = p0_edge + e1 * u0[..., None]    # AD through vertices
        edge_dir = normalize(jax.lax.stop_gradient(e1))
        edge2 = p2_third - jax.lax.stop_gradient(p0_edge)
        p0_det = jax.lax.stop_gradient(p0)
        pdf0 = safe_div(pdf0, norm(jax.lax.stop_gradient(e1)))

        # light point
        ps2 = self.sample_emitter_position(
            p0_det, jax.lax.stop_gradient(sample3[..., 1:3]), active,
            u_coin=u_coin_emitter,
        )
        ps2 = jax.lax.stop_gradient(ps2)

        e = ps2.p - p0_det
        dist_sqr = squared_norm(e)
        e = e * safe_div(1.0, safe_sqrt(dist_sqr))[..., None]
        cos_theta = dot(ps2.n, -e)

        sgn0 = sign_eps(dot(n0, e), EDGE_EPSILON)
        sgn1 = sign_eps(dot(n1, e), EDGE_EPSILON)
        is_valid = active & ps2.is_valid & (cos_theta > EPSILON) & (
            (is_boundary & (sgn0 != 0)) | ((~is_boundary) & (sgn0 * sgn1 < 0))
        )
        pdf = jnp.where(
            is_valid,
            pdf0 * ps2.pdf * safe_div(dist_sqr, cos_theta),
            0.0,
        )
        return BoundarySegSample(
            p0=p0,
            edge=edge_dir,
            edge2=edge2,
            p2=ps2.p,
            n=ps2.n,
            pdf=pdf,
            is_valid=is_valid,
        )


class Scene(Object):
    """Mutable scene container mirroring the reference Python API."""

    def __init__(self):
        self.opts = RenderOption()
        self.meshes: list = []
        self.bsdfs: list = []
        self.bsdf_ids: list = []
        self.emitters: list = []
        self.sensors: list = []
        self.emitter_env: Optional[EnvironmentMap] = None
        self.param_map: dict = {}
        self.seed = 0
        self._data: Optional[SceneData] = None
        self._active_sensors = None

    # -- builders (psdr.cpp:406-418; scene.cpp add_* ~100-310) -------------
    @property
    def num_sensors(self) -> int:
        return len(self.sensors)

    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

    def add_Sensor(self, sensor):
        self.sensors.append(sensor)
        self._rebuild_param_map()
        return len(self.sensors) - 1

    def add_BSDF(self, bsdf, bsdf_id: str = "", twoSide: bool = False):
        # unconditional, like the reference (scene.cpp add_BSDF
        # m_twoSide = twoSide): passing twoSide=False must also RESET a
        # BSDF object whose flag was already set
        bsdf.twoSide = bool(twoSide)
        bsdf.id = bsdf_id
        self.bsdfs.append(bsdf)
        self.bsdf_ids.append(bsdf_id)
        self._rebuild_param_map()
        return len(self.bsdfs) - 1

    def add_EnvironmentMap(self, env, to_world=None, scale=None):
        """Add the (single) environment map.

        Two reference overloads (src/psdr.cpp:397-398): an ``EnvironmentMap``
        object, or ``(filename, to_world, scale)``
        (src/scene/scene.cpp:85-96).
        """
        assert self.emitter_env is None, \
            "A scene is only allowed to have one envmap!"
        if not isinstance(env, EnvironmentMap):
            env = EnvironmentMap(env, scale=1.0 if scale is None else scale)
        elif scale is not None:
            env.scale = jnp.float32(scale)
        if to_world is not None:
            env.to_world_raw = jnp.asarray(to_world, jnp.float32)
        self.emitter_env = env
        self.emitters.append(env)
        self._rebuild_param_map()

    def add_Mesh(self, mesh_or_file, transform=None, bsdf_id: str = "",
                 emitter: Optional[AreaLight] = None):
        if isinstance(mesh_or_file, Mesh):
            mesh = mesh_or_file
        else:
            mesh = Mesh().load(str(mesh_or_file))
        if transform is not None:
            mesh.to_world_raw = jnp.asarray(transform, jnp.float32)
        if bsdf_id != "":
            assert bsdf_id in self.bsdf_ids, f"Unknown BSDF id {bsdf_id!r}"
            mesh.bsdf_id = self.bsdf_ids.index(bsdf_id)
        if emitter is not None:
            emitter.mesh_index = len(self.meshes)
            mesh.emitter_id = len(self.emitters)
            self.emitters.append(emitter)
        self.meshes.append(mesh)
        self._rebuild_param_map()
        return mesh

    def add_normalmap_BSDF(self, nmap_bsdf, nested_bsdf, bsdf_id: str = "",
                           twoSide: bool = False):
        """Reference-compatible helper (psdr.cpp add_normalmap_BSDF): wraps
        ``nested_bsdf`` with ``nmap_bsdf``'s normal map."""
        from ..bsdf import NormalMapBSDF

        nm = NormalMapBSDF(nmap_bsdf.nmap if hasattr(nmap_bsdf, "nmap")
                           else nmap_bsdf, nested_bsdf, twoSide=twoSide)
        return self.add_BSDF(nm, bsdf_id, twoSide)

    # -- loading (reference Scene.load_file/load_string, psdr.cpp:407-408) --
    def load_file(self, file_name: str, auto_configure: bool = True):
        from .loader import load_file as _load

        self._adopt(_load(file_name))
        if auto_configure:
            self.configure()

    def load_string(self, scene_xml: str, auto_configure: bool = True):
        from .loader import load_string as _load

        self._adopt(_load(scene_xml))
        if auto_configure:
            self.configure()

    def _adopt(self, other: "Scene"):
        for name in ("opts", "meshes", "bsdfs", "bsdf_ids", "emitters",
                     "sensors", "emitter_env", "param_map"):
            setattr(self, name, getattr(other, name))
        self._data = None

    def get_num_emitters(self) -> int:
        return len(self.emitters)

    # -- intersection inspection (psdr.cpp:404-405) -------------------------
    def unit_ray_intersect(self, ray_o, ray_d):
        """Detached intersection of user rays (reference unit_ray_intersect)."""
        sd = jax.lax.stop_gradient(self.data)
        return sd.ray_intersect(
            Ray(jnp.asarray(ray_o, jnp.float32), jnp.asarray(ray_d, jnp.float32)),
            mode="path",
        )

    def unit_ray_intersectAD(self, ray_o, ray_d):
        sd = self.configure_data(self._active_sensors)
        return sd.ray_intersect(
            Ray(jnp.asarray(ray_o, jnp.float32), jnp.asarray(ray_d, jnp.float32)),
            mode="solid",
        )

    def _rebuild_param_map(self):
        pm = {}
        for i, m in enumerate(self.meshes):
            pm[f"Mesh[{i}]"] = m
            if getattr(m, "id", ""):
                pm[f"Mesh[id={m.id}]"] = m
        for i, b in enumerate(self.bsdfs):
            pm[f"BSDF[{i}]"] = b
            if getattr(b, "id", ""):
                pm[f"BSDF[id={b.id}]"] = b
        for i, e in enumerate(self.emitters):
            pm[f"Emitter[{i}]"] = e
        for i, s in enumerate(self.sensors):
            pm[f"Sensor[{i}]"] = s
        self.param_map = pm

    # -- traced scene compile ------------------------------------------------
    def configure_data(self, active_sensors=None) -> SceneData:
        """Pure-by-convention scene compile (scene.cpp:311-600).

        Reads current (possibly traced) leaves off the python objects and
        returns a SceneData pytree.  Differentiable end to end.
        """
        assert self.meshes, "Missing meshes!"
        assert self.sensors, "Missing sensor!"
        # gather_tri_diff packs integer columns (face_indices, mesh ids)
        # as f32 — exact only below 2^24.  Checked HERE (the function
        # that consumes the packing) so renderD/loss_and_grad paths that
        # never call eager configure() are covered too.
        n_verts = sum(int(m.vertex_positions_raw.shape[0])
                      for m in self.meshes)
        assert n_verts < (1 << 24), (
            f"{n_verts} vertices: the packed f32 triangle table is "
            "exact only below 2^24 vertex indices (scene.py "
            "gather_tri_diff)"
        )
        opts = self.opts
        with_sec_edges = opts.sppse > 0
        with_prim_edges = opts.sppe > 0

        mesh_list = list(self.meshes)
        emitters = list(self.emitters)

        mesh_datas = [
            m.configure_data(with_edges=with_sec_edges and m.enable_edges)
            for m in mesh_list
        ]

        # scene AABB (scene.cpp:356-370 + camera positions)
        all_lo = [jnp.min(jax.lax.stop_gradient(md.vertex_positions), axis=0)
                  for md in mesh_datas]
        all_hi = [jnp.max(jax.lax.stop_gradient(md.vertex_positions), axis=0)
                  for md in mesh_datas]
        lower = jnp.min(jnp.stack(all_lo), axis=0)
        upper = jnp.max(jnp.stack(all_hi), axis=0)

        # envmap bounding mesh (scene.cpp:435-485).  The reference uses
        # min(extent)*0.05 (scene.cpp:436), which collapses to a degenerate
        # box for flat scenes; use 5% of the max extent with a floor instead.
        # The box must also CONTAIN every camera, or primary rays hit the sky
        # box before the scene (the reference implicitly assumes this).
        if self.emitter_env is not None:
            from ..sensor import OrthographicCamera

            cam_pts = []
            for s in self.sensors:
                to_world = s.to_world_left @ s.to_world_raw @ s.to_world_right
                if isinstance(s, OrthographicCamera):
                    # camera-space film extent is x in [-1,1], y in
                    # [-1/aspect, 1/aspect] (orthographic.py
                    # camera_to_sample); a hardcoded +-1.2 square would
                    # leave portrait films (aspect < 1) partly OUTSIDE the
                    # sky box, rendering envmap radiance in front of the
                    # scene on the top/bottom rows
                    aspect = float(self.opts.width) / float(self.opts.height)
                    for cx in (-1.2, 1.2):
                        for cy in (-1.2 / aspect, 1.2 / aspect):
                            cam_pts.append(
                                jnp.asarray([cx, cy, 0.0]) @ to_world[:3, :3].T
                                + to_world[:3, 3]
                            )
                else:
                    cam_pts.append(to_world[:3, 3])
            if cam_pts:
                pts = jax.lax.stop_gradient(jnp.stack(cam_pts))
                lower = jnp.minimum(lower, jnp.min(pts, axis=0))
                upper = jnp.maximum(upper, jnp.max(pts, axis=0))
            ext = upper - lower
            margin = jnp.maximum(
                0.05 * jnp.max(ext),
                1e-3 * jnp.maximum(1.0, jnp.max(jnp.abs(upper) + jnp.abs(lower))),
            )
            lower = lower - margin
            upper = upper + margin
            bound_mesh, bound_data = _make_bound_mesh(lower, upper)
            bound_mesh.emitter_id = emitters.index(self.emitter_env)
            self.emitter_env.mesh_index = len(mesh_list)
            mesh_list = mesh_list + [bound_mesh]
            mesh_datas = mesh_datas + [bound_data]

        # global triangle SoA packing (scene.cpp:528-542)
        tri = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0),
            *[md.tri for md in mesh_datas],
        )
        tri_uv = jnp.concatenate([md.tri_uv for md in mesh_datas], axis=0)
        face_normal_mask = jnp.concatenate([
            jnp.full((md.tri.face_area.shape[0],), m.use_face_normals)
            for m, md in zip(mesh_list, mesh_datas)
        ])
        face_mesh_id = jnp.concatenate([
            jnp.full((md.tri.face_area.shape[0],), i, jnp.int32)
            for i, md in enumerate(mesh_datas)
        ])

        # Morton-reorder the global triangle stream so the intersector's
        # 64-triangle clusters are spatially tight (static permutation
        # computed host-side in Scene.configure; topology-stable across
        # parameter updates).  The envmap bound mesh stays at the tail.
        perm = getattr(self, "_tri_perm", None)
        f_total = face_mesh_id.shape[0]
        if perm is not None and perm.shape[0] <= f_total:
            full_perm = jnp.concatenate([
                jnp.asarray(perm, jnp.int32),
                jnp.arange(perm.shape[0], f_total, dtype=jnp.int32),
            ])
            tri = jax.tree_util.tree_map(
                lambda x: jnp.take(x, full_perm, axis=0), tri
            )
            tri_uv = jnp.take(tri_uv, full_perm, axis=0)
            face_normal_mask = jnp.take(face_normal_mask, full_perm, axis=0)
            face_mesh_id = jnp.take(face_mesh_id, full_perm, axis=0)

        mesh_bsdf_slot = jnp.asarray(
            [m.bsdf_id for m in mesh_list], jnp.int32
        )
        mesh_emitter_slot = jnp.asarray(
            [m.emitter_id for m in mesh_list], jnp.int32
        )

        # emitters (scene.cpp:489-515)
        emitter_datas = []
        weights = []
        for em in emitters:
            if isinstance(em, AreaLight):
                md = mesh_datas[em.mesh_index]
                weights.append(area_light_weight(em.radiance, md))
            else:
                weights.append(jnp.float32(0.0))
        if emitters:
            total = sum(weights)
            # envmap weight = total of the others (scene.cpp:507-510); a
            # LONE envmap would get weight 0 -> sampling_weight 0, so fall
            # back to 1 (any positive constant: it is the only emitter)
            env_w = jnp.where(jnp.asarray(total) > 0.0, total, 1.0)
            weights = [
                env_w if isinstance(em, EnvironmentMap) else w
                for em, w in zip(emitters, weights)
            ]
            wsum = sum(weights)
            emitters_distrb = DiscreteDistribution.init(jnp.stack(weights))
            for em, w in zip(emitters, weights):
                norm_w = jax.lax.stop_gradient(safe_div(w, wsum))
                if isinstance(em, AreaLight):
                    emitter_datas.append(AreaLightData(
                        radiance=em.radiance,
                        sampling_weight=norm_w,
                        mesh_data=mesh_datas[em.mesh_index],
                        mesh_index=em.mesh_index,
                    ))
                else:
                    emitter_datas.append(EnvironmentMapData(
                        radiance=em.radiance,
                        scale=em.scale,
                        to_world=em.to_world_left @ em.to_world_raw,
                        from_world=jnp.linalg.inv(
                            em.to_world_left @ em.to_world_raw
                        ),
                        # Importance table built once at Scene.configure()
                        # (like the reference, envmap.cpp:17-41) and flowed
                        # in as detached data — building it here would put
                        # an ~8M-cell bilinear eval + cumsum inside every
                        # traced training step when the radiance is an
                        # optimized (traced) parameter.  Sampling + pdf both
                        # come from the same (possibly stale-by-one-
                        # configure) table, so the estimator stays unbiased;
                        # call configure() again to refresh importance.
                        cell_distrb=(
                            em._cell_distrb_cache
                            if getattr(em, "_cell_distrb_cache", None)
                            is not None
                            else build_envmap_distribution(em.radiance)
                        ),
                        lower=lower,
                        upper=upper,
                        sampling_weight=norm_w,
                        mesh_index=em.mesh_index,
                    ))
        else:
            emitters_distrb = None

        # secondary edges: global packing + length pmf (scene.cpp:546-571)
        sec_edge = None
        sec_edge_distrb = None
        if with_sec_edges:
            parts = [md.sec_edge for md in mesh_datas if md.sec_edge is not None]
            if parts:
                sec_edge = jax.tree_util.tree_map(
                    lambda *xs: jnp.concatenate(xs, axis=0), *parts
                )
                sec_edge_distrb = DiscreteDistribution.init(
                    norm(jax.lax.stop_gradient(sec_edge.e1))
                )
                # big edge sets: consume the alias-attached table cached by
                # the last eager configure() (same policy as the envmap
                # importance cache above: the sampling table is detached
                # anyway, sample+pdf stay consistent so the estimator is
                # unbiased at any staleness, and edge lengths have full
                # support so no edge can be starved; per-lane binary search
                # over the fresh CDF measured 188 ms/step combined with the
                # primary-edge search on the envmap bunny workload).
                cache = getattr(self, "_sec_edge_distrb_cache", None)
                if (cache is not None
                        and cache.size == sec_edge_distrb.size):
                    sec_edge_distrb = cache

        # sensors
        if active_sensors is None:
            active_sensors = list(range(len(self.sensors)))
        sensor_datas = tuple(
            s.configure_data(
                opts.width, opts.height, mesh_list, mesh_datas,
                with_edges=with_prim_edges and (i in active_sensors),
            )
            for i, s in enumerate(self.sensors)
        )
        # big primary-edge screen tables: swap in the alias-attached FLOORED
        # table cached by the last eager configure() (see configure()); the
        # floor keeps every projected edge sampleable so a silhouette that
        # flips between configure() calls is still reached (higher variance
        # there, never bias — sample and pdf come from the same table)
        pe_caches = getattr(self, "_pe_distrb_caches", None) or {}
        if pe_caches:
            sensor_datas = tuple(
                sd.replace(edge_info=sd.edge_info.replace(
                    distrb=pe_caches[i]))
                if (i in pe_caches and sd.edge_info is not None
                    and pe_caches[i].size == sd.edge_info.distrb.size)
                else sd
                for i, sd in enumerate(sensor_datas)
            )

        return SceneData(
            tri=tri,
            tri_uv=tri_uv,
            face_normal_mask=face_normal_mask,
            face_mesh_id=face_mesh_id,
            mesh_bsdf_slot=mesh_bsdf_slot,
            mesh_emitter_slot=mesh_emitter_slot,
            bsdfs=tuple(self.bsdfs),
            emitters=tuple(emitter_datas),
            emitters_distrb=emitters_distrb,
            sensors=sensor_datas,
            sec_edge=sec_edge,
            sec_edge_distrb=sec_edge_distrb,
            lower=lower,
            upper=upper,
            mesh_ids=tuple(getattr(m, "id", "") for m in mesh_list),
        )

    def configure(self, active_sensors=None):
        """Eagerly (re)build and cache scene data (reference sc.configure())."""
        from ..utils.profiling import log_time

        with log_time("Configured", self.opts.log_level > 0):
            # (the 2^24 packed-index safety assert lives in
            # configure_data, which every render path goes through)
            self._active_sensors = active_sensors
            self._tri_perm = self._compute_tri_perm()
            # (re)build the envmap importance table eagerly, OUTSIDE any
            # trace (reference: Emitter::configure, envmap.cpp:17-41);
            # configure_data consumes the cache so traced training steps
            # never re-derive it from a traced radiance
            for em in self.emitters:
                if isinstance(em, EnvironmentMap) and not isinstance(
                    em.radiance.data, jax.core.Tracer
                ):
                    # alias table: O(1)-gather cell sampling — the CDF
                    # binary search over this (~8M-cell for a 1k envmap)
                    # table measured 692 ms/step in the NEE of the envmap
                    # training step (scripts/envmap_profile.py)
                    em._cell_distrb_cache = jax.lax.stop_gradient(
                        build_envmap_distribution(em.radiance)
                    ).with_alias()
            self._sec_edge_distrb_cache = None
            self._pe_distrb_caches = {}
            self._data = self.configure_data(active_sensors)
            # attach O(1)-gather alias tables to the big sampling
            # distributions now that their masses are concrete; traced
            # per-step rebuilds (fused training steps) consume the caches.
            # Per-lane binary search over the fresh CDFs measured 188
            # ms/step (PE + SE combined) on the envmap bunny workload
            # (scripts/attribute_profile.py, 2026-08-19).
            from ..core.math import SEARCHSORTED_DENSE_MAX

            sed = self._data.sec_edge_distrb
            if sed is not None and sed.size > SEARCHSORTED_DENSE_MAX:
                self._sec_edge_distrb_cache = sed.with_alias()
                self._data = self._data.replace(
                    sec_edge_distrb=self._sec_edge_distrb_cache
                )
            # primary-edge screen tables: cache a FLOORED version — the
            # silhouette classification (the support of the fresh table)
            # moves with the geometry between configure() calls, so the
            # cached sampler mixes in 1/16 proportional-to-raw-length mass
            # over ALL projected edges: late-flipping silhouettes stay
            # sampleable (no support mismatch => no bias; a non-silhouette
            # draw contributes ~0 and costs ~6% of sppe in variance)
            new_sensors = []
            changed = False
            for i, sdat in enumerate(self._data.sensors):
                ei = sdat.edge_info
                if ei is None or ei.distrb.size <= SEARCHSORTED_DENSE_MAX:
                    new_sensors.append(sdat)
                    continue
                keep_mass = ei.edge_length
                raw = norm(ei.p1 - ei.p0)
                tk = jnp.sum(keep_mass)
                tr = jnp.maximum(jnp.sum(raw), 1e-30)
                mass = keep_mass + raw * (
                    jnp.where(tk > 0.0, tk, tr) / tr / 16.0
                )
                cache = DiscreteDistribution.init(mass).with_alias()
                self._pe_distrb_caches[i] = cache
                new_sensors.append(
                    sdat.replace(edge_info=ei.replace(distrb=cache))
                )
                changed = True
            if changed:
                self._data = self._data.replace(sensors=tuple(new_sensors))
            if self.opts.log_level > 0:
                jax.block_until_ready(jax.tree_util.tree_leaves(self._data))
        return self._data

    def _world_tri_centroids(self):
        """Per-face world-space centroids under the CURRENT concrete
        transforms (host-side numpy).  Single definition shared by the
        Morton-ordering builder and the staleness monitor so the two can
        never score different geometry."""
        cents = []
        for m in self.meshes:
            tw = np.asarray(
                m.to_world_left @ m.to_world_raw @ m.to_world_right
            )
            v = np.asarray(m.vertex_positions_raw) @ tw[:3, :3].T + tw[:3, 3]
            f = np.asarray(m.face_indices)
            cents.append(v[f].mean(axis=1))
        return np.concatenate(cents)

    def _compute_tri_perm(self):
        """Morton permutation of all user-mesh faces (host-side, static).

        Only computed for scenes big enough that the intersector's cluster
        AABBs matter; based on the current (concrete) transforms, stays valid
        as a heuristic ordering when parameters move during optimization.
        """
        total_faces = sum(m.num_faces for m in self.meshes)
        if total_faces <= 256:
            return None
        from ..native import morton_order

        return np.asarray(
            morton_order(self._world_tri_centroids()), np.int32
        )

    def _cluster_quality(self, perm, cents=None, cluster: int = None) -> float:
        """Sum of cluster-AABB surface areas under the CURRENT concrete
        transforms for a given triangle permutation — the quantity the
        intersector's two-level culling actually depends on (smaller =
        tighter clusters = more AABB skips).  The granularity defaults to
        the kernel's chunk (ops.intersect.CLUSTER_TRIS) so the monitor
        tracks what the culling tests."""
        if cluster is None:
            from ..ops.intersect import CLUSTER_TRIS as cluster
        if cents is None:
            cents = self._world_tri_centroids()
        c = cents[np.asarray(perm)]
        n_pad = -(-c.shape[0] // cluster) * cluster
        if n_pad != c.shape[0]:
            c = np.concatenate([c, np.tile(c[-1:], (n_pad - c.shape[0], 1))])
        c = c.reshape(-1, cluster, 3)
        ext = c.max(axis=1) - c.min(axis=1)
        return float(
            2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                   + ext[:, 0] * ext[:, 2]).sum()
        )

    def tri_perm_staleness(self) -> float:
        """How much the configure-time Morton clustering has degraded under
        the current transforms: quality(cached perm) / quality(fresh perm).
        1.0 = still optimal; large values mean the intersector's cluster
        culling is losing effectiveness as geometry moves."""
        ratio, _ = self._staleness_and_fresh_perm()
        return ratio

    def _staleness_and_fresh_perm(self):
        """(staleness ratio, fresh perm) in ONE pass: the centroids and
        Morton ordering are host-side O(faces log faces) — computing them
        once serves both the staleness probe and a subsequent refresh.
        Also guards mesh-set changes since configure(): a stale perm whose
        indices no longer address the current face count (meshes removed/
        replaced) scores as infinitely stale instead of crashing."""
        perm = getattr(self, "_tri_perm", None)
        if perm is None:
            return 1.0, None
        fresh = self._compute_tri_perm()
        if fresh is None:  # mesh set shrank below the clustering threshold
            return float("inf"), None
        cents = self._world_tri_centroids()
        if np.asarray(perm).max(initial=-1) >= cents.shape[0]:
            return float("inf"), fresh  # stale perm outlived its meshes
        q_fresh = self._cluster_quality(fresh, cents)
        if q_fresh <= 0.0:
            return 1.0, fresh
        return self._cluster_quality(perm, cents) / q_fresh, fresh

    def refresh_tri_perm(self, threshold: float = 1.25) -> bool:
        """Recompute the Morton triangle ordering if it has degraded past
        ``threshold`` (see :meth:`tri_perm_staleness`).  Call periodically
        from optimization loops that move geometry a lot without calling
        ``configure()``; returns True when the permutation was replaced.

        Where the refresh takes effect: ``renderC``/``renderD`` build the
        scene data EAGERLY per call, so they pick the new ordering up
        immediately (it flows in as argument data — no recompile).
        ``parallel.make_fused_train_step`` rebuilds its jitted step when
        ``_perm_version`` changes.  A USER-jitted closure over this scene
        (e.g. ``jax.jit`` around ``loss_and_grad``), however, baked the old
        permutation in as a constant at trace time and keeps it until the
        closure is re-created — re-make your jitted step after a True
        return."""
        if getattr(self, "_tri_perm", None) is None:
            return False
        ratio, fresh = self._staleness_and_fresh_perm()
        if ratio == float("inf") and fresh is None:
            # mesh set shrank below the clustering threshold since
            # configure(): drop the stale perm entirely (its indices no
            # longer address the current face table)
            self._tri_perm = None
            self._data = None
            self._perm_version = getattr(self, "_perm_version", 0) + 1
            return True
        if ratio <= threshold or fresh is None:
            return False
        self._tri_perm = fresh
        self._data = None  # cached traced data baked the old ordering
        self._perm_version = getattr(self, "_perm_version", 0) + 1
        return True

    @property
    def data(self) -> SceneData:
        if self._data is None:
            self.configure()
        return self._data

    def is_ready(self) -> bool:
        return self._data is not None


def _make_bound_mesh(lower, upper):
    """Inward-facing AABB box mesh for envmap lighting (scene.cpp:447-470)."""
    # vertex i has coordinate upper[j] if bit j of i is set
    corners = np.arange(8)
    sel = np.stack(
        [(corners >> j) & 1 for j in range(3)], axis=-1
    ).astype(np.float32)  # (8, 3) in {0,1}
    verts = lower * (1.0 - sel) + upper * sel
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2], [1, 5, 7], [1, 7, 3],
            [2, 3, 7], [2, 7, 6], [0, 5, 1], [0, 4, 5],
            [0, 2, 6], [0, 6, 4], [4, 7, 5], [4, 6, 7],
        ],
        np.int32,
    )
    mesh = Mesh()
    mesh.use_face_normals = True
    mesh.enable_edges = False
    mesh.bsdf_id = -1
    mesh.vertex_positions_raw = verts
    mesh.face_indices = faces
    data = mesh.configure_data(with_edges=False)
    return mesh, data
