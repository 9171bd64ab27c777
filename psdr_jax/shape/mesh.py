"""Triangle meshes with differentiable transforms and edge topology.

Counterpart of the reference ``Mesh`` (``src/shape/mesh.cpp``,
``include/psdr/shape/mesh.h``):

* vertex positions and the ``to_world_left @ to_world_raw @ to_world_right``
  transform stack are differentiable jnp leaves,
* per-face :class:`TriangleInfo` SoA is recomputed inside traced code
  (``process_mesh``, mesh.cpp:23-62) so gradients flow from hit points back
  to vertices/transforms,
* the edge adjacency 5-tuple list (v0, v1, face0, face1|-1, third-vertex) is
  built host-side in vectorized numpy (mesh.cpp:112-149), once per topology.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import pytree, static_field
from ..core import transform as xf
from ..core.math import normalize, norm, cross, safe_div, bilinear
from ..core.distribution import DiscreteDistribution
from ..core.records import PositionSample
from ..core.object import Object
from ..core import warp
from ..ops.gather import gather_rows
from ..utils import obj as obj_io


@pytree
class TriangleInfo:
    """World-space per-face SoA (reference types.h:162-181)."""

    p0: Any            # (F, 3)
    e1: Any            # (F, 3)
    e2: Any            # (F, 3)
    n0: Any            # (F, 3) vertex normals at face corners
    n1: Any            # (F, 3)
    n2: Any            # (F, 3)
    face_normal: Any   # (F, 3) unit
    face_area: Any     # (F,)
    face_indices: Any  # (F, 3) int32


@pytree
class SecondaryEdgeInfo:
    """World-space silhouette-candidate edges (edge/edge.h:48-70)."""

    p0: Any           # (E, 3) edge start
    e1: Any           # (E, 3) edge vector (p1 - p0)
    n0: Any           # (E, 3) face0 normal
    n1: Any           # (E, 3) face1 normal (0 for boundary edges)
    p2: Any           # (E, 3) third vertex of face0 (orientation ref)
    is_boundary: Any  # (E,) bool


@pytree
class MeshData:
    """Traced output of :meth:`Mesh.configure_data`."""

    vertex_positions: Any   # (V, 3) world space
    tri: TriangleInfo
    tri_uv: Any             # (F, 3, 2) per-corner uv (zeros if no uv)
    total_area: Any         # ()
    face_distrb: DiscreteDistribution
    sec_edge: Optional[SecondaryEdgeInfo]


def build_edge_list(faces: np.ndarray) -> np.ndarray:
    """Edge-map build returning (E, 5) int32.

    Columns: [v_lo, v_hi, face0, face1 (-1 if boundary), third_vertex_of_face0]
    matching the reference's map-based construction (mesh.cpp:112-149): face0
    is the lowest-index face containing the edge, and the third vertex comes
    from that face.  Uses the native C++ builder when available; the numpy
    path below is the fallback and the semantic specification.
    """
    from ..native import build_edge_list as native_edges

    native_out = native_edges(np.asarray(faces, np.int32))
    if native_out is not None:
        return native_out
    f = np.asarray(faces, np.int64)
    nf = f.shape[0]
    # 3 directed edges per face: (vi, vj, face, third)
    v0 = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    v1 = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    v2 = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    fid = np.tile(np.arange(nf, dtype=np.int64), 3)
    lo = np.minimum(v0, v1)
    hi = np.maximum(v0, v1)
    # sort by (lo, hi, fid)
    order = np.lexsort((fid, hi, lo))
    lo, hi, fid, v2 = lo[order], hi[order], fid[order], v2[order]
    key = lo * (f.max() + 1) + hi
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, key.shape[0]))
    e = starts.shape[0]
    out = np.full((e, 5), -1, np.int32)
    out[:, 0] = lo[starts]
    out[:, 1] = hi[starts]
    out[:, 2] = fid[starts]
    has2 = counts >= 2
    out[has2, 3] = fid[starts[has2] + 1]
    out[:, 4] = v2[starts]
    return out


def process_mesh(vertex_positions, face_indices):
    """Compute TriangleInfo + area-weighted vertex normals (mesh.cpp:23-62).

    Differentiable w.r.t. ``vertex_positions``; the vertex-normal scatter uses
    deterministic ``.at[].add`` segment sums instead of CUDA atomics.
    """
    fi = face_indices
    p0 = vertex_positions[fi[:, 0]]
    p1 = vertex_positions[fi[:, 1]]
    p2 = vertex_positions[fi[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    fn = cross(e1, e2)
    fa = norm(fn)

    nv = vertex_positions.shape[0]
    # vertex accumulation as one one-hot matmul instead of 6 scatter-adds
    # (ops/gather.py); this runs inside every differentiable scene compile.
    # corner_idx: (3F,), vals: (3F, 4).
    corner_idx = jnp.reshape(jnp.transpose(fi), (-1,))
    vals = jnp.tile(
        jnp.concatenate([fn, fa[:, None]], axis=1), (3, 1)
    )  # (3F, 4)
    if nv <= 4096:
        oh = jax.nn.one_hot(corner_idx, nv, dtype=vals.dtype)
        acc = jax.lax.dot_general(
            oh, vals, (((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        acc = jnp.zeros((nv, 4), vals.dtype).at[corner_idx].add(vals)
    vertex_normals = normalize(safe_div(acc[:, :3], acc[:, 3:4]))

    face_normal = fn * safe_div(1.0, fa)[:, None]
    face_area = fa * 0.5

    tri = TriangleInfo(
        p0=p0,
        e1=e1,
        e2=e2,
        n0=vertex_normals[fi[:, 0]],
        n1=vertex_normals[fi[:, 1]],
        n2=vertex_normals[fi[:, 2]],
        face_normal=face_normal,
        face_area=face_area,
        face_indices=fi,
    )
    return tri, vertex_normals


class Mesh(Object):
    """User-facing mesh container (mutable, host-side).

    Topology (faces, edges, uv indices) is static numpy; vertex positions and
    the transform stack are jnp leaves that gradients flow through.
    """

    def __init__(self):
        self.vertex_positions_raw = jnp.zeros((0, 3), jnp.float32)
        self.face_indices = np.zeros((0, 3), np.int32)
        self.vertex_uv = None       # (T, 2) jnp or None
        self.face_uv_indices = None  # (F, 3) np or None
        self._edge_rows = np.zeros((0, 5), np.int32)
        self.valid_edge_indices = np.zeros((0, 2), np.int32)
        self.to_world_raw = jnp.eye(4, dtype=jnp.float32)
        self.to_world_left = jnp.eye(4, dtype=jnp.float32)
        self.to_world_right = jnp.eye(4, dtype=jnp.float32)
        self.use_face_normals = False
        self.enable_edges = True
        self.bsdf_id = -1
        self.emitter_id = -1
        self.id = ""

    # -- reference-compatible properties -----------------------------------
    def edge_indices(self):
        """First four columns (v0, v1, face0, face1) of the edge rows.

        Mirrors the reference's ``head<4>(mesh.m_edge_indices)`` accessor
        (src/psdr.cpp:337); the fifth column (the opposite third vertex) is
        internal.
        """
        return np.asarray(self._edge_rows[:, :4])

    @property
    def num_edges(self) -> int:
        return int(self._edge_rows.shape[0])

    @property
    def use_face_normal(self):
        """Reference attribute name (psdr.cpp binds 'use_face_normal')."""
        return self.use_face_normals

    @use_face_normal.setter
    def use_face_normal(self, v):
        self.use_face_normals = bool(v)

    @property
    def vertex_normals(self):
        """Object-space area-weighted vertex normals (mesh.cpp:23-62)."""
        _, vn = process_mesh(
            jnp.asarray(self.vertex_positions_raw),
            jnp.asarray(self.face_indices, jnp.int32),
        )
        return vn

    @property
    def vertex_positions(self):
        """Reference alias: object-space raw positions (psdr.cpp:330-331)."""
        return self.vertex_positions_raw

    @vertex_positions.setter
    def vertex_positions(self, v):
        self.vertex_positions_raw = jnp.asarray(v, jnp.float32)

    def sample_position(self, sample2, active=None) -> PositionSample:
        """Uniform-area surface sampling (reference Mesh.sample_position)."""
        md = self.configure_data(with_edges=False)
        ps = sample_position(md, jnp.asarray(sample2, jnp.float32))
        if active is not None:
            ps = ps.replace(is_valid=ps.is_valid & active)
        return ps

    @property
    def to_world(self):
        return self.to_world_raw

    @to_world.setter
    def to_world(self, m):
        self.to_world_raw = jnp.asarray(m, jnp.float32)

    def set_transform(self, m, left: bool = True):
        if left:
            self.to_world_left = jnp.asarray(m, jnp.float32)
        else:
            self.to_world_right = jnp.asarray(m, jnp.float32)

    def append_transform(self, m, left: bool = True):
        m = jnp.asarray(m, jnp.float32)
        if left:
            self.to_world_left = m @ self.to_world_left
        else:
            self.to_world_right = self.to_world_right @ m

    # -- loading -----------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return self.vertex_positions_raw.shape[0]

    @property
    def num_faces(self) -> int:
        return int(self.face_indices.shape[0])

    @property
    def has_uv(self) -> bool:
        return self.vertex_uv is not None

    def load(self, fname: str, verbose: bool = False):
        data = obj_io.load_obj(fname)
        self.load_raw(
            data["vertices"], data["faces"], data["uvs"], data["face_uvs"],
            verbose=verbose,
        )
        return self

    def load_raw(self, vertices, faces, uvs=None, face_uvs=None,
                 verbose: bool = False):
        """Load from arrays (mesh.cpp:74-162)."""
        self.vertex_positions_raw = jnp.asarray(vertices, jnp.float32).reshape(-1, 3)
        self.face_indices = np.asarray(faces, np.int32).reshape(-1, 3)
        if uvs is not None and len(np.asarray(uvs)):
            self.vertex_uv = jnp.asarray(uvs, jnp.float32).reshape(-1, 2)
            self.face_uv_indices = np.asarray(face_uvs, np.int32).reshape(-1, 3)
        else:
            self.vertex_uv = None
            self.face_uv_indices = None
        if self.enable_edges and self.num_faces > 0:
            self._edge_rows = build_edge_list(self.face_indices)
        else:
            self._edge_rows = np.zeros((0, 5), np.int32)
        if verbose:
            print(
                f"Loaded {self.num_vertices} vertices, {self.num_faces} faces, "
                f"{self._edge_rows.shape[0]} edges."
            )
        return self

    # -- traced configure ----------------------------------------------------
    def configure_data(
        self,
        vertex_positions_raw=None,
        to_world_raw=None,
        to_world_left=None,
        to_world_right=None,
        with_edges: bool = True,
    ) -> MeshData:
        """Pure/traceable: raw params -> world-space MeshData (mesh.cpp:317-382)."""
        vraw = self.vertex_positions_raw if vertex_positions_raw is None else vertex_positions_raw
        m_raw = self.to_world_raw if to_world_raw is None else to_world_raw
        m_left = self.to_world_left if to_world_left is None else to_world_left
        m_right = self.to_world_right if to_world_right is None else to_world_right

        to_world = m_left @ m_raw @ m_right
        vertex_positions = xf.transform_pos(to_world, vraw)

        fi = jnp.asarray(self.face_indices, jnp.int32)
        tri, _ = process_mesh(vertex_positions, fi)
        total_area = jnp.sum(tri.face_area)
        face_distrb = DiscreteDistribution.init(tri.face_area)

        if self.has_uv:
            fuv = jnp.asarray(self.face_uv_indices, jnp.int32)
            tri_uv = jnp.stack(
                [self.vertex_uv[fuv[:, i]] for i in range(3)], axis=1
            )
        else:
            tri_uv = jnp.zeros((self.num_faces, 3, 2), jnp.float32)

        sec_edge = None
        if with_edges and self.enable_edges and self._edge_rows.shape[0] > 0:
            ei = jnp.asarray(self._edge_rows, jnp.int32)
            is_boundary = ei[:, 3] < 0
            f1 = jnp.maximum(ei[:, 3], 0)
            p0 = vertex_positions[ei[:, 0]]
            sec_edge = SecondaryEdgeInfo(
                p0=p0,
                e1=vertex_positions[ei[:, 1]] - p0,
                n0=tri.face_normal[ei[:, 2]],
                n1=jnp.where(
                    is_boundary[:, None], 0.0, tri.face_normal[f1]
                ),
                p2=vertex_positions[ei[:, 4]],
                is_boundary=is_boundary,
            )

        return MeshData(
            vertex_positions=vertex_positions,
            tri=tri,
            tri_uv=tri_uv,
            total_area=total_area,
            face_distrb=face_distrb,
            sec_edge=sec_edge,
        )

    def dump(self, fname: str, raw: bool = False):
        """Write OBJ (mesh.cpp:469-541)."""
        if raw:
            to_world = self.to_world_left @ self.to_world_raw @ self.to_world_right
            verts = np.asarray(xf.transform_pos(to_world, self.vertex_positions_raw))
        else:
            verts = np.asarray(self.vertex_positions_raw)
        normals = None
        if not self.use_face_normals:
            _, vn = process_mesh(jnp.asarray(verts), jnp.asarray(self.face_indices))
            normals = np.asarray(vn)
        obj_io.save_obj(
            fname, verts, self.face_indices,
            uvs=None if self.vertex_uv is None else np.asarray(self.vertex_uv),
            face_uvs=self.face_uv_indices,
            normals=normals,
            use_face_normals=self.use_face_normals,
        )

    def to_string(self) -> str:
        s = f"Mesh[nv={self.num_vertices}, nf={self.num_faces}"
        if self.id:
            s += f", id={self.id}"
        return s + "]"

    __repr__ = to_string


def sample_position(mesh_data: MeshData, sample2) -> PositionSample:
    """Uniform-by-area surface sample with sample reuse (mesh.cpp:413-454).

    ``J = face_area / detach(face_area)`` is the reference's AD-mode Jacobian
    (mesh.cpp:434); its primal value is 1, so the detached path needs no
    special case.
    """
    idx, _, u0 = mesh_data.face_distrb.sample_reuse(sample2[..., 0])
    st = warp.square_to_uniform_triangle(
        jnp.stack([u0, sample2[..., 1]], axis=-1)
    )
    tri = mesh_data.tri
    rows = gather_rows(
        jnp.concatenate(
            [tri.p0, tri.e1, tri.e2, tri.face_normal,
             tri.face_area[:, None]], axis=1
        ),
        idx,
    )
    p0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    face_area = rows[..., 12]
    J = safe_div(face_area, jax.lax.stop_gradient(face_area))
    p = bilinear(p0, e1, e2, st)
    n = rows[..., 9:12]
    inv_total = safe_div(1.0, mesh_data.total_area)
    return PositionSample(
        p=p,
        n=n,
        pdf=jnp.broadcast_to(jax.lax.stop_gradient(inv_total), idx.shape),
        J=J,
        is_valid=jnp.ones(idx.shape, bool),
    )
