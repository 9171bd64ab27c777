"""Procedural test scenes (Cornell box from the canonical Cornell data).

Geometry is generated in code rather than loaded from the reference's OBJ
assets; coordinates are the classic published Cornell-box measurements.
"""

from __future__ import annotations

import numpy as np

import psdr_jax as psdr


def _quads_to_mesh(quads, use_face_normals=True):
    verts = []
    faces = []
    for q in quads:
        base = len(verts)
        verts.extend(q)
        n = len(q)
        for k in range(1, n - 1):
            faces.append([base, base + k, base + k + 1])
    mesh = psdr.Mesh()
    mesh.use_face_normals = use_face_normals
    mesh.load_raw(np.asarray(verts, np.float32), np.asarray(faces, np.int32))
    return mesh


FLOOR = [[(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)]]
CEILING = [[(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2),
            (0, 548.8, 0)]]
BACK = [[(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
         (556, 548.8, 559.2)]]
GREEN_WALL = [[(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)]]
RED_WALL = [[(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
             (556, 548.8, 0)]]
LIGHT = [[(343, 548.8, 227), (343, 548.8, 332), (213, 548.8, 332),
          (213, 548.8, 227)]]
SHORT_BLOCK = [
    [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
    [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
    [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
    [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
    [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
]
TALL_BLOCK = [
    [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
    [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
    [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
    [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
    [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
]


def make_cbox(width=64, height=64, spp=4, sppe=0, sppse=0,
              light_radiance=(20.0, 20.0, 8.0), light_offset_y=-0.5,
              max_blocks=2, fov=39.0):
    """Cornell box mirroring the README example scene (README.md:50-80)."""
    sc = psdr.Scene()
    sc.opts.width = width
    sc.opts.height = height
    sc.opts.spp = spp
    sc.opts.sppe = sppe
    sc.opts.sppse = sppse

    cam = psdr.PerspectiveCamera(fov, 1e-6, 1e7)
    cam.to_world = np.array(
        [[1.0, 0, 0, 278.0], [0, 1, 0, 273.0], [0, 0, 1, -800.0],
         [0, 0, 0, 1.0]], np.float32
    )
    sc.add_Sensor(cam)

    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "light")
    sc.add_BSDF(psdr.DiffuseBSDF([0.7, 0.7, 0.7]), "box")
    sc.add_BSDF(psdr.DiffuseBSDF([0.95, 0.95, 0.95]), "white")
    sc.add_BSDF(psdr.DiffuseBSDF([0.20, 0.90, 0.20]), "green")
    sc.add_BSDF(psdr.DiffuseBSDF([0.90, 0.20, 0.20]), "red")

    light = _quads_to_mesh(LIGHT)
    light.to_world_raw = np.array(
        [[1.0, 0, 0, 0], [0, 1, 0, light_offset_y], [0, 0, 1, 0],
         [0, 0, 0, 1.0]], np.float32
    )
    sc.add_Mesh(light, None, "light", psdr.AreaLight(light_radiance))

    blocks = [SHORT_BLOCK, TALL_BLOCK][:max_blocks]
    for b in blocks:
        sc.add_Mesh(_quads_to_mesh(b), None, "box", None)
    sc.add_Mesh(_quads_to_mesh(FLOOR), None, "white", None)
    sc.add_Mesh(_quads_to_mesh(CEILING), None, "white", None)
    sc.add_Mesh(_quads_to_mesh(BACK), None, "white", None)
    sc.add_Mesh(_quads_to_mesh(GREEN_WALL), None, "green", None)
    sc.add_Mesh(_quads_to_mesh(RED_WALL), None, "red", None)
    return sc


REF_BUNNY = "/root/reference/tutorials/data/mesh/bunny_low.obj"
REF_BALLROOM = "/root/reference/tutorials/data/envmap/ballroom_1k.exr"


def make_bunny_envmap(width=128, height=128, spp=32, sppe=0, sppse=0,
                      bunny_path=REF_BUNNY, envmap_path=REF_BALLROOM):
    """The Forward_AD_envmap.ipynb tutorial scene (BASELINE config #3):
    Microfacet bunny at z=-100 lit by the ballroom lat-long envmap, fov-80
    camera with a mirrored to_world.  Assets are the reference's own,
    loaded at runtime (never copied); raises FileNotFoundError if absent.
    """
    import os

    if not (os.path.exists(bunny_path) and os.path.exists(envmap_path)):
        raise FileNotFoundError("reference tutorial assets not available")
    import jax.numpy as jnp

    sc = psdr.Scene()
    sc.opts = psdr.RenderOption(width, height, spp, sppe, sppse)
    sensor = psdr.PerspectiveCamera(80, 0.000001, 10000000.0)
    sensor.to_world = jnp.asarray(
        [[-1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, -1.0, 0], [0, 0, 0, 1.0]],
        jnp.float32)
    sc.add_Sensor(sensor)
    sc.add_BSDF(
        psdr.MicrofacetBSDF([0.2, 0.9, 0.9], [0.01] * 3, 0.3), "bunny")
    eye = jnp.eye(4, dtype=jnp.float32)
    sc.add_Mesh(bunny_path, eye.at[2, 3].set(-100.0), "bunny", None)
    sc.add_EnvironmentMap(envmap_path, np.eye(4, dtype=np.float32), 1.0)
    return sc


def _icosphere(subdiv: int):
    """Unit icosphere: icosahedron subdivided ``subdiv`` times
    (20 * 4^subdiv faces).  Procedural — classic construction."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        edges = {}
        verts = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                edges[key] = len(verts) - 1
            return edges[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def make_gallery(width=128, height=128, spp=4, sppe=0, sppse=0,
                 n_spheres=80, subdiv=3, seed=0, edge_spheres=0):
    """Large-scene end-to-end workload: a lit box room filled with a jittered
    grid of smooth-shaded icospheres — ``n_spheres * 20 * 4^subdiv``
    triangles (default 102,400), exercising the many-chunk intersection
    path inside a real render (the reference handles such scenes natively
    through its compacted OptiX GAS, scene_optix.cpp:265-333).

    ``edge_spheres``: enable boundary-edge extraction on the first N
    spheres (curved silhouettes in the secondary-edge set) — used by the
    differentiable large-scene bench metric; default off (forward
    metric)."""
    sc = psdr.Scene()
    sc.opts = psdr.RenderOption(width, height, spp, sppe, sppse)

    cam = psdr.PerspectiveCamera(55.0, 1e-4, 1e5)
    cam.to_world = np.array(
        [[1.0, 0, 0, 5.0], [0, 1.0, 0, 5.0], [0, 0, 1.0, -9.0],
         [0, 0, 0, 1.0]], np.float32
    )
    sc.add_Sensor(cam)

    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "light")
    sc.add_BSDF(psdr.DiffuseBSDF([0.75, 0.73, 0.70]), "wall")
    for i in range(6):
        sc.add_BSDF(psdr.DiffuseBSDF(
            [0.2 + 0.12 * (i % 3), 0.25 + 0.1 * ((i + 1) % 3),
             0.3 + 0.11 * ((i + 2) % 3)]), f"m{i}")

    light = _quads_to_mesh(
        [[(3.5, 9.98, 3.5), (6.5, 9.98, 3.5), (6.5, 9.98, 6.5),
          (3.5, 9.98, 6.5)]]
    )
    sc.add_Mesh(light, None, "light", psdr.AreaLight((40.0, 38.0, 34.0)))

    # envelope box [0,10]^3, open front
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 0), (0, 0, 10), (10, 0, 10), (10, 0, 0)]]), None, "wall")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 10, 0), (10, 10, 0), (10, 10, 10), (0, 10, 10)]]), None,
        "wall")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 10), (0, 10, 10), (10, 10, 10), (10, 0, 10)]]), None,
        "wall")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 0), (0, 10, 0), (0, 10, 10), (0, 0, 10)]]), None, "wall")
    sc.add_Mesh(_quads_to_mesh(
        [[(10, 0, 0), (10, 0, 10), (10, 10, 10), (10, 10, 0)]]), None,
        "wall")

    rng = np.random.default_rng(seed)
    sv, sf = _icosphere(subdiv)
    side = int(np.ceil(n_spheres ** (1.0 / 3.0)))
    placed = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if placed >= n_spheres:
                    break
                c = (np.asarray([ix, iy, iz]) + 0.5) / side * 8.0 + 1.0
                c += rng.uniform(-0.3, 0.3, 3)
                r = rng.uniform(0.35, 0.6)
                m = psdr.Mesh()
                # edge terms off for the bulk of the gallery (forward
                # metric); the first ``edge_spheres`` keep their edges
                m.enable_edges = placed < edge_spheres
                m.load_raw(sv * r + c[None, :], sf)
                sc.add_Mesh(m, None, f"m{placed % 6}")
                placed += 1
    return sc


def _box_quads(cx, cy, cz, sx, sy, sz, ry=0.0):
    """Axis-aligned box quads centered at (cx,cy,cz), rotated ``ry`` rad
    about +y.  Outward-facing winding."""
    hx, hy, hz = sx / 2.0, sy / 2.0, sz / 2.0
    c, s = np.cos(ry), np.sin(ry)

    def pt(x, y, z):
        xr = c * x + s * z
        zr = -s * x + c * z
        return (cx + xr, cy + y, cz + zr)

    quads = [
        # +y (top), -y (bottom)
        [pt(-hx, hy, -hz), pt(-hx, hy, hz), pt(hx, hy, hz), pt(hx, hy, -hz)],
        [pt(-hx, -hy, -hz), pt(hx, -hy, -hz), pt(hx, -hy, hz),
         pt(-hx, -hy, hz)],
        # +x, -x
        [pt(hx, -hy, -hz), pt(hx, hy, -hz), pt(hx, hy, hz), pt(hx, -hy, hz)],
        [pt(-hx, -hy, -hz), pt(-hx, -hy, hz), pt(-hx, hy, hz),
         pt(-hx, hy, -hz)],
        # +z, -z
        [pt(-hx, -hy, hz), pt(hx, -hy, hz), pt(hx, hy, hz), pt(-hx, hy, hz)],
        [pt(-hx, -hy, -hz), pt(-hx, hy, -hz), pt(hx, hy, -hz),
         pt(hx, -hy, -hz)],
    ]
    return quads


def make_room(width=64, height=64, spp=4, sppe=0, sppse=0,
              light_radiance=(30.0, 28.0, 24.0)):
    """Room-scale scene for BASELINE config #5 (psdr-room style).

    ~12 meshes (walls/floor/ceiling, a table with four legs, three objects,
    a ceiling light panel), mixed BSDF families (diffuse / microfacet /
    rough conductor), full edge-term support.  Procedural — no reference
    assets.  Units: meters; room spans x,z in [0,5], y in [0,3].
    """
    sc = psdr.Scene()
    sc.opts.width = width
    sc.opts.height = height
    sc.opts.spp = spp
    sc.opts.sppe = sppe
    sc.opts.sppse = sppse

    cam = psdr.PerspectiveCamera(55.0, 1e-4, 1e5)
    # look from the open (-z) side into the room
    cam.to_world = np.array(
        [[1.0, 0, 0, 2.5], [0, 1.0, 0, 1.5], [0, 0, 1.0, -4.2],
         [0, 0, 0, 1.0]], np.float32
    )
    sc.add_Sensor(cam)

    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "light")
    sc.add_BSDF(psdr.DiffuseBSDF([0.72, 0.70, 0.66]), "plaster")
    sc.add_BSDF(psdr.DiffuseBSDF([0.45, 0.30, 0.18]), "wood_d")
    sc.add_BSDF(psdr.MicrofacetBSDF(
        [0.04, 0.04, 0.04], [0.50, 0.33, 0.20], 0.25), "wood")
    sc.add_BSDF(psdr.RoughConductorBSDF(
        alpha_u=0.15, eta=[0.2, 0.92, 1.1], k=[3.9, 2.45, 2.14],
        specular_reflectance=[1.0, 0.78, 0.42]), "brass")
    sc.add_BSDF(psdr.DiffuseBSDF([0.20, 0.35, 0.70]), "blue")
    sc.add_BSDF(psdr.DiffuseBSDF([0.75, 0.25, 0.20]), "red")

    light = _quads_to_mesh(
        [[(2.0, 2.98, 2.0), (3.0, 2.98, 2.0), (3.0, 2.98, 3.0),
          (2.0, 2.98, 3.0)]]
    )
    sc.add_Mesh(light, None, "light", psdr.AreaLight(light_radiance))

    # envelope: floor, ceiling, back wall, left, right (open front)
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 0), (0, 0, 5), (5, 0, 5), (5, 0, 0)]]), None, "plaster")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 3, 0), (5, 3, 0), (5, 3, 5), (0, 3, 5)]]), None, "plaster")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 5), (0, 3, 5), (5, 3, 5), (5, 0, 5)]]), None, "plaster")
    sc.add_Mesh(_quads_to_mesh(
        [[(0, 0, 0), (0, 3, 0), (0, 3, 5), (0, 0, 5)]]), None, "red")
    sc.add_Mesh(_quads_to_mesh(
        [[(5, 0, 0), (5, 0, 5), (5, 3, 5), (5, 3, 0)]]), None, "blue")

    # table: top + 4 legs (microfacet wood)
    sc.add_Mesh(_quads_to_mesh(_box_quads(2.5, 0.78, 2.5, 1.6, 0.06, 1.0)),
                None, "wood")
    for dx, dz in [(-0.7, -0.4), (0.7, -0.4), (-0.7, 0.4), (0.7, 0.4)]:
        sc.add_Mesh(
            _quads_to_mesh(_box_quads(2.5 + dx, 0.375, 2.5 + dz,
                                      0.08, 0.75, 0.08)),
            None, "wood_d")

    # objects on the table: brass block (rotated), diffuse box, tall prism
    sc.add_Mesh(_quads_to_mesh(
        _box_quads(2.15, 0.96, 2.45, 0.3, 0.3, 0.3, ry=0.5)), None, "brass")
    sc.add_Mesh(_quads_to_mesh(
        _box_quads(2.95, 0.91, 2.3, 0.22, 0.2, 0.22, ry=-0.3)), None, "red")
    sc.add_Mesh(_quads_to_mesh(
        _box_quads(2.6, 1.11, 2.75, 0.16, 0.6, 0.16, ry=0.9)), None, "blue")
    return sc
