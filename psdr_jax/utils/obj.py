"""Wavefront OBJ read/write.

Replacement for the reference's vendored tinyobjloader
(``mesh.cpp:165-314``) and ``Mesh::dump`` (``mesh.cpp:469-541``).  Pure
numpy; polygons are fan-triangulated like tinyobjloader's default.
"""

from __future__ import annotations

import numpy as np


def load_obj(path_or_text: str, from_string: bool = False):
    """Parse an OBJ file.

    Returns dict with ``vertices`` (V,3) f32, ``faces`` (F,3) i32,
    ``uvs`` (T,2) f32 or None, ``face_uvs`` (F,3) i32 or None.
    """
    if from_string:
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()

    from ..native import parse_obj

    native_out = parse_obj(text.encode())
    if native_out is not None:
        return native_out

    lines = text.splitlines()

    vertices: list = []
    uvs: list = []
    faces: list = []
    face_uvs: list = []
    any_uv_idx = False

    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt":
            uvs.append([float(parts[1]), float(parts[2])])
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                comps = tok.split("/")
                vi = int(comps[0])
                vi = vi - 1 if vi > 0 else len(vertices) + vi
                ti = -1
                if len(comps) > 1 and comps[1]:
                    ti = int(comps[1])
                    ti = ti - 1 if ti > 0 else len(uvs) + ti
                    any_uv_idx = True
                corners.append((vi, ti))
            # fan triangulation
            for k in range(1, len(corners) - 1):
                tri = (corners[0], corners[k], corners[k + 1])
                faces.append([c[0] for c in tri])
                face_uvs.append([c[1] for c in tri])

    out = {
        "vertices": np.asarray(vertices, np.float32).reshape(-1, 3),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "uvs": None,
        "face_uvs": None,
    }
    if uvs and any_uv_idx:
        out["uvs"] = np.asarray(uvs, np.float32).reshape(-1, 2)
        out["face_uvs"] = np.asarray(face_uvs, np.int32).reshape(-1, 3)
    return out


def save_obj(path: str, vertices, faces, uvs=None, face_uvs=None,
             normals=None, use_face_normals: bool = False):
    """Write an OBJ file in the reference's dump format (mesh.cpp:469-541)."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    with open(path, "wt") as f:
        for i, v in enumerate(vertices):
            f.write(f"v {v[0]:.6e} {v[1]:.6e} {v[2]:.6e}\n")
            if normals is not None and not use_face_normals:
                n = normals[i]
                f.write(f"vn {n[0]:.6e} {n[1]:.6e} {n[2]:.6e}\n")
        if uvs is not None:
            for t in np.asarray(uvs, np.float64):
                f.write(f"vt {t[0]:.6e} {t[1]:.6e}\n")
            for i, face in enumerate(faces):
                fu = np.asarray(face_uvs[i]) + 1
                v0, v1, v2 = face + 1
                if use_face_normals or normals is None:
                    f.write(f"f {v0}/{fu[0]} {v1}/{fu[1]} {v2}/{fu[2]}\n")
                else:
                    f.write(
                        f"f {v0}/{fu[0]}/{v0} {v1}/{fu[1]}/{v1} {v2}/{fu[2]}/{v2}\n"
                    )
        else:
            for face in faces:
                v0, v1, v2 = face + 1
                if use_face_normals or normals is None:
                    f.write(f"f {v0} {v1} {v2}\n")
                else:
                    f.write(f"f {v0}//{v0} {v1}//{v1} {v2}//{v2}\n")
