"""Native host-ops library tests (C++ hostops vs numpy fallbacks)."""

import os
import numpy as np
import pytest

from psdr_jax import native
from psdr_jax.utils import obj as obj_io


requires_native = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


def test_native_builds():
    assert native.available(), "hostops.so failed to build (g++ available?)"


@requires_native
def test_edge_list_matches_numpy():
    rng = np.random.default_rng(0)
    # random closed-ish topology: grid mesh
    n = 17
    idx = lambda i, j: i * n + j
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            faces.append([idx(i, j), idx(i + 1, j), idx(i, j + 1)])
            faces.append([idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)])
    faces = np.asarray(faces, np.int32)

    got = native.build_edge_list(faces)

    # numpy specification (same algorithm as mesh.build_edge_list fallback)
    f = faces.astype(np.int64)
    nf = f.shape[0]
    v0 = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    v1 = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    v2 = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    fid = np.tile(np.arange(nf, dtype=np.int64), 3)
    lo, hi = np.minimum(v0, v1), np.maximum(v0, v1)
    order = np.lexsort((fid, hi, lo))
    lo, hi, fid, v2 = lo[order], hi[order], fid[order], v2[order]
    key = lo * (f.max() + 1) + hi
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, key.shape[0]))
    exp = np.full((starts.shape[0], 5), -1, np.int32)
    exp[:, 0] = lo[starts]
    exp[:, 1] = hi[starts]
    exp[:, 2] = fid[starts]
    has2 = counts >= 2
    exp[has2, 3] = fid[starts[has2] + 1]
    exp[:, 4] = v2[starts]

    np.testing.assert_array_equal(got, exp)


@requires_native
def test_obj_parse_matches_python():
    text = """
# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
f 1/1 2/2 3/3 4/4
f -4/-4 -2/-2 -1/-1
"""
    nat = native.parse_obj(text.encode())
    assert nat is not None
    # quad fan-triangulates into 2 + the second face into 1 -> 3 faces
    assert nat["faces"].shape == (3, 3)
    np.testing.assert_array_equal(nat["faces"][0], [0, 1, 2])
    np.testing.assert_array_equal(nat["faces"][1], [0, 2, 3])
    np.testing.assert_array_equal(nat["faces"][2], [0, 2, 3])
    assert nat["uvs"].shape == (4, 2)
    np.testing.assert_array_equal(nat["face_uvs"][0], [0, 1, 2])


@requires_native
def test_exr_roundtrip():
    rng = np.random.default_rng(1)
    for shape in ((7, 5, 3), (16, 33, 1), (40, 17, 4)):
        img = rng.uniform(0, 100, shape).astype(np.float32)
        import tempfile, os

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "t.exr")
            native.write_exr(path, img)
            back = native.read_exr(path)
        assert back.shape == img.shape
        np.testing.assert_allclose(back, img, rtol=1e-6)


@requires_native
def test_exr_large_roundtrip():
    """Multi-block (>16 scanlines) with non-compressible data."""
    rng = np.random.default_rng(2)
    img = rng.normal(size=(100, 64, 3)).astype(np.float32)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.exr")
        native.write_exr(path, img)
        back = native.read_exr(path)
    np.testing.assert_allclose(back, img, rtol=1e-6)


def test_morton_order_locality():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    order = native.morton_order(pts)
    assert sorted(order.tolist()) == list(range(4096))
    # consecutive points in morton order are closer than random order
    sorted_pts = pts[order]
    d_morton = np.linalg.norm(np.diff(sorted_pts, axis=0), axis=1).mean()
    d_random = np.linalg.norm(np.diff(pts, axis=0), axis=1).mean()
    assert d_morton < 0.5 * d_random


def test_obj_file_roundtrip_via_loader(tmp_path):
    """utils.obj.load_obj routes through the native parser when available."""
    verts = np.asarray(
        [[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]], np.float32
    )
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    path = str(tmp_path / "x.obj")
    obj_io.save_obj(path, verts, faces)
    out = obj_io.load_obj(path)
    np.testing.assert_allclose(out["vertices"], verts, atol=1e-5)
    np.testing.assert_array_equal(out["faces"], faces)


# ---------------------------------------------------------------------------
# PIZ codec (wavelet + Huffman, from the OpenEXR spec)
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_piz_roundtrip_exact():
    """FLOAT-channel PIZ is lossless: write+read must be bit-exact,
    including multi-block images (>32 scanlines) and odd sizes."""
    rng = np.random.default_rng(0)
    for shape in [(67, 41, 3), (200, 130, 3), (33, 17, 1), (32, 64, 4),
                  (1, 7, 3), (100, 1, 3)]:
        img = (rng.normal(size=shape) * 100).astype(np.float32)
        img.flat[::7] = 0.0
        path = "/tmp/piz_rt.exr"
        native.write_exr(path, img, compression="piz")
        back = native.read_exr(path)
        if back.ndim == 3 and img.shape[-1] == 1:
            back = back[..., :1]
        np.testing.assert_array_equal(back.reshape(img.shape), img)


@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_piz_smaller_than_zip_on_halfish_data():
    """PIZ exists because it beats ZIP on natural HDR data; sanity-check the
    encoder actually compresses (not a store-raw fallback)."""
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:128, 0:128]
    img = np.stack([np.sin(x / 9.0) + y / 64.0,
                    np.cos(y / 7.0), (x + y) / 256.0], -1).astype(np.float32)
    native.write_exr("/tmp/piz_c.exr", img, compression="piz")
    native.write_exr("/tmp/zip_c.exr", img, compression="zip")
    raw_bytes = img.nbytes
    assert os.path.getsize("/tmp/piz_c.exr") < raw_bytes


_BALLROOM = "/root/reference/tutorials/data/envmap/ballroom_1k.exr"


@pytest.mark.skipif(not native.available() or not os.path.exists(_BALLROOM),
                    reason="no native lib or reference asset")
def test_piz_decodes_openexr_file():
    """Decode a PIZ file produced by the real OpenEXR library (the
    reference's shipped envmap).  A convention mismatch anywhere in the
    wavelet/Huffman/bitmap pipeline produces high-frequency garbage, which
    the spatial-correlation bound rejects."""
    img = native.read_exr(_BALLROOM)
    assert img.shape == (512, 1024, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and 0.1 < img.mean() < 10.0
    d = np.abs(np.diff(img, axis=1)).mean()
    assert d / img.mean() < 0.3, "decoded image is not spatially smooth"


@pytest.mark.skipif(not native.available(), reason="no native lib")
def test_piz_corrupt_file_errors_cleanly(tmp_path):
    img = np.ones((40, 40, 3), np.float32)
    path = str(tmp_path / "c.exr")
    native.write_exr(path, img, compression="piz")
    data = bytearray(open(path, "rb").read())
    data[-30:] = bytes(30)  # stomp the huffman stream
    open(path, "wb").write(bytes(data))
    with pytest.raises(Exception):
        native.read_exr(path)
