"""Reference (psdr-jit) API-compatibility surface tests.

A user of the reference should find the same entry points here
(psdr.cpp:100-441 binding list).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import psdr_jax as psdr
from scenes import make_cbox


def test_module_surface():
    """Full reference name list from the pybind registrations
    (psdr.cpp:100-441 py::class_/def calls)."""
    for name in (
        "Object", "Scene", "RenderOption", "Mesh",
        "RayC", "RayD", "FrameC", "FrameD",
        "InteractionC", "InteractionD", "IntersectionC", "IntersectionD",
        "SampleRecordC", "SampleRecordD", "PositionSampleC", "PositionSampleD",
        "SensorDirectSample",
        "BSDF", "DiffuseBSDF", "MicrofacetBSDF",
        "MicrofacetBSDFPerVertex", "RoughConductorBSDF", "RoughDielectricBSDF",
        "NormalMapBSDF",
        "Emitter", "AreaLight", "EnvironmentMap",
        "Sensor", "PerspectiveCamera", "OrthographicCamera",
        "Integrator", "PathTracer", "Direct", "CollocatedIntegrator",
        "FieldExtractionIntegrator", "Bitmap1fD", "Bitmap3fD", "Sampler",
        "DiscreteDistribution", "EdgeSortOption", "AQ_Option",
        "drjit_test", "drjit_memory", "optix_jit_test",
    ):
        assert hasattr(psdr, name), name
    # class hierarchy matches the reference's py::class_ bases
    for cls in (psdr.Mesh, psdr.BSDF, psdr.Emitter, psdr.Sensor,
                psdr.Scene, psdr.Integrator):
        assert issubclass(cls, psdr.Object), cls
    assert issubclass(psdr.DiffuseBSDF, psdr.BSDF)
    assert issubclass(psdr.AreaLight, psdr.Emitter)
    assert issubclass(psdr.EnvironmentMap, psdr.Emitter)
    assert issubclass(psdr.PerspectiveCamera, psdr.Sensor)
    assert issubclass(psdr.OrthographicCamera, psdr.Sensor)
    assert issubclass(psdr.PathTracer, psdr.Integrator)


def test_sampler_seed_spelling():
    """Sampler.seed(...) as the reference spells it (psdr.cpp:183); the
    historical seed_ alias keeps working."""
    s = psdr.Sampler()
    s.seed(jnp.arange(8, dtype=jnp.uint32))
    a = np.asarray(s.next_1d())
    s2 = psdr.Sampler()
    s2.seed_(jnp.arange(8, dtype=jnp.uint32))
    np.testing.assert_array_equal(a, np.asarray(s2.next_1d()))


def test_smoke_functions():
    assert psdr.drjit_test()
    assert psdr.drjit_memory()
    assert psdr.optix_jit_test()


def test_render_arg_conventions():
    """seed=-1 uses scene.seed; batch_pix is an alias for pix_id."""
    sc = make_cbox(width=8, height=8, spp=2)
    sc.seed = 3
    sc.configure()
    integ = psdr.PathTracer(1)
    a = np.asarray(integ.renderC(sc, 0, seed=3))
    b = np.asarray(integ.renderC(sc, 0, seed=-1))
    np.testing.assert_array_equal(a, b)
    crop = np.asarray(
        integ.renderC(sc, 0, seed=3, batch_pix=jnp.arange(4, 10))
    )
    np.testing.assert_array_equal(crop, a[4:10])


def test_scene_load_string_method():
    xml = """
<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
</scene>
"""
    sc = psdr.Scene()
    # auto_configure=False because the scene has no meshes yet
    sc.load_string(xml, auto_configure=False)
    assert sc.opts.width == 8
    assert len(sc.sensors) == 1


def test_unit_ray_intersect():
    sc = make_cbox(width=8, height=8, spp=1)
    sc.configure()
    # ray from the camera toward the back wall
    its = sc.unit_ray_intersect(
        np.asarray([[278.0, 273.0, -500.0]], np.float32),
        np.asarray([[0.0, 0.0, 1.0]], np.float32),
    )
    assert bool(its.valid[0])
    assert float(its.t[0]) > 100.0
    its_ad = sc.unit_ray_intersectAD(
        np.asarray([[278.0, 273.0, -500.0]], np.float32),
        np.asarray([[0.0, 0.0, 1.0]], np.float32),
    )
    np.testing.assert_allclose(float(its_ad.t[0]), float(its.t[0]), rtol=1e-4)


def test_mesh_reference_attrs():
    m = psdr.Mesh()
    m.load_raw(
        np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    m.use_face_normal = True           # reference spelling
    assert m.use_face_normals is True
    vn = np.asarray(m.vertex_normals)
    np.testing.assert_allclose(vn, [[0, 0, 1]] * 4, atol=1e-6)
    ps = m.sample_position(np.full((16, 2), 0.5, np.float32))
    assert np.asarray(ps.is_valid).all()
    np.testing.assert_allclose(np.asarray(ps.pdf), 1.0, rtol=1e-5)
    m.vertex_positions = m.vertex_positions_raw * 2.0  # reference alias
    assert float(np.asarray(m.vertex_positions_raw).max()) == 2.0


def test_bitmap_reference_attrs(tmp_path):
    b = psdr.Bitmap3fD((0.25, 0.5, 0.75))
    b.translate = (0.1, 0.2)
    b.rotate = 0.3
    np.testing.assert_allclose(np.asarray(b.trans), [0.1, 0.2], rtol=1e-6)

    from psdr_jax import native
    if native.available():
        img = np.random.default_rng(0).uniform(0, 1, (4, 6, 3)).astype(np.float32)
        path = str(tmp_path / "t.exr")
        native.write_exr(path, img)
        b2 = psdr.Bitmap3fD(path)
        np.testing.assert_allclose(np.asarray(b2.data), img, rtol=1e-6)
        env = psdr.EnvironmentMap(path)
        assert env.radiance.resolution == (6, 4)


def test_collocated_m_intensity():
    c = psdr.CollocatedIntegrator(100.0)
    np.testing.assert_allclose(np.asarray(c.m_intensity), [100.0] * 3)
    c.m_intensity = 5.0
    np.testing.assert_allclose(np.asarray(c.intensity), [5.0] * 3)


def test_perspective_intrinsic_ctor():
    cam = psdr.PerspectiveCamera(1.0, 1.2, 0.5, 0.5, 1e-3, 1e4)
    assert cam.use_intrinsic
    assert cam.fx == 1.0 and cam.fy == 1.2
    sd = cam.configure_data(16, 16)
    assert sd.sample_to_camera.shape == (4, 4)


def test_render_option_positional_ctors():
    """Reference positional constructors (types.h:217-222, psdr.cpp:127-129):
    3-arg sets spp=sppe=sppse; 4-arg sets sppe=sppse."""
    o = psdr.RenderOption(512, 512, 32)
    assert (o.width, o.height, o.spp, o.sppe, o.sppse) == (512, 512, 32, 32, 32)
    o = psdr.RenderOption(512, 256, 32, 8)
    assert (o.spp, o.sppe, o.sppse) == (32, 8, 8)
    o = psdr.RenderOption(512, 256, 32, 8, 4)
    assert (o.spp, o.sppe, o.sppse) == (32, 8, 4)
    o = psdr.RenderOption()
    assert (o.width, o.height, o.spp) == (128, 128, 1)


def test_mesh_edge_indices_accessors():
    """Mesh.edge_indices() head-4 accessor + valid_edge_indices attribute
    (psdr.cpp:335-338)."""
    m = psdr.Mesh()
    m.load_raw(
        np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    )
    ei = m.edge_indices()
    assert ei.shape == (5, 4)           # 5 edges of a 2-triangle quad
    assert ei.dtype == np.int32
    # columns are (v0, v1, face0, face1)
    assert set(map(tuple, ei[:, :2])) == {
        (0, 1), (1, 2), (0, 2), (2, 3), (0, 3)}
    m.valid_edge_indices = ei[:2, :2]   # user-writable, unused internally
    assert m.valid_edge_indices.shape == (2, 2)
    assert m.num_edges == 5


def test_add_envmap_filename_overload(tmp_path):
    """Scene.add_EnvironmentMap(filename, to_world, scale)
    (psdr.cpp:397, scene.cpp:85-96) and the one-envmap assert."""
    from psdr_jax import native
    if not native.available():
        pytest.skip("native EXR codec unavailable")
    img = np.random.default_rng(1).uniform(0, 1, (4, 8, 3)).astype(np.float32)
    path = str(tmp_path / "env.exr")
    native.write_exr(path, img)
    sc = psdr.Scene()
    t = np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = 2.0
    sc.add_EnvironmentMap(path, t, 3.0)
    assert sc.emitter_env is not None
    np.testing.assert_allclose(float(sc.emitter_env.scale), 3.0)
    np.testing.assert_allclose(np.asarray(sc.emitter_env.to_world_raw), t)
    np.testing.assert_allclose(
        np.asarray(sc.emitter_env.radiance.data), img, rtol=1e-6)
    with pytest.raises(AssertionError):
        sc.add_EnvironmentMap(psdr.EnvironmentMap())


def test_add_normalmap_bsdf():
    sc = make_cbox(width=8, height=8, spp=1)
    n = sc.add_normalmap_BSDF(
        psdr.Bitmap3fD((0.5, 0.5, 1.0)), psdr.DiffuseBSDF([0.5] * 3), "nm"
    )
    assert sc.bsdf_ids[n] == "nm"
    assert "BSDF[id=nm]" in sc.param_map


def test_former_package_name_is_an_alias():
    """The package's former name (the ``psdr_jit_*`` directory beside
    ``psdr_jax``) imports as ``psdr_jax`` itself, submodules included:
    the same module objects, not a second copy."""
    import importlib
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(psdr.__file__)))
    (old,) = [d for d in os.listdir(root) if d.startswith("psdr_jit_")
              and os.path.isfile(os.path.join(root, d, "__init__.py"))]
    assert importlib.import_module(old) is psdr
    from psdr_jax.ops import intersect

    mod = importlib.import_module(old + ".ops.intersect")
    assert mod is intersect
    assert mod.__spec__.name == "psdr_jax.ops.intersect"
