"""XML scene loader tests (reference: src/scene/scene_loader.cpp)."""

import numpy as np
import pytest

import psdr_jax as psdr

XML = """
<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
            <lookat origin="0, 1, -4" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="24"/>
            <integer name="height" value="16"/>
        </film>
        <sampler type="independent">
            <integer name="sampleCount" value="2"/>
        </sampler>
    </sensor>
    <bsdf type="diffuse" id="white">
        <rgb name="reflectance" value="0.8, 0.8, 0.8"/>
    </bsdf>
    <bsdf type="roughconductor" id="metal">
        <float name="alpha" value="0.2"/>
    </bsdf>
    <bsdf type="roughdielectric" id="glass">
        <float name="alpha" value="0.1"/>
        <float name="intIOR" value="1.5"/>
    </bsdf>
    <bsdf type="microfacet" id="mf">
        <rgb name="diffuseReflectance" value="0.4, 0.3, 0.2"/>
        <float name="roughness" value="0.3"/>
    </bsdf>
    <shape type="obj">
        <string name="filename" value="floor.obj"/>
        <ref id="white"/>
        <transform name="toWorld">
            <scale value="2"/>
            <translate x="0" y="0" z="0"/>
        </transform>
    </shape>
    <shape type="obj">
        <string name="filename" value="light.obj"/>
        <ref id="white"/>
        <emitter type="area">
            <rgb name="radiance" value="10, 10, 10"/>
        </emitter>
    </shape>
</scene>
"""

FLOOR_OBJ = """
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
f 1 2 3
f 1 3 4
"""

LIGHT_OBJ = """
v -0.5 2 -0.5
v 0.5 2 -0.5
v 0.5 2 0.5
v -0.5 2 0.5
f 1 2 3
f 1 3 4
"""


@pytest.fixture()
def scene_dir(tmp_path):
    (tmp_path / "floor.obj").write_text(FLOOR_OBJ)
    (tmp_path / "light.obj").write_text(LIGHT_OBJ)
    (tmp_path / "scene.xml").write_text(XML)
    return tmp_path


def test_load_file(scene_dir):
    sc = psdr.load_file(str(scene_dir / "scene.xml"))
    assert sc.opts.width == 24 and sc.opts.height == 16
    assert sc.opts.spp == 2
    assert len(sc.sensors) == 1
    assert len(sc.bsdfs) == 4
    assert len(sc.meshes) == 2
    assert len(sc.emitters) == 1
    assert "BSDF[id=metal]" in sc.param_map
    # scale applied through to_world
    md = sc.meshes[0].configure_data()
    assert float(md.vertex_positions[:, 0].max()) == pytest.approx(2.0)


def test_loaded_scene_renders(scene_dir):
    sc = psdr.load_file(str(scene_dir / "scene.xml"))
    sc.opts.spp = 4
    sc.configure()
    img = np.asarray(psdr.PathTracer(1).renderC(sc, 0))
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_loader_reference_node_ordering_and_paths(tmp_path):
    """Reference semantics fixed by review (scene_loader.cpp:209-245):
    a <shape> may <ref> a BSDF defined later in the document (the
    reference iterates sensors, bsdfs, emitters, shapes in that order),
    the sensor honours its first <transform> child regardless of the name
    attribute, textured BSDF parameters load and resolve against the
    scene's directory, and roughconductor alpha accepts a texture."""
    import os
    from psdr_jax.utils.image import write_pfm

    # assets in the scene dir
    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n"
    )
    tex = np.full((4, 4, 3), 0.25, np.float32)
    write_pfm(str(tmp_path / "alb.pfm"), tex)
    alpha_tex = np.full((4, 4, 3), 0.3, np.float32)
    write_pfm(str(tmp_path / "alpha.pfm"), alpha_tex)

    xml = """
    <scene version="0.5.0">
        <shape type="obj">
            <string name="filename" value="quad.obj"/>
            <ref id="later_mat"/>
        </shape>
        <shape type="obj">
            <string name="filename" value="quad.obj"/>
            <ref id="metal"/>
        </shape>
        <sensor type="perspective">
            <float name="fov" value="45"/>
            <transform name="to_world">
                <translate x="0" y="0" z="-5"/>
            </transform>
            <film type="hdrfilm">
                <integer name="width" value="8"/>
                <integer name="height" value="8"/>
            </film>
        </sensor>
        <bsdf type="diffuse" id="later_mat">
            <texture name="reflectance" type="bitmap">
                <string name="filename" value="alb.pfm"/>
            </texture>
        </bsdf>
        <bsdf type="roughconductor" id="metal">
            <texture name="alpha" type="bitmap">
                <string name="filename" value="alpha.pfm"/>
            </texture>
        </bsdf>
    </scene>
    """
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    cwd = os.getcwd()
    try:
        os.chdir("/")  # prove texture paths resolve against the scene dir
        sc = psdr.Scene()
        sc.load_file(str(path), auto_configure=False)
    finally:
        os.chdir(cwd)
    # sensor transform with name != "toWorld" was honoured
    assert abs(float(np.asarray(sc.sensors[0].to_world_raw)[2, 3]) + 5) < 1e-6
    # texture loaded from the scene dir
    refl = sc.param_map["BSDF[id=later_mat]"].reflectance
    assert refl.resolution == (4, 4)
    np.testing.assert_allclose(np.asarray(refl.data).ravel()[0], 0.25)
    # roughconductor textured alpha survives (was silently dropped to 0.1)
    alpha = sc.param_map["BSDF[id=metal]"].alpha_u
    np.testing.assert_allclose(
        float(np.asarray(alpha.data).ravel()[0]), 0.3, rtol=1e-6
    )
