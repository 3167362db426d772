import numpy as np
import pytest

from spcbpt_tpu.scene import cornell
from spcbpt_tpu.scene.parser import load_scene
from spcbpt_tpu.scene.scene import build_scene, load_trace_scene


@pytest.fixture(scope="module")
def cornell_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return cornell.generate(str(root))


def test_parse_cornell(cornell_path):
    desc = load_scene(cornell_path)
    assert desc.width == 512 and desc.height == 512
    assert desc.has_camera
    assert len(desc.meshes) == 5
    assert "White" in desc.materials and "Red" in desc.materials
    assert len(desc.lights) == 1
    l = desc.lights[0]
    assert l.light_type == "Quad"
    assert l.div_level == 8
    np.testing.assert_allclose(l.area, 130 * 105, rtol=1e-5)
    # normal points down (cross(u,v))
    np.testing.assert_allclose(l.normal, (0, -1, 0), atol=1e-6)


def test_build_scene(cornell_path):
    desc = load_scene(cornell_path)
    ts = build_scene(desc)
    # 15 quads (3 white walls + left + right + 5 + 5 block faces) = 30 tris,
    # + 2 emitter tris for the light quad
    assert ts.num_tris == 32
    assert ts.num_lights == 1
    assert ts.num_quad_lights == 1
    assert not ts.has_env
    # light subspace base block starts at 0 without env
    assert int(ts.lights.ss_base[0]) == 0
    assert int(ts.lights.div_level[0]) == 8
    # emissive tris are tagged
    assert int((np.asarray(ts.tri_light) >= 0).sum()) == 2


def test_quad_geometry_normals(cornell_path):
    """Light quad triangles' geometric normals must equal the light normal
    (emission is one-sided; back-face culling relies on winding)."""
    desc = load_scene(cornell_path)
    ts = build_scene(desc)
    tl = np.asarray(ts.tri_light)
    e1 = np.asarray(ts.tri_e1)[tl >= 0]
    e2 = np.asarray(ts.tri_e2)[tl >= 0]
    gn = np.cross(e1, e2)
    gn /= np.linalg.norm(gn, axis=-1, keepdims=True)
    np.testing.assert_allclose(gn, [[0, -1, 0], [0, -1, 0]], atol=1e-6)


def test_native_resolution_textures(tmp_path):
    """Textures keep their NATIVE resolution in the padded stack and
    sample_albedo matches a full-res CPU bilinear-wrap oracle (VERDICT r4 #7;
    reference stb native-res textures, scene_shift.cpp:40)."""
    import cv2
    import jax.numpy as jnp
    from spcbpt_tpu.scene.scene import sample_albedo

    (tmp_path / "scn").mkdir()
    (tmp_path / "tex").mkdir()
    rng = np.random.default_rng(3)
    sizes = {"a.png": (6, 9), "b.png": (11, 4)}   # (h, w), deliberately odd
    disk = {}
    for name, (h, w) in sizes.items():
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "tex" / name), img)
        disk[name] = img[..., ::-1]  # BGR -> RGB as the loader sees it

    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
    scn = tmp_path / "scn" / "t.scene"
    scn.write_text(
        "material MatA\n{\ncolor 1 1 1\nalbedoTex tex/a.png\n}\n"
        "material MatB\n{\ncolor 1 1 1\nalbedoTex tex/b.png\n}\n"
        "light\n{\ntype Quad\nposition 0 2 0\nv1 1 2 0\nv2 0 2 1\n"
        "emission 1 1 1\n}\n"
        "cameraSetting\n{\neye 0 0 -3\nlookat 0 0 0\nup 0 1 0\nfov 45\n}\n"
        "mesh\n{\nfile quad.obj\nmaterial MatA\n}\n"
        "mesh\n{\nfile quad.obj\nmaterial MatB\n}\n")
    desc = load_scene(str(scn))
    ts = build_scene(desc)

    # native sizes preserved; stack padded to the max extent
    assert ts.textures.shape[1:3] == (11, 9)
    got = {(int(h), int(w)) for h, w in zip(ts.tex_h, ts.tex_w)}
    assert got == set(sizes.values())

    def oracle(img_rgb_u8, u, v):
        lin = (img_rgb_u8.astype(np.float64) / 255.0) ** 2.2
        h, w = lin.shape[:2]
        fu, fv = u * w - 0.5, v * h - 0.5
        x0, y0 = int(np.floor(fu)), int(np.floor(fv))
        du, dv = fu - x0, fv - y0
        f = lambda x, y: lin[y % h, x % w]
        return (f(x0, y0) * (1 - du) * (1 - dv) + f(x0 + 1, y0) * du * (1 - dv)
                + f(x0, y0 + 1) * (1 - du) * dv + f(x0 + 1, y0 + 1) * du * dv)

    uvs = np.array([[0.0, 0.0], [0.03, 0.97], [0.5, 0.5], [0.999, 0.001],
                    [0.25, 0.75], [0.8, 0.2]])
    for tid in range(2):
        h, w = int(ts.tex_h[tid]), int(ts.tex_w[tid])
        name = next(n for n, s in sizes.items() if s == (h, w))
        out = sample_albedo(ts, jnp.full((len(uvs),), tid, jnp.int32),
                            jnp.asarray(uvs, jnp.float32))
        want = np.stack([oracle(disk[name], u, v) for u, v in uvs])
        np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)
