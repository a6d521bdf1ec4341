"""The port's texture sampling (logipathtracer_tpu_torch/ops/texture.py),
texture prologue (render/megakernel.py::resolve_tex_prologue) and the
textured shading step (the plain version of kernel K2 with material
overrides) against the JAX package.

Scenes are synthetic (tests/test_textures.py:56-68 and
tests/test_shade_kernel.py:147-177), compiled once by the JAX package
and handed to both packages.  Sampling is required to be BIT-identical:
both packages take the same f32 operations in the same order (floor,
lerp, the IEEE /255 of the packed atlas).  The textured shading step is
held to ``shade.shade_agreement``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.ops import texture as jtex
from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene
from logipathtracer_tpu.render import megakernel as jmk
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.gltf import (CameraNode, Gltf, Material,
                                           MeshNode, Primitive, TextureData)
from logipathtracer_tpu.scene.procedural import _look_at, _quad
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops import texture as ttex
from logipathtracer_tpu_torch.ops.kernels import shade as tshade
from logipathtracer_tpu_torch.ops.kernels import tex_prologue as ttp
from logipathtracer_tpu_torch.render import megakernel as tmk
from logipathtracer_tpu_torch.scene.types import SceneSoA

REPEAT, CLAMP, MIRROR = ttex.WRAP_REPEAT, ttex.WRAP_CLAMP, ttex.WRAP_MIRROR
NEAREST = 9728


def _rgba(rng, h, w):
    return rng.integers(0, 256, (h, w, 4)).astype(np.uint8)


def _normal_map(rng, n=8):
    """Mid-grey-biased, z-heavy normal map (test_shade_kernel.py:152)."""
    return np.stack([rng.integers(96, 160, (n, n)),
                     rng.integers(96, 160, (n, n)),
                     rng.integers(200, 256, (n, n)),
                     np.full((n, n), 255)], axis=-1).astype(np.uint8)


def _quad_scene(textures, base=0, normal=-1, mr=-1, cam=(0.3, 0.2, 3)):
    """A textured quad facing the camera (test_textures.py:56-68)."""
    tris, nrm, uvs = _quad((0, 0, 0), 2.0, 2)
    mat = Material(name="tex", base_color_factor=np.ones(4, np.float32),
                   metallic_factor=0.4, roughness_factor=0.5,
                   base_color_texture=base, normal_texture=normal,
                   metallic_roughness_texture=mr)
    node = MeshNode(name="quad", world_matrix=np.eye(4, dtype=np.float32),
                    primitives=[Primitive(tris, nrm, uvs, 0)])
    camera = CameraNode(name="cam", world_matrix=_look_at(cam, (0, 0, 0)),
                        yfov=0.9)
    return Gltf(mesh_nodes=[node], cameras=[camera], materials=[mat],
                textures=textures, name="textured_quad")


def _textures(kind, rng):
    """Texture sets for each sampling path."""
    if kind == "repeat":
        return [TextureData(pixels=_rgba(rng, 8, 8))]
    if kind == "clamp":
        return [TextureData(pixels=_rgba(rng, 8, 8), wrap_s=CLAMP,
                            wrap_t=CLAMP)]
    if kind == "mirror":
        return [TextureData(pixels=_rgba(rng, 8, 8), wrap_s=MIRROR,
                            wrap_t=REPEAT)]
    if kind == "nearest":
        return [TextureData(pixels=_rgba(rng, 8, 8), mag_filter=NEAREST,
                            min_filter=NEAREST),
                TextureData(pixels=_rgba(rng, 5, 7), wrap_s=CLAMP)]
    # "mixed": non-power-of-two sizes, every wrap pair, one NEAREST
    return [TextureData(pixels=_rgba(rng, 8, 8)),
            TextureData(pixels=_rgba(rng, 5, 7), wrap_s=REPEAT,
                        wrap_t=CLAMP),
            TextureData(pixels=_rgba(rng, 4, 4), wrap_s=MIRROR,
                        wrap_t=MIRROR, mag_filter=NEAREST),
            TextureData(pixels=_normal_map(rng))]


# kind -> (compile config fields, whether the quad atlas is expected)
CASES = {
    "repeat-quad": ("repeat", {}, True),
    "repeat-4gather": ("repeat", dict(tex_quad=False), False),
    "clamp-quad": ("clamp", {}, True),
    "clamp-4gather": ("clamp", dict(tex_quad=False), False),
    "mirror": ("mirror", {}, False),
    "nearest": ("nearest", {}, True),
    "mixed": ("mixed", {}, False),
    "mips": ("mixed", dict(mip_levels=4), False),
}


def _compiled(case, seed=0):
    kind, fields, _ = CASES[case]
    rng = np.random.default_rng(seed)
    gltf = _quad_scene(_textures(kind, rng))
    jscene = compile_scene(gltf, JaxConfig(width=8, height=8, **fields))
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


def _uv_tid(n, n_tex, seed):
    r = np.random.default_rng(seed)
    uv = r.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    # Exact edges: ix = -1 / 0 / w-1, texel centres, whole periods.
    uv[:10] = [[0.0, 0.0], [1.0, 1.0], [-0.01, 0.5], [0.5, -0.01],
               [0.999, 0.5], [0.0625, 0.0625], [-1.0, 2.0], [2.0, -1.0],
               [0.5, 1.5], [-0.5, -0.5]]
    tid = r.integers(0, n_tex, n).astype(np.int32)
    return uv, tid


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_atlas_matches_jax(case):
    jscene, tscene = _compiled(case)
    assert (tscene.tex_quad is not None) == CASES[case][2]
    n_tex = int(jscene.tex_mip_base.shape[0])
    uv, tid = _uv_tid(1024, n_tex, 1)
    # With mips, sample_atlas takes a table entry: each texture's level 0.
    entry = np.asarray(jscene.tex_mip_base)[tid]
    ref = np.asarray(jtex.sample_atlas(
        jnp.asarray(jscene.tex_atlas), jnp.asarray(jscene.tex_table),
        jnp.asarray(entry), jnp.asarray(uv),
        nearest_aware=jscene.has_nearest,
        quad=None if jscene.tex_quad is None
        else jnp.asarray(jscene.tex_quad)))
    got = ttex.sample_atlas(
        tscene.tex_atlas, tscene.tex_table, torch.from_numpy(entry),
        torch.from_numpy(uv), nearest_aware=tscene.has_nearest,
        quad=tscene.tex_quad).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.std() > 0.05          # the taps read real texels


@pytest.mark.parametrize("nearest_aware", [False, True])
def test_sample_atlas_lod_matches_jax(nearest_aware):
    jscene, tscene = _compiled("mips")
    assert jscene.mip_levels > 1 and jscene.tex_atlas.ndim == 3
    n_tex = int(jscene.tex_mip_base.shape[0])
    uv, tid = _uv_tid(1024, n_tex, 2)
    lod = np.random.default_rng(3).uniform(-1.0, 5.0, 1024).astype(
        np.float32)
    lod[:4] = [0.0, 1.0, 2.5, 99.0]
    args = ("tex_atlas", "tex_table", "tex_mip_base", "tex_mip_count")
    ref = np.asarray(jtex.sample_atlas_lod(
        *(jnp.asarray(getattr(jscene, a)) for a in args), jnp.asarray(tid),
        jnp.asarray(uv), jnp.asarray(lod), nearest_aware=nearest_aware))
    got = ttex.sample_atlas_lod(
        *(getattr(tscene, a) for a in args), torch.from_numpy(tid),
        torch.from_numpy(uv), torch.from_numpy(lod),
        nearest_aware=nearest_aware).numpy()
    np.testing.assert_array_equal(got, ref)


def test_packed_atlas_unpacks_like_f32():
    """The packed RGBA8 atlas (int32 bit patterns, texels with the top
    bit set included) samples exactly as its f32 twin."""
    rng = np.random.default_rng(4)
    px = _rgba(rng, 8, 8)
    px[0, 0] = 255
    packed = torch.from_numpy(
        np.ascontiguousarray(px).view(np.uint32)[:, :, 0].view(np.int32))
    f32 = torch.from_numpy(px.astype(np.float32) / np.float32(255.0))
    table = torch.tensor([[0, 0, 8, 8, REPEAT, CLAMP, 0, 0]],
                         dtype=torch.int32)
    uv, _ = _uv_tid(512, 1, 5)
    tid = torch.zeros(512, dtype=torch.int32)
    a = ttex.sample_atlas(packed, table, tid, torch.from_numpy(uv))
    b = ttex.sample_atlas(f32, table, tid, torch.from_numpy(uv))
    assert torch.equal(a, b)


def _nm_scene():
    """The textured shading scene of tests/test_shade_kernel.py:147-177:
    checker base colour, a normal map and a metallic-roughness map."""
    rng = np.random.default_rng(0)
    checker = np.zeros((8, 8, 4), np.uint8)
    checker[..., 3] = 255
    checker[::2, ::2, 0] = 255
    checker[1::2, 1::2, 2] = 255
    mr_tex = np.zeros((4, 4, 4), np.uint8)
    mr_tex[..., 1] = 180
    mr_tex[..., 2] = 90
    mr_tex[..., 3] = 255
    return _quad_scene([TextureData(pixels=checker),
                        TextureData(pixels=_normal_map(rng)),
                        TextureData(pixels=mr_tex)], base=0, normal=1, mr=2)


def _hit_state(jscene, n=512):
    """Camera rays of a 64x64 frame and their closest hits (JAX BVH
    walk), with random alive flags and bounce counts
    (test_shade_kernel.py:21-33)."""
    ys, xs = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(64, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2)[:n])
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    cam = jscene.cameras[0]
    origin, direction, seed = jax_generate_ray(
        jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov), pix, (64, 64),
        seed)
    t, obj, tri = intersect_scene(jscene, origin, direction, eps=1e-4)
    r = np.random.default_rng(3)
    return dict(
        origin=np.array(origin), direction=np.array(direction),
        acc=np.zeros((n, 3), np.float32), mask=np.ones((n, 3), np.float32),
        alive=r.random(n) < 0.9, seed=np.array(seed).astype(np.uint32),
        bounce=r.integers(0, 8, n).astype(np.int32),
        t=np.array(t), obj=np.array(obj), tri=np.array(tri))


@pytest.fixture(scope="module")
def nm_state():
    jscene = compile_scene(_nm_scene(), JaxConfig(width=32, height=32))
    assert jscene.tex_slots[0] and jscene.tex_slots[2] and \
        jscene.tex_slots[4]
    return jscene, SceneSoA.from_numpy(jscene).to("cpu"), \
        _hit_state(jscene)


def test_tex_prologue_matches_jax(nm_state):
    jscene, tscene, st = nm_state
    f = torch.from_numpy
    safe_tri = np.maximum(st["tri"], 0)
    ts64 = np.asarray(jscene.tri_shade)[safe_tri]
    oshade, ff_j, has_j = jmk._resolve_tex_prologue(
        jscene, JaxConfig(width=32, height=32), jnp.asarray(st["origin"]),
        jnp.asarray(st["direction"]), jnp.asarray(st["t"]),
        jnp.asarray(np.maximum(st["obj"], 0)), jnp.asarray(ts64[:, 32:64]),
        jnp.asarray(ts64[:, 0:32]))
    mat, ff_t, has_t = tmk.resolve_tex_prologue(
        tscene, RenderConfig(width=32, height=32), f(st["origin"]),
        f(st["direction"]), f(st["t"]), f(st["obj"]), f(st["tri"]))
    hit = st["tri"] >= 0
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    assert has_t.numpy()[hit].all()
    np.testing.assert_allclose(mat.numpy()[hit],
                               np.asarray(oshade)[hit, 21:31], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ff_t.numpy()[hit], np.asarray(ff_j)[hit],
                               rtol=1e-5, atol=1e-6)
    # The metallic-roughness map scaled the roughness factor (0.5).
    assert (mat.numpy()[hit, 8] < 0.5).all()


@pytest.mark.parametrize("parity", [True, False])
def test_textured_shade_matches_jax_kernel(nm_state, parity):
    """Plain K2 in its tex mode against the JAX package's textured
    shade_step in interpret mode (prologue + Pallas kernel)."""
    jscene, tscene, st = nm_state
    n = st["t"].shape[0]
    cfg = JaxConfig(width=32, height=32, shade="shade_interpret",
                    shade_tile=256, parity_rng=parity)
    ref = jmk.shade_step(
        jscene, cfg, *(jnp.asarray(st[k]) for k in (
            "origin", "direction", "acc", "mask", "alive", "seed")),
        jnp.asarray(st["bounce"]), *(jnp.asarray(st[k]) for k in (
            "t", "obj", "tri")), prev_pdf=jnp.zeros((n,), jnp.float32))
    ref = [np.asarray(x) for x in ref[:6]]
    ref[5] = ref[5].astype(np.int64)
    f = torch.from_numpy
    before = tshade.plain_calls
    got = tmk.shade_step(
        tscene, RenderConfig(width=32, height=32, parity_rng=parity),
        *(f(st[k]) for k in ("origin", "direction", "acc", "mask",
                             "alive")),
        f(st["seed"].astype(np.int64)), f(st["bounce"]),
        *(f(st[k]) for k in ("t", "obj", "tri")))
    assert tshade.plain_calls == before + 1
    tshade.shade_agreement(ref, [x.numpy() for x in got[:6]])


def _bits(x):
    """Float tensors as their int32 bit patterns, for bit-for-bit
    comparison (NaN included)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.fixture(scope="module")
def nm_frame(nm_state):
    """nm_state's scene with the hits of a whole 64x64 frame (about half
    its rays hit the quad)."""
    jscene, tscene, _ = nm_state
    return tscene, _hit_state(jscene, n=64 * 64)


@pytest.mark.parametrize("mask", ["state", "all", "none", "alternate"])
def test_tex_prologue_alive_mask_keeps_live_lanes(nm_frame, mask):
    """The prologue with an ``alive`` mask (``resolve_tex_prologue``, as
    ``shade_step`` calls it) equals the plain version bit for bit on
    every live lane (alive and a hit), the mapped normal on the live
    lanes with a normal map: the lanes K2 reads."""
    tscene, st = nm_frame
    n = st["t"].shape[0]
    alive = {"state": st["alive"], "all": np.ones(n, bool),
             "none": np.zeros(n, bool),
             "alternate": np.arange(n) % 2 == 0}[mask]
    f = torch.from_numpy
    args = (tscene, RenderConfig(width=32, height=32), f(st["origin"]),
            f(st["direction"]), f(st["t"]), f(st["obj"]), f(st["tri"]))
    full = ttp.prologue_plain(*args)
    got = tmk.resolve_tex_prologue(*args, alive=f(alive))
    live = f(alive & (st["t"] < 3.4e38))
    assert int(live.sum()) > 800 or mask == "none"
    assert bool(live.any()) == (mask != "none") and bool((~live).any())
    for g, r in zip(got, full):
        assert g.shape == r.shape and g.dtype == r.dtype
    mat, ffm, has = got
    assert torch.equal(_bits(mat[live]), _bits(full[0][live]))
    assert torch.equal(has[live], full[2][live])
    want = has & live
    assert bool(want.any()) == (mask != "none")
    assert torch.equal(_bits(ffm[want]), _bits(full[1][want]))


def test_tex_prologue_cpu_takes_plain_version(nm_frame):
    """On CPU tensors the wrapper, and the megakernel's prologue that
    delegates to it, run the plain version and count it; no launch."""
    tscene, st = nm_frame
    f = torch.from_numpy
    args = (tscene, RenderConfig(width=32, height=32), f(st["origin"]),
            f(st["direction"]), f(st["t"]), f(st["obj"]), f(st["tri"]))
    n0, p0 = ttp.launches, ttp.plain_calls
    got = ttp.tex_prologue(*args, alive=f(st["alive"]))
    assert (ttp.launches, ttp.plain_calls) == (n0, p0 + 1)
    ref = ttp.prologue_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(_bits(g), _bits(r))
    via = tmk.resolve_tex_prologue(*args)
    assert (ttp.launches, ttp.plain_calls) == (n0, p0 + 3)
    for g, r in zip(via, ttp.prologue_plain(*args)):
        assert torch.equal(_bits(g), _bits(r))
    with pytest.raises(ValueError, match="unsupported device"):
        ttp.tex_prologue(tscene, args[1], *(x.to("meta") for x in args[2:]))


def test_tex_agreement_and_bytes(nm_frame):
    """The harness's comparison of the prologue kernel with its plain
    version takes the live lanes bit for bit and asks zeros elsewhere,
    and its byte count charges the lanes' inputs and outputs, four
    texels a tap and the tri_shade and obj_tex rows once."""
    from logipathtracer_tpu_torch.tools import harness
    tscene, st = nm_frame
    f = torch.from_numpy
    t, obj, tri = f(st["t"]), f(st["obj"]), f(st["tri"])
    alive = f(np.arange(t.shape[0]) % 3 != 0)
    args = (tscene, RenderConfig(width=32, height=32), f(st["origin"]),
            f(st["direction"]), t, obj, tri)
    ref = ttp.prologue_plain(*args)
    live = harness.tex_live(alive, t)
    assert torch.equal(live, alive & (t < 3.4e38))
    # What the kernel writes: the plain outputs on the live lanes.
    has = ref[2] & live
    got = (torch.where(live[:, None], ref[0], 0.0),
           torch.where(has[:, None], ref[1], 0.0), has)
    assert harness.tex_agreement(got, ref, live) == (True, 0.0)
    off = got[0].clone()
    off[live.nonzero()[0, 0], 3] += 1.0
    assert harness.tex_agreement((off, *got[1:]), ref, live) == (False, 1.0)
    dead = got[0].clone()
    dead[(~live).nonzero()[0, 0], 0] = 0.5
    assert not harness.tex_agreement((dead, *got[1:]), ref, live)[0]
    assert not harness.tex_agreement((got[0], got[1], ref[2]), ref, live)[0]

    b = harness.tex_bytes(tscene, t, obj, tri, alive)
    n_live, lanes = int(live.sum()), t.shape[0]
    tid = tscene.obj_tex[obj.clamp(min=0).long()][live]
    taps = int(((tid >= 0) & torch.tensor(tscene.tex_slots)).sum())
    assert b["live"] == n_live and b["taps"] == taps > n_live
    out = 40 + 13 * tscene.tex_slots[4]
    base = (37 * n_live + 5 * (lanes - n_live) + out * lanes
            + 256 * len(set(tri[live].tolist()))
            + 20 * len(set(obj[live].tolist())))
    # The quad atlas: one 16-B row a tap, in one sector.
    assert tscene.tex_atlas.dim() == 2 and tscene.tex_quad is not None
    assert b["bytes"] == base + 16 * taps
    assert b["bytes_sectors"] == base + 32 * taps
    # The four-gather route: four texels of 4 B a tap, a sector each.
    b = harness.tex_bytes(dataclasses.replace(tscene, tex_quad=None), t,
                          obj, tri, alive)
    assert b["bytes"] == base + 16 * taps
    assert b["bytes_sectors"] == base + 128 * taps
