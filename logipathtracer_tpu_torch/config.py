"""Render configuration.

The JAX package's ``RenderConfig``, field for field with the same
defaults (tests/test_torch_scene.py checks the parity), carried over so
that this package never imports JAX.  It unifies the reference's three
config layers (compile-time C++ consts in src/Main.cpp:13-34, the
RendererConfiguration struct in include/RendererCore.hpp:13-27, the GLSL
#defines in shaders/path_tracing.comp:16-22, shaders/heitz/BSDF.glsl:8
and shaders/tex_to_quad.frag:21-22).

Fields that only choose a TPU mechanism in the JAX package are accepted
and ignored here: ``pool_cm``, ``sort_variadic``, ``flush_bins``,
``compact_cap``, ``shade``, ``shade_tile``.  ``intersect`` routes a
resident-class scene between K1 / K7 (``compact_worklist``), K8
(``"sweep"``, with ``sweep_tile`` rays per tile), the jnp twin and the
BVH walk; the ``stream_*`` fields route a scene beyond the resident
budget between kernels K4, K5 and K6 as in the JAX package
(``stream_worklist``, ``stream_granularity``, ``stream_compact``, and
whether ``stream_cap`` is 0; render/megakernel.py ``pick_intersect``),
with ``stream_tile`` rays per tile and ``stream_chunk`` clusters per
chunk; the cap's block width itself is a TPU mechanism.  ``renderer``
chooses the wavefront (``"auto"``, ``"wavefront"``) or the megakernel.
Every field that changes results is honoured, ``use_microfacet=False``
(the basic BSDF) too.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image (reference: src/Main.cpp:30, RendererConfiguration.renderScale
    # applied at src/RendererPT.cpp:254-255,532-533).
    width: int = 1920
    height: int = 1080
    render_scale: int = 1

    # Path tracing (reference: shaders/path_tracing.comp:19-22).
    max_depth: int = 10
    rr_bounces: int = 2           # RUSSIAN_ROULETTE_BOUNCES
    rr_threshold: float = 0.5     # q < 0.5 gate (path_tracing.comp:318)
    use_microfacet: bool = True   # USE_MICROFACET: Heitz vs basic BSDFs
    heitz_max_order: int = 16     # shaders/heitz/BSDF.glsl:8

    # Environment: constant grey on miss
    # (path_tracing.comp:221, rtx/miss.rmiss:11).
    env_color: float = 0.2

    # Display transform (shaders/tex_to_quad.frag:21-22).
    exposure: float = 1.5
    gamma: float = 2.2

    # Intersection epsilon (shaders/common/constants.glsl:4).
    eps: float = 1e-4

    # Next-event estimation with MIS (beyond the reference, which has
    # no light sampling, path_tracing.comp:269).
    nee: bool = False
    nee_mis: bool = True

    # Mipmapped texture sampling (beyond the reference, which samples
    # LOD 0): mip_levels > 1 builds a box mip chain at scene compile;
    # mip_spread is the ray-cone spread per unit t.
    mip_levels: int = 1
    mip_spread: float = 0.001
    tex_quad: bool = True         # pack each texel's 2x2 bilinear
                                  # neighbourhood as one atlas row

    # BVH build (the reference delegates to lsg's SBVH).
    bvh_leaf_size: int = 4        # max triangles per mesh-BVH leaf
    bvh_bins: int = 16            # SAH bins
    bvh_spatial_splits: bool = True  # SBVH in the native builder
    cluster_size: int = 0         # triangles per cluster; 0 = auto
                                  # (256 resident class, 512 streamed)

    # Execution.
    renderer: str = "auto"        # auto (= wavefront) | wavefront |
                                  # megakernel
    pool_size: int = 1 << 20      # wavefront ray-pool lanes
    intersect: str = "auto"       # auto | compact | sweep | sweep_jnp |
                                  # bvh | stream
    sweep_tile: int = 1024
    compact_tile: int = 4096      # rays per worklist tile; also sizes
                                  # the block-major pixel layout
    compact_cap: int = 128
    compact_worklist: bool = True  # per-tile fired-cluster worklists
    stream_tile: int = 4096
    stream_chunk: int = 16
    stream_cap: int = 32
    flush_bins: bool = True
    stream_worklist: bool = True
    stream_granularity: str = "cluster"
    stream_compact: bool = True
    shade: str = "auto"
    shade_tile: int = 2048
    sort_rays: bool = True        # octant+Morton sort of the pool before
                                  # each intersect
    sort_variadic: bool = True
    pool_cm: bool = False
    pool_carryover: bool = True   # keep in-flight paths across step()
                                  # calls; reads drain the pool first
    sort_every: int = 1           # sort/flush every k-th iteration
    lazy_regen: int = 0           # 0 = refill free lanes every
                                  # iteration; k > 0 = only when
                                  # free * k >= pool
    parity_rng: bool = True       # True: the reference's LCG hash
                                  # (shaders/common/random.glsl:9-15);
                                  # False: Threefry-2x32

    @property
    def render_width(self) -> int:
        return self.width * self.render_scale

    @property
    def render_height(self) -> int:
        return self.height * self.render_scale

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
