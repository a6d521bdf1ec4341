"""Chip smoke test of the PyTorch + CUDA port (logipathtracer_tpu_torch).

    python3 chip_smoke.py [--scene SCENE.gltf]

Needs one CUDA card; fails (exit 1, no result line) without one.  From
the root of a checkout it:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from logipathtracer_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (K1's worklist kernel and K1 on the
     2^20-ray primary pool and on a bounce pool of the render — the
     worklists equal, K1 bit-equal, each timed apart, the worklist
     kernel beside its plain version on the card; K2 on that 2^20-lane
     pool; K3 on a 2^18-row sorted retired tail into a 1024^2
     accumulator, with ``index_add_``, each by event time and by device
     time), with median times of both;
  4. drives the flagship main path — ProgressiveRenderer at 1024x1024,
     max_depth 10, Heitz, parity RNG, 2^20-lane wavefront pool — and
     checks that it ran through all four kernels (K1's worklist kernel,
     K1, K2, K3) and never through a plain version;
  5. renders 64x64 at 2+2 spp on the card and on the CPU with the same
     seed and requires >= 99.5% of pixels to agree (rtol 1e-4,
     atol 1e-6);
  6. the textured + next-event-estimation path: the same box with the
     checker texture (``textured=True``) and RenderConfig(nee=True) —
     (a) after one step(1) at 1024x1024, the worklist kernel with t_max
     and K1 in its t_max / any-hit mode against their plain versions on
     the 2^20-lane shadow pool (the same worklists; the same t, so the
     same visibility, on every lane); (b) K2 with textures and NEE against its
     plain version on that pool, with parity and with Threefry draws,
     and K2 on a scene small enough for the TPU kernel's tri_sel form;
     (c) the NEE main path at 1024x1024, timed as in 4, which must run
     the worklist kernel and K1 at least twice per iteration, K2 and K3,
     the texture prologue's kernel once for each textured shade step,
     and no plain version;
     (d) the 64x64 card-vs-CPU render of 5 on this path;
     (e) the texture prologue's kernel against its plain version on the
     card, bit for bit on every live lane and zeros on the others
     (``harness.tex_agreement``), on (a)'s pool and at the PBR benchmark
     cell's shapes: its full-size scene from the benchmark's generator
     (``portbench/scenes/box_pbr.py`` with the arguments of
     ``portbench/configs/box_nee_tex_1080p.json``: 34 maps of 1024^2 in
     a 142.6 MB packed atlas, four slots) on the 2^20-lane bounce pool of
     a 1024^2 NEE session, timed by events and by device time;
  7. the outside-class path, scenes beyond the resident budget that
     stream cluster blocks: ``make_outside_scene()`` (394,242 triangles,
     51 objects, 1,233 clusters of 512) with the default RenderConfig,
     which routes it to K4 — (a) K4, K5 and K6 (cap 0 and cap > 0
     bodies) against their plain versions on the whole 2^20-ray primary
     pool; K4, K5 and K6 cap > 0 on a bounce pool, and K4 and K6 cap > 0
     in their t_max / any-hit mode on the shadow pool of one NEE step,
     K6 cap 0 on a bounce pool and in its t_max mode on the shadow pool,
     on as many tiles of those pools as the plain version covers in
     about 15 s (BOUNCE_TILES, SHADOW_TILES, K6_BOUNCE_TILES,
     K6_SHADOW_TILES), and timed on the whole pool too.  Each must equal
     its plain version bit for bit (t, tri and obj; t alone in any-hit).
     The count pass of each check prints what the visit rests on: the
     mean list a tile visits, the share of listed clusters that some ray
     of a block passes (256 rays for the compacted visit, a 128-ray
     sub-tile for K6 cap 0), and the cluster blocks staged per launch by
     a ring that stages every listed cluster and by the kernel (what its
     blocks pass, or may pass ahead with the prefetch); (b) the main
     path at 1024x1024,
     timed as in 4, which must run K4, K2 and K3, never K1 and no plain
     version; (c) each other route timed as in 4, each launching its
     kernel (``stream_granularity="chunk"``: K5;
     ``stream_worklist=False``: K6 cap > 0, also with NEE for its
     any-hit mode; ``stream_compact=False``: K6 cap 0, also with NEE
     for its t_max mode; ``nee=True``: K4 any-hit); (d) the 64x64
     card-vs-CPU render of 5 on this path;
  8. the lockstep megakernel renderer (``renderer="megakernel"``) on the
     flagship box — (a) K7 (``compact_worklist=False``) and K8
     (``intersect="sweep"``) against their plain versions on the
     megakernel's 2^20-ray primary pool (camera rays in each route's
     block-major order, sorted by coherence key) and on its bounce pool
     after one bounce; K7 in its t_max / any-hit mode and K8 in its t_max
     mode on that bounce's NEE shadow pool, each bit for bit, their count
     passes printed as phase 7's
     (and K7's plain version once more before and after its check,
     without the count pass, to show what that pass costs); (b) the
     megakernel main path
     at 1024x1024 through the worklist kernel, K1 and K2, timed as in 4;
     (c) one 1024x1024
     step(1) on each other route (K7, K7 any-hit with NEE, K8, K8 t_max
     with NEE), each launching its kernel; (d) the BVH walk at 512x512,
     one step(1); (e) beside phase 4, in the same call: the flagship
     wavefront with ``compact_worklist=False`` (K7, no per-ray prepass),
     timed the same way; (f) the 64x64 card-vs-CPU render of 5 on the
     megakernel through K1, K8 and K7;
  9. the basic BSDF (``use_microfacet=False``, shaded by the plain-torch
     basic route: the JAX package has no kernel for it) and the command
     line — (a) the basic main path at 1024x1024, timed as in 4, which
     must run the worklist kernel, K1, K3 and the basic route, never K2
     and no plain version (phase 3 holds those kernels to their plain
     versions at the same shapes), with the route's ms per iteration
     from one more step(2) with every stage between device syncs
     (``tools/stages.py`` ``stage_timers``); (b) one
     1024x1024 step(1) with NEE, which must run K1 in its any-hit mode;
     (c) one 1024x1024 step(1) of the megakernel; (d) the 64x64
     card-vs-CPU render of 5, NEE off and on;
     (e) ``python -m logipathtracer_tpu_torch.cli.main`` as subprocesses,
     each with a time limit, on the box written by ``tools/glb.py``:
     ``render`` at 1024x1024, 4 spp, with and without ``--basic`` (the
     JSON report, a 1024x1024 PNG, finite radiance of the report's spp,
     the EXR of that radiance), ``compare`` on the two, and ``web`` at
     256x256 for 3 frames with /stats and /frame.raw fetched while it
     serves;
 10. ``render_wavefront`` and the device mesh (``parallel/mesh.py``) —
     (a) one 1024x1024 frame of 1 spp through ``render_wavefront`` on
     the flagship box, and its two 512-row slabs: the slabs concatenated
     must equal the frame bit for bit, their rays sum to the frame's,
     and the frame's call launches the worklist kernel, K1, K2 and K3
     and no plain version; (b) the same on the textured box with NEE,
     which must launch K1 any-hit, and one frame of
     ``make_outside_scene()``, which must launch K4; (c) the single-shot
     session, ``ProgressiveRenderer(pool_carryover=False)``, timed as
     in 4, beside phase 4's carried-over pool; (d) a 1x1 mesh
     (``make_mesh(["cuda:0"])``) and a (1, 2) mesh on ``["cuda:0"] * 2``
     stepped three rounds must equal that session's three step(1) bit
     for bit, rays too, and a 1x1 megakernel mesh the megakernel
     session's; (e) a 64x64 (1, 2) wavefront mesh on the card against
     the same mesh on the CPU (the pixel rule of 5), and a mesh of the
     card and the CPU, a worker thread each, whose tiles equal theirs
     bit for bit;
 11. the system's default configuration, RenderConfig() at 1920x1080:
     1080 rows are no multiple of 128, so pixels are row-major, not in
     32x128 blocks — (a) the flagship session, timed as in 4, which must
     launch the worklist kernel, K1, K2 and K3 and no plain version, its
     iterations per step(2) and the mean worklist a 4096-ray tile gets
     beside 1024^2's, and K1 with its worklist kernel against their
     plain versions on its primary pool; (b) one megakernel step(1)
     (2,073,600 rays: 506 tiles and a padded 507th) through the worklist
     kernel, K1 and K2, and K1 against its plain version on that pool;
     (c) a step(2) with NEE on the textured box (K1 any-hit, K2
     tex+nee); (d) a step(1) of ``make_outside_scene()`` (K4); (e)
     ``render_scale=2``: a step(1) at 3840x2160 and ``image()`` of
     1920x1080 with the peak memory, and K3 against its plain version
     into an accumulator of 8,294,400 pixels; (f) the interactive loop
     of ``tools/interactive.py`` at its defaults (12 navigation frames
     on the 480x270 depth-4 preview, a 129,600-lane pool, then 12
     converge frames at 1920x1080), which must launch the four kernels
     and no plain version and write a converged PNG that is not black,
     and K1, its worklist kernel, K2 and K3 against their plain versions
     on the preview's pools (a padded tail tile; a partial last CUDA
     block); (g) the CLI as subprocesses with no size flags: ``render
     --spp 2`` (report, PNG and radiance at 1920x1080) and ``web
     --frames 3`` with /stats and /frame.raw fetched (frame and display
     1920x1080, the preview renderer resident beside it); (h) the card
     against the CPU by the pixel rule of 5 at shapes with the same
     traits (``DEFAULT_TRAITS``: row-major, a padded tail tile, a pool
     smaller than the frame, ``render_scale=2`` through ``image()``),
     each stepping step(2), rotate, step(1), step(1), every kernel call
     of the card's render shadowed by its plain version on the CPU
     (``cpu_shadowed``): the rays equal but for the paths of K2 lanes
     that the device's libm steers otherwise than the host's; the card
     runs the wavefront's eager form there, since the shadows wrap the
     kernels' Python wrappers, which a replayed graph does not call;
 12. the wavefront loop through its captured CUDA graphs
     (render/graph.py: each iteration a stage-A replay, one host read, a
     stage-B replay) against its eager form (``_eager``), in one call —
     (a) sessions of the flagship at 1024x1024, NEE + textured, the
     outside class (K4) and 1920x1080, each step(1), step(2), step(2)
     and the drain: the frame sums ``torch.equal``, equal rays and
     iterations, equal launch counters (a replay adds its capture's) and
     no plain version, two stage replays (or a first use's warm-up and
     capture) per iteration; then, after a camera reset, each form timed
     as in 4 (samples/s, Mrays/s, ms per iteration) with its device
     busy share (``tools/stages.py`` ``busy_share``), and the captures'
     count, seconds and reserved MiB; (b) the 480x270 depth-4 preview,
     a camera turn before each of 12 frames, every frame bit-equal; (c)
     a 1024^2 ``render_wavefront`` frame, then another camera and field
     of view replayed without a capture, bit-equal to the eager form;
     (d) a 1x1 mesh at 512^2 bit-equal to its eager form; (e)
     ``tools/interactive.py`` at its defaults both ways (navigation and
     converge fps).

The scene is the glTF given with --scene, else the procedural box
``make_box_scene(spheres=10, subdiv=3)`` (12,812 triangles, 86 clusters,
the resident class of the reference's cornell box), built from a fixed
seed; the host seeds are fixed too.  Phase 6 always renders the
procedural box and phase 7 the procedural outside scene.

Prints one JSON line of kernel results (each row names the run its
launches were counted in and the pool size its times and error were
measured on), then the card line, then as its last line
{"ok": true, "device": {...}}.  Any failed check raises.

Each kernel row carries its bound: the least time an H100 SXM could take
for the row's work on the row's pool, the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s
and its operations over 67 TFLOP/s (fp32 without tensor cores; NVIDIA's
data sheet).  The intersect kernels' operations come from a count pass
over the plain version's run on the same pool
(``harness.isect_counted``): SLAB_OPS per slab test it made and MT_OPS
per ray-triangle test the kernel's contract implies — S per own slab
pass for the compacted visit, less, with any_hit, the tests after the
first accepted triangle (``any_hit_saved``); for K4, whose warps test
a queued ray against the boxes of a cluster's 32-slot groups first,
SLAB_OPS per group box test and MT_OPS per slot of the groups it
tests; S per ray of every gated 128-ray sub-tile for K6's cap = 0 body
and K8.  The worklist kernel makes
WORLD_SLAB_OPS per (ray, box) slab test, every ray against every box as
its plain version does.  K3 moves 4 bytes of pixel id per row, 12 of
radiance per retired row and a read and a write of each pixel it
flushes.  K2's operations come from its count pass over the compared
plain call (``shade_counted``): every lane's prologue, walk orders by
lobe, light sample, roulette and draws at harness.K2_OPS.  The texture
prologue's bytes are ``harness.tex_bytes``: the lanes' inputs and
outputs and four texels a tap, the tri_shade and obj_tex rows once (they
stay in L2); its row adds ``device_ms`` and ``bound_ms_sectors``, the
bound with a 32-B sector a texel.
``library_ms`` is the time of one PyTorch call that computes
the same function (``index_add_`` for K3), null where no such call
exists.  K3's row adds ``device_ms`` and ``library_device_ms``: the
device time of one call, from the kernel rows of ``torch.profiler``
over DEVICE_RUNS calls, without the host time that an event pair
around one call holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from logipathtracer_tpu_torch.tools.harness import (  # noqa: E402
    bounce_pool, device_ms, event_ms, group_line, isect_counted, make_tail,
    megakernel_pools, primary_pool, runner, scene_tables, shade_args,
    shade_counted, shade_ops, shade_work, shadow_pool, sub_pool,
    tex_agreement, tex_bytes, tex_live, tex_pool, timed_steps,
    walk_efficiency)

# Tolerances.  The intersect kernels K1 and K4-K8 must equal their plain
# versions bit for bit (t, tri and obj; t alone in any-hit); K2 uses the
# rule kept beside its kernel (shade.shade_agreement: at most 0.5% of
# lanes with another seed or alive flag, floats close on the rest).
K3_RTOL, K3_ATOL = 1e-6, 1e-6           # f32 reassociation

# Bounds (module docstring).  Operation counts, a divide or a compare
# counted as one: a slab test is 64, the local ray (33), three
# reciprocals (3) and the slab table (28: 12 for the six plane
# distances, 10 for t0 and t1, 6 compares); a ray-triangle test is
# Möller–Trumbore with its acceptance (52).  The kernels build with
# -fmad=false, so every operation is one instruction: the card issues
# about half of PEAK_FLOPS, which counts an FMA as two.  K2's operations
# come from its count pass over the compared plain call
# (``shade_counted``): per lane its prologue, each walk order by lobe,
# the NEE block, Russian roulette and every draw, at the counts of
# harness.K2_OPS (counted from csrc/shade.cu); K3 one add per retired
# channel.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SLAB_OPS, MT_OPS = 64, 52
# The part of a triangle test up to its u decision (csrc/closest_hit.cuh
# mt_u and the u test): the P vector (9), det and its reciprocal (6), the
# T vector (3), u (6) and its two compares.
MT_U_OPS = 26
WORLD_SLAB_OPS = 28                     # the slab table alone
DEVICE_RUNS = 50
IMG_RTOL, IMG_ATOL, IMG_FRAC = 1e-4, 1e-6, 0.995  # test_wavefront.py:36-37


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def load_scene(path, **box):
    from logipathtracer_tpu_torch import compile_scene, load_gltf
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    box = {"spheres": 10, "subdiv": 3, **box}
    g = load_gltf(path) if path else make_box_scene(**box)
    return compile_scene(g)


_OUTSIDE = []


def outside_scene():
    """``make_outside_scene()`` compiled once, for phases 7, 10 and 11."""
    if not _OUTSIDE:
        from logipathtracer_tpu_torch import compile_scene
        from logipathtracer_tpu_torch.scene.procedural import \
            make_outside_scene
        _OUTSIDE.append(compile_scene(make_outside_scene()))
    return _OUTSIDE[0]


def _time_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(ops: float, n_bytes: float):
    """(bound ms, "bytes" or "operations"): the larger of the two
    times."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def plain_work(plain, **staging):
    """(result, ms, work) of one plain intersect call, timed, with its
    count pass (``staging``: ``isect_counted``'s block, prefetch and
    groups)."""
    with isect_counted(**staging) as work:
        out, ms = _time_once(plain)
    return out, ms, work


def any_hit_saved(rays8, tri, obj, tables, eps):
    """Triangle tests that any-hit lanes skip: the function needs only
    the tests up to the first accepted slot j of the cluster that blocks
    a lane (the kernels' closest_hit.cuh warp_closest stops within 32
    slots of it), so that visit needs j + 1 tests, not S.  Summed over
    the lanes the plain result blocks (tri >= 0).  The blocking cluster
    is the one of the lane's object with the largest triangle base <=
    tri; the best t at that visit is still the initial one, min(t_max,
    BIG)."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    cl_meta, cl_inv, cl_aabb, cl_tris = tables
    s = cl_tris.shape[2]
    lanes = (tri >= 0).nonzero().squeeze(1)
    if lanes.numel() == 0:
        return 0
    meta = cl_meta.long()
    cl = torch.cat([
        torch.where((meta[None, :, 0] == obj[part, None].long())
                    & (meta[None, :, 1] <= tri[part, None].long()),
                    meta[None, :, 1], -1).argmax(dim=1)
        for part in lanes.split(1 << 15)])
    best0 = ci.best_init(rays8, True)
    sweep = ci.PlainSweep(rays8[:, lanes], cl_meta, cl_inv, cl_aabb, cl_tris,
                          eps, best0[lanes])
    saved = 0
    for c in cl.unique().cpu().tolist():
        at = (cl == c).nonzero().squeeze(1)
        lo, ld, _ = sweep.lanes(at, c)
        t = ci._mt(lo, ld, cl_tris[c])
        ok = (t > eps) & (t < sweep.best_t[at, None])
        assert bool(ok.any(dim=1).all()), "a blocked lane without a hit"
        saved += int((s - 1 - ok.int().argmax(dim=1)).sum())
    return saved


def isect_bound(work, scene, inputs, r: int, saved: int = 0):
    """Bound of an intersect kernel on an R-ray pool: the count pass's
    operations — its slab tests and S triangle tests for every lane that
    runs them ("tested": the own passes of the compacted visit, every
    lane of a gated sub-tile), ``saved`` triangle tests fewer; with K4's
    32-slot groups its group box tests at SLAB_OPS and the slots of the
    groups it tests in place of the S tests; with the sub-tile visit's
    early exit MT_U_OPS for each and the rest only for the "rest" — or
    its inputs read once and (t, tri, obj) written once."""
    s = scene.cl_tris.shape[2]
    tests = work["tested"] * s - saved
    ops = work["slab"] * SLAB_OPS + tests * MT_OPS
    if work.get("group_slots") is not None:     # K4's 32-slot groups
        ops = ((work["slab"] + work["group_tests"]) * SLAB_OPS
               + work["group_slots"] * MT_OPS)
    if work.get("rest") is not None:    # the sub-tile visit's early exit
        ops = (work["slab"] * SLAB_OPS + tests * MT_U_OPS
               + work["rest"] * (MT_OPS - MT_U_OPS))
    return bound(ops, nbytes(*inputs) + 12 * r)


# Every kernel's counts: name -> (module, launches, plain calls, launches
# by mode).  K5 sits beside K1 in compact_intersect with its own counts,
# K7 too, and K8 beside K6 in cluster_intersect.
COUNTERS = {
    "compact_intersect": ("compact_intersect", "launches", "plain_calls",
                          "mode_launches"),
    "worklist_prepass": ("compact_intersect", "prepass_launches",
                         "prepass_plain_calls", None),
    "shade": ("shade", "launches", "plain_calls", "mode_launches"),
    "flush": ("flush", "launches", "plain_calls", None),
    "stream_cluster": ("stream_cluster", "launches", "plain_calls",
                       "mode_launches"),
    "worklist_chunk": ("compact_intersect", "worklist_launches",
                       "worklist_plain_calls", "worklist_mode_launches"),
    "octant_chunk": ("cluster_intersect", "launches", "plain_calls",
                     "mode_launches"),
    "compact_order": ("compact_intersect", "order_launches",
                      "order_plain_calls", "order_mode_launches"),
    "dense_sweep": ("cluster_intersect", "sweep_launches",
                    "sweep_plain_calls", "sweep_mode_launches"),
    "tex_prologue": ("tex_prologue", "launches", "plain_calls", None),
}
FLAGSHIP = ("compact_intersect", "worklist_prepass", "shade", "flush")


def _module(name):
    import importlib
    return importlib.import_module(
        f"logipathtracer_tpu_torch.ops.kernels.{COUNTERS[name][0]}")


def reset_counts():
    for name, (_, launched, plain, modes) in COUNTERS.items():
        m = _module(name)
        setattr(m, launched, 0)
        setattr(m, plain, 0)
        if modes:
            getattr(m, modes).clear()


def read_counts(names=tuple(COUNTERS)):
    out = {}
    for name in names:
        _, launched, plain, _ = COUNTERS[name]
        m = _module(name)
        out[name] = (getattr(m, launched), getattr(m, plain))
    return out


def modes_of(name):
    m = _module(name)
    return dict(getattr(m, COUNTERS[name][3]))


def assert_no_plain():
    plain = {k: p for k, (_, p) in read_counts().items() if p}
    assert not plain, f"main path ran plain versions: {plain}"


def check_worklist(wmin, wmax, rays8, tile, has_tmax=False, runs=10):
    """The worklist kernel against its plain version (on the card) on
    one pool: wn equal, and wl on every tile's first wn entries.
    Returns (wl, wn, max |wl - plain wl| over the listed entries,
    kernel ms, plain ms, bound); the bound is WORLD_SLAB_OPS per (ray,
    box) test or the bytes moved."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    kw = dict(has_tmax=has_tmax)
    wl, wn = ci.build_chunk_worklists(wmin, wmax, rays8, tile, **kw)
    wlp, wnp = ci.build_chunk_worklists_plain(wmin, wmax, rays8, tile, **kw)
    assert torch.equal(wn, wnp), "worklist kernel: wn differs"
    live = (torch.arange(wl.shape[1], device=wl.device)[None]
            < wn[:, None])
    bad = int((wl != wlp)[live].sum())
    assert bad == 0, f"worklist kernel: wl differs on {bad} listed entries"
    err = float((wl - wlp)[live].abs().max()) if bool(live.any()) else 0.0
    k_ms = event_ms(
        lambda: ci.build_chunk_worklists(wmin, wmax, rays8, tile, **kw), runs)
    p_ms = event_ms(lambda: ci.build_chunk_worklists_plain(
        wmin, wmax, rays8, tile, **kw), 3)
    b = bound(WORLD_SLAB_OPS * rays8.shape[1] * wmin.shape[0],
              nbytes(wmin, wmax, rays8, wl, wn))
    return wl, wn, err, k_ms, p_ms, b


def check_k1(scene, origin, direction, tile, eps, runs=(10, 3)):
    """The worklist kernel and K1 against their plain versions on one
    pool, K1 bit for bit (t, tri, obj); returns (max_abs_err, kernel_ms,
    plain_ms, hit fraction, bound, worklist row (ms, plain ms,
    bound)).  ``runs``: the kernel's timed calls and the plain
    version's; with 0 of the latter, plain_ms is the compared call's
    time, its count pass included."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
    rays8, _ = ci.pack_rays8(origin, direction, tile)
    wmin, wmax = scene_cluster_bounds(scene)
    wl, wn, *wrow = check_worklist(wmin, wmax, rays8, tile)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb,
            scene.cl_tris, tile, eps)
    got = ci.compact_wl_intersect(*args)
    ref, p_ms, work = plain_work(
        lambda: ci.compact_wl_intersect_plain(*args))
    for name, g, p in zip(("t", "tri", "obj"), got, ref):
        assert torch.equal(g, p), f"K1: {name} differs from the plain version"
    err = float((got[0] - ref[0]).abs().max())
    hit_frac = float((ref[0] < ci.BIG).float().mean())
    k_ms = event_ms(lambda: ci.compact_wl_intersect(*args), runs[0])
    if runs[1]:
        p_ms = event_ms(lambda: ci.compact_wl_intersect_plain(*args),
                        runs[1])
    b = isect_bound(work, scene, args[:7], rays8.shape[1])
    return err, k_ms, p_ms, hit_frac, b, wrow


def print_k1(what, k1, card):
    """The lines of one check_k1 result."""
    _, wk_ms, wp_ms, wb = k1[5]
    print(f"worklist kernel, {what}: the plain worklists, kernel "
          f"{wk_ms:.3f} ms, plain on the card {wp_ms:.3f} ms, bound "
          f"{wb[0]:.4f} ms ({wb[1]})", flush=True)
    print(f"K1 {what}: bit-equal to the plain version, kernel "
          f"{k1[1]:.3f} ms, plain {k1[2]:.1f} ms, bound {k1[4][0]:.4f} ms "
          f"({k1[4][1]}); worklist + K1 {wk_ms + k1[1]:.3f} ms [{card}]",
          flush=True)


def check_k2(scene, cfg, pool, t, tri, parity, runs=(10, 3), opt=None):
    """K2 against its plain version on one pool; ``opt`` adds the
    texture / NEE inputs.  The compared plain call is K2's count pass;
    runs[1] == 1 times the plain version once more, else the median of
    runs[1] calls.  Returns (diverged, max err, kernel ms, plain ms,
    bound, walk warp efficiency (efficiency, with the lobes apart),
    modelled from the count pass for one thread a lane in pool order)."""
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    args, kw = shade_args(scene, cfg, pool, t, tri, parity, opt)
    got = sk.shade(*args, **kw)
    with shade_counted() as calls:
        ref = sk.shade_plain(*args, **kw)
    work = shade_work(calls[0])
    diverged, err = sk.shade_agreement([x.cpu() for x in ref],
                                       [x.cpu() for x in got])
    k_ms = event_ms(lambda: sk.shade(*args, **kw), runs[0])
    p_ms = (_time_once(lambda: sk.shade_plain(*args, **kw))[1]
            if runs[1] <= 1 else
            event_ms(lambda: sk.shade_plain(*args, **kw), runs[1]))
    b = bound(shade_ops(work), nbytes(*args, *(opt or {}).values(), *got))
    orders, lobe = work["orders"].cpu(), work["lobe"].cpu()
    return diverged, err, k_ms, p_ms, b, walk_efficiency(orders, lobe)


def k2_line(what, k2, card=None):
    """The line of one check_k2 result."""
    print(f"K2 {what}: diverged {k2[0]:.5f}, max|d| {k2[1]:.3g}, kernel "
          f"{k2[2]:.3f} ms, plain {k2[3]:.1f} ms, bound {k2[4][0]:.4f} ms "
          f"({k2[4][1]}); walk warp efficiency {k2[5][0]:.3f} "
          f"({k2[5][1]:.3f} lobes apart), modelled from the count pass"
          + (f" [{card}]" if card else ""), flush=True)


def check_k1_shadow(scene, origin, direction, t_lim, tile, eps, runs=10):
    """The worklist kernel with t_max and K1 in its t_max / any-hit mode
    against their plain versions on a shadow pool: the same worklists,
    and the same t (so the same visibility predicate t < t_max) on every
    lane.  The plain K1 runs once, timed.  Returns (max |dt|, kernel ms,
    plain ms, blocked fraction of the lanes with a light sample, lanes
    with a light sample, bound, worklist row (ms, plain ms, bound))."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels.shade import PARK
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
    rays8, r = ci.pack_rays8(origin, direction, tile, t_max=t_lim)
    wmin, wmax = scene_cluster_bounds(scene)
    wl, wn, *wrow = check_worklist(wmin, wmax, rays8, tile, has_tmax=True)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb,
            scene.cl_tris, tile, eps)
    kw = dict(has_tmax=True, any_hit=True)
    got = ci.compact_wl_intersect(*args, **kw)
    ref, p_ms, work = plain_work(
        lambda: ci.compact_wl_intersect_plain(*args, **kw))
    saved = any_hit_saved(rays8, ref[1], ref[2], scene_tables(scene), eps)
    blocked_k = got[0][:r] < t_lim
    blocked_p = ref[0][:r] < t_lim
    bad = int((blocked_k != blocked_p).sum())
    assert bad == 0, f"K1 any-hit: visibility differs on {bad} lanes"
    assert torch.equal(got[0], ref[0]), "K1 any-hit: t differs"
    err = float((got[0] - ref[0]).abs().max())
    shadow = origin[:, 0] != PARK
    n_shadow = int(shadow.sum())
    frac = float(blocked_k[shadow].float().mean()) if n_shadow else 0.0
    k_ms = event_ms(lambda: ci.compact_wl_intersect(*args, **kw), runs)
    b = isect_bound(work, scene, args[:7], rays8.shape[1], saved)
    return err, k_ms, p_ms, frac, n_shadow, b, wrow


def check_k3(dev, npix=1 << 20, rows=1 << 20, retired=1 << 18, runs=(10, 3),
             device=True):
    """K3 against its plain version; returns (max err, kernel ms, plain
    ms, bound, ms of ``index_add_`` of the retired rows into the same
    accumulator, ``device_ms`` of K3, the same of ``index_add_``; the
    last two None without ``device``: late in a long process the
    profiler has recorded no device time for them)."""
    from logipathtracer_tpu_torch.ops.kernels import flush
    pix, acc = make_tail(npix, rows, retired, dev)
    base = torch.rand((npix, 3), generator=torch.Generator().manual_seed(1))
    base = base.to(dev)
    k1 = flush.flush_sorted(base.clone(), pix, acc)
    k2 = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), "K3: repeat run not bit-identical"
    assert torch.equal(k1, p), "K3: differs from its plain version"
    k1, p = k1.cpu().numpy(), p.cpu().numpy()
    np.testing.assert_allclose(k1, p, rtol=K3_RTOL, atol=K3_ATOL)
    err = float(np.abs(k1 - p).max())
    work = base.clone()
    k_ms = event_ms(lambda: flush.flush_sorted(work, pix, acc), runs[0])
    p_ms = event_ms(lambda: flush.flush_sorted_plain(work, pix, acc),
                      runs[1])
    tail = slice(rows - retired, rows)
    pix_r, acc_r = pix[tail].contiguous(), acc[tail].contiguous()
    lib_ms = event_ms(lambda: work.index_add_(0, pix_r, acc_r), runs[0])
    k_dev = lib_dev = None
    if device:
        k_dev = device_ms(lambda: flush.flush_sorted(work, pix, acc),
                          DEVICE_RUNS)
        lib_dev = device_ms(lambda: work.index_add_(0, pix_r, acc_r),
                            DEVICE_RUNS)
    flushed = int(torch.unique(pix_r).numel())
    b = bound(3 * retired, 4 * rows + 12 * retired + 24 * flushed)
    return err, k_ms, p_ms, b, lib_ms, k_dev, lib_dev


def check_tex(scene, cfg, pool, t, obj, tri, runs=(10, 3)):
    """The texture prologue's kernel against its plain version on one
    pool, with the pool's alive mask: bit for bit on the live lanes,
    zeros elsewhere.  Returns (max err, kernel ms, plain ms, bound,
    device ms, live lanes, taps, bound with a 32-B sector a texel)."""
    from logipathtracer_tpu_torch.ops.kernels import tex_prologue as tp
    args = (scene, cfg, pool["origin"], pool["direction"], t, obj, tri)

    def kernel():
        return tp.tex_prologue(*args, alive=pool["alive"])

    equal, err = tex_agreement(kernel(), tp.prologue_plain(*args),
                               tex_live(pool["alive"], t))
    assert equal, "texture prologue: differs from its plain version"
    k_ms = event_ms(kernel, runs[0])
    p_ms = event_ms(lambda: tp.prologue_plain(*args), runs[1])
    k_dev = device_ms(kernel, DEVICE_RUNS)[0]
    b = tex_bytes(scene, t, obj, tri, pool["alive"])
    return (err, k_ms, p_ms, (b["bytes"] / PEAK_BYTES * 1e3, "bytes"),
            k_dev, b["live"], b["taps"],
            b["bytes_sectors"] / PEAK_BYTES * 1e3)


def tex_line(what, r, card=None):
    """The line of one check_tex result."""
    print(f"texture prologue {what}: {r[5]} live lanes, {r[6]} taps, "
          f"bit-equal on the live lanes, max|d| {r[0]:.3g}; kernel "
          f"{r[1]:.4f} ms by events, {r[4]:.4f} ms device; plain "
          f"{r[2]:.2f} ms; bound {r[3][0]:.4f} ms (bytes), "
          f"{r[7]:.4f} ms with a 32-B sector a texel"
          + (f" [{card}]" if card else ""), flush=True)


def pbr_scene(cfg):
    """The PBR benchmark cell's scene at full size, from the benchmark's
    generator with the cell's arguments, written as a .glb and compiled
    under ``cfg`` as ``render`` loads it."""
    import tempfile
    from logipathtracer_tpu_torch import compile_scene, load_gltf
    from portbench.scenes import box_pbr
    from portbench.scenes.glb import write_glb
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "configs",
                           "box_nee_tex_1080p.json")) as f:
        args = json.load(f)["scene"]["args"]
    with tempfile.TemporaryDirectory() as tmp:
        path = write_glb(box_pbr.make(**args), os.path.join(tmp, "pbr.glb"))
        return compile_scene(load_gltf(path), cfg)


def render_radiance(scene, cfg, dev, host_seed, chunks):
    from logipathtracer_tpu_torch import ProgressiveRenderer
    r = ProgressiveRenderer(scene, cfg, host_seed=host_seed, device=dev)
    for n in chunks:
        r.step(n)
    return r.radiance(), r


def nee_phase(dev, card, flagship_rate):
    """Phase 6: the textured + NEE path (module docstring).  Returns the
    K1 any-hit, K2 tex+nee and texture prologue rows (max err, kernel
    ms, plain ms, ...) and the main path's launches by mode."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    from logipathtracer_tpu_torch.render.megakernel import \
        resolve_tex_prologue

    host_scene = load_scene(None, textured=True)
    cfg = RenderConfig(width=1024, height=1024, nee=True)
    tile = cfg.compact_tile
    print(f"NEE scene: {host_scene.num_triangles} triangles, "
          f"{host_scene.num_lights} lights, atlas "
          f"{tuple(host_scene.tex_atlas.shape)}, tex_slots "
          f"{host_scene.tex_slots}", flush=True)

    # (a) + (b): K1 any-hit and K2 tex+nee on the NEE render's pool
    probe = ProgressiveRenderer(host_scene, cfg, host_seed=1, device=dev)
    scene = probe.scene
    pool = bounce_pool(probe)
    t, obj, tri = intersect_scene_sweep(scene, pool["origin"],
                                        pool["direction"], eps=cfg.eps,
                                        tile=tile)
    mat, ffm, nmap = resolve_tex_prologue(scene, cfg, pool["origin"],
                                          pool["direction"], t, obj, tri)
    tex_line(f"checker box, {t.shape[0]} lanes",
             check_tex(scene, cfg, pool, t, obj, tri, runs=(3, 1)))
    opt = dict(mat=mat, ff_mapped=ffm, has_nmap=nmap,
               light_tris=scene.light_tris, light_cdf=scene.light_cdf,
               prev_pdf=pool["prev_pdf"], nee_mis=cfg.nee_mis,
               total_light_area=float(scene.total_light_area))
    out = sk.shade(scene.tri_shade, pool["origin"], pool["direction"],
                   pool["acc"], pool["mask"], pool["alive"], pool["seed"],
                   pool["bounce"], t, tri, env=cfg.env_color,
                   rr_threshold=cfg.rr_threshold, rr_bounces=cfg.rr_bounces,
                   max_order=cfg.heitz_max_order, parity=cfg.parity_rng,
                   **opt)
    shadow_o, shadow_d, t_lim = out[7], out[8], out[9]
    k1 = check_k1_shadow(scene, shadow_o, shadow_d, t_lim, tile, cfg.eps)
    _, wk_ms, wp_ms, wb = k1[6]
    print(f"worklist kernel t_max, shadow pool: the plain worklists, "
          f"kernel {wk_ms:.3f} ms, plain on the card {wp_ms:.3f} ms, bound "
          f"{wb[0]:.4f} ms ({wb[1]})", flush=True)
    print(f"K1 t_max+any-hit shadow pool {t_lim.shape[0]} lanes "
          f"({k1[4]} shadow rays, {k1[3]:.3f} blocked): the plain t on "
          f"every lane, kernel {k1[1]:.3f} ms, plain {k1[2]:.1f} ms "
          f"(once), bound {k1[5][0]:.4f} ms ({k1[5][1]}); worklist + K1 "
          f"{wk_ms + k1[1]:.3f} ms", flush=True)
    k2 = check_k2(scene, cfg, pool, t, tri, parity=True, runs=(10, 1),
                  opt=opt)
    k2_line(f"tex+nee parity {t.shape[0]} lanes (plain once)", k2)
    k2t = check_k2(scene, cfg, pool, t, tri, parity=False, runs=(3, 1),
                   opt=opt)
    k2_line("tex+nee threefry (plain once)", k2t)
    del probe, pool, out, opt, mat, ffm, nmap

    # K2 on a scene of <= 512 triangles (the TPU kernel's tri_sel form)
    small = load_scene(None, spheres=1, subdiv=1)
    probe = ProgressiveRenderer(small, cfg.replace(nee=False), host_seed=1,
                                device=dev)
    o, d, seed = primary_pool(probe)
    ts, _, tris = intersect_scene_sweep(probe.scene, o, d, eps=cfg.eps,
                                        tile=tile)
    n = o.shape[0]
    o, d, seed = (x.contiguous() for x in (o, d, seed))
    spool = dict(origin=o, direction=d, seed=seed,
                 acc=torch.zeros_like(o), mask=torch.ones_like(o),
                 alive=torch.ones(n, dtype=torch.bool, device=dev),
                 bounce=torch.zeros(n, dtype=torch.int32, device=dev))
    k2s = check_k2(probe.scene, cfg, spool, ts, tris, parity=True,
                   runs=(3, 1))
    k2_line(f"on a {small.num_triangles}-triangle scene (tri_sel class), "
            f"{n} lanes (plain once)", k2s)
    del probe, spool

    # (c) the NEE main path
    renderer = ProgressiveRenderer(host_scene, cfg, host_seed=0, device=dev)
    reset_counts()
    renderer.step(1)                        # warm-up
    iters = [renderer.last_iterations]
    torch.cuda.synchronize()
    rays0 = renderer.total_rays
    shadow0 = int(renderer._wf_state["shadow_rays"])
    t0 = time.perf_counter()
    timed = (2, 2)
    for n_spp in timed:
        renderer.step(n_spp)
        iters.append(renderer.last_iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = renderer.total_rays - rays0
    shadow = int(renderer._wf_state["shadow_rays"]) - shadow0
    counts = read_counts(FLAGSHIP)
    tex_launches, tex_plain = read_counts(("tex_prologue",))["tex_prologue"]
    assert_no_plain()
    modes = {"any_hit": ci.mode_launches["any_hit"],
             "closest": ci.mode_launches["closest"],
             "tex+nee": sk.mode_launches["tex+nee"]}
    rad = renderer.radiance()
    assert rad.shape == (1024, 1024, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k, (launched, plain) in counts.items():
        assert launched > 0, f"NEE path never launched kernel {k}"
        assert plain == 0, f"NEE path ran the plain version of {k}"
    n_it = sum(iters)
    assert counts["compact_intersect"][0] >= 2 * n_it, \
        f"K1 launched {counts['compact_intersect'][0]} times in {n_it} " \
        f"iterations"
    assert modes["any_hit"] == modes["tex+nee"] == counts["shade"][0]
    assert (tex_launches, tex_plain) == (modes["tex+nee"], 0), \
        f"texture prologue: {tex_launches} launches, {tex_plain} plain " \
        f"calls in {modes['tex+nee']} textured shade steps"
    spp = sum(timed)
    print(f"NEE+textured main path 1024x1024 spp {spp}: "
          f"{spp / wall:.3f} samples/s, {rays / wall / 1e6:.2f} Mrays/s "
          f"(path rays), iterations per chunk {iters[1:]}, mean radiance "
          f"{mean:.6f}; flagship {flagship_rate[0]:.3f} samples/s, "
          f"{flagship_rate[1]:.2f} Mrays/s [{card}]", flush=True)
    print(f"NEE shadow rays: {shadow} in the timed chunks "
          f"({shadow / wall / 1e6:.2f} M/s), not counted in Mrays/s",
          flush=True)
    print(f"NEE launches: {json.dumps(counts)} by mode "
          f"{json.dumps(modes)}, texture prologue {tex_launches} in {n_it} "
          f"iterations", flush=True)
    assert counts["worklist_prepass"][0] >= 2 * n_it

    # (d) card vs CPU on the NEE path
    small_cfg = RenderConfig(width=64, height=64, pool_size=4096, nee=True)
    img_gpu, _ = render_radiance(host_scene, small_cfg, dev, 7, (2, 2))
    img_cpu, _ = render_radiance(host_scene, small_cfg, "cpu", 7, (2, 2))
    close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(-1)
    print(f"NEE card vs CPU 64x64 2+2 spp: {close.mean():.5f} of pixels "
          f"close", flush=True)
    assert close.mean() >= IMG_FRAC, "NEE card and CPU renders disagree"

    # (e) the texture prologue at the PBR cell's shapes
    t0 = time.perf_counter()
    pbr = pbr_scene(cfg)
    print(f"PBR scene: {pbr.num_triangles} triangles, atlas "
          f"{tuple(pbr.tex_atlas.shape)} ({pbr.tex_atlas.nbytes} B), "
          f"tex_slots {pbr.tex_slots} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    scene, pool, t, obj, tri = tex_pool(pbr, cfg, dev)
    tex = check_tex(scene, cfg, pool, t, obj, tri)
    tex_line(f"PBR cell's scene, {t.shape[0]} lanes", tex, card)
    del pbr, scene, pool, t, obj, tri
    return {"k1": (*k1[:3], k1[5]), "worklist": k1[6], "k2": k2,
            "modes": modes, "prepass": counts["worklist_prepass"][0],
            "tex": tex, "tex_launches": tex_launches}


# Phase 7: K4, K5 and K6 are held against their plain versions on the
# whole 2^20-ray primary pool.  The plain versions loop over tiles and
# clusters on the host; on bounce and shadow rays they take far longer
# per tile (K4 plain: 55 s on 128 bounce tiles, 59 s on 64 shadow tiles,
# H100 80GB HBM3, 700 W), so those pools are cut to the tiles that
# finish in about 15 s, spread over the pool's live tiles.  K6 visits
# every chunk, both bodies on the same sub-pools.
BOUNCE_TILES = 32                       # 2^17 rays
SHADOW_TILES = 16                       # 2^16 rays
K6_BOUNCE_TILES = 16                    # 2^16 rays
K6_SHADOW_TILES = 8                     # 2^15 rays

# The compacted-visit kernels and whether the form each source builds
# stages the next cluster ahead by cp.async (K5's and K6's prefetch) or
# gates then loads (K4, K7).
COMPACTED = {"K4": False, "K5": True, "K6[cap>0]": True, "K7": False}
# The sub-tile visit (K6's cap = 0 body, K8): 128-ray blocks, each
# cluster staged after its gate, a slot left after its u test where
# exact.
SUBTILE = ("K6[cap=0]", "K8")


def staging(kind, r, tile):
    """The count pass's ``staging`` for an intersect kernel on an R-ray
    pool: the block and prefetch of its compacted visit (``COMPACTED``;
    K4's triangle test by 32-slot groups) or the sub-tile visit's block,
    gate then load and early exit (``SUBTILE``)."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    if kind in SUBTILE:
        return dict(block=128, prefetch=False, early_exit=True)
    return dict(block=ci._block_threads(r, tile, kind),
                prefetch=COMPACTED[kind], groups=kind == "K4")


def check_isect(kind, scene, rays8, tile, runs=10, **kw):
    """An intersect kernel (K4-K8) against its plain version on one
    packed pool, bit for bit: t, tri and obj; with any_hit t, and the
    visibility t < t_max on every lane.  Returns (max |dt|, kernel ms
    (median of ``runs``), plain ms (once), hit or blocked fraction,
    bound, visits), all on that pool; visits: the count pass's listed /
    passed / staged block visits, the lanes it counted ("own", "tested"),
    K4's group counts and the mean list length "wn"."""
    kernel, plain, inputs, wn = runner(kind, scene, rays8, tile, **kw)
    got = kernel()
    stage = staging(kind, rays8.shape[1], tile)
    ref, p_ms, work = plain_work(plain, **stage)
    saved = 0
    if kw.get("any_hit") and work["group_slots"] is None:
        saved = any_hit_saved(rays8, ref[1], ref[2], scene_tables(scene),
                              1e-4)
    if kw.get("any_hit"):
        t_max = rays8[6]
        bad = int(((got[0] < t_max) != (ref[0] < t_max)).sum())
        assert bad == 0, f"{kind} any-hit: visibility differs on {bad} lanes"
        assert torch.equal(got[0], ref[0]), \
            f"{kind} any-hit: t differs from the plain version"
        err = float((got[0] - ref[0]).abs().max())
        live = rays8[0] < 1e29
        frac = float((got[0] < t_max)[live].float().mean())
    else:
        for name, g, p in zip(("t", "tri", "obj"), got, ref):
            assert torch.equal(g, p), \
                f"{kind}: {name} differs from the plain version"
        err = float((got[0] - ref[0]).abs().max())
        frac = float((ref[1] >= 0).float().mean())
    b = isect_bound(work, scene, inputs, rays8.shape[1], saved)
    visits = {k: work[k] for k in ("listed", "passed", "staged", "own",
                                   "tested", "rest", "group_tests",
                                   "group_passed", "group_slots")}
    visits.update(wn=float(wn.float().mean()), **stage)
    return err, event_ms(kernel, runs), p_ms, frac, b, visits


def print_visits(kind, what, visits, s):
    """The numbers a visit rests on (check_isect's visits): the mean list
    a tile visits, the (block, cluster) visits listed, the share of them
    some ray of the block passes, and the cluster blocks (9 x S floats
    each) staged per launch by a ring that stages every listed cluster
    and by the kernel; the lanes that run the triangle test against the
    own slab passes; K4's group figures (``harness.group_line``)."""
    blk = 36 * s
    v = visits
    unit = "chunks" if kind in ("K5", "K6[cap>0]", "K6[cap=0]") else \
        "clusters"
    print(f"{kind} {what}: mean list {v['wn']:.1f} {unit} a tile; "
          f"{v['listed']} ({v['block']}-ray block, cluster) visits listed, "
          f"{v['passed']} ({v['passed'] / max(v['listed'], 1):.4f}) passed "
          f"by some ray of the block, {v['staged']} staged; staged per "
          f"launch: {v['listed'] * blk / 1e9:.3f} GB by a ring staging every "
          f"listed cluster, {v['staged'] * blk / 1e9:.3f} GB by the kernel "
          f"(prefetch {v['prefetch']}); lanes tested "
          f"{v['tested'] / max(v['own'], 1):.2f}x the own passes"
          + ("" if v.get("rest") is None else
             f", {v['rest'] / max(v['tested'] * s, 1):.4f} of their slot "
             f"tests past the u decision (early exit)")
          + ("" if v.get("group_tests") is None else
             f"; {group_line(v)}"), flush=True)


def outside_phase(dev, card):
    """Phase 7: the outside-class path (module docstring).  Returns the
    kernel rows (name, source, replaces, launches, run, result of
    check_isect and pool)."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.render.megakernel import \
        resolve_intersect_mode

    t_phase = time.perf_counter()
    host = outside_scene()
    cfg = RenderConfig(width=1024, height=1024)
    tile = cfg.stream_tile
    s = host.cl_tris.shape[2]
    assert resolve_intersect_mode(cfg, host) == "stream"
    print(f"outside scene: {host.num_triangles} triangles, "
          f"{host.num_objects} objects, {host.cl_tris.shape[0]} clusters of "
          f"{s}, {host.num_lights} light triangles "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # (a) kernels against their plain versions
    res = {}

    def check(key, kind, rays8, **kw):
        r = check_isect(kind, scene, rays8, tile, **kw)
        res[key] = (*r[:5], rays8.shape[1])
        if r[5]:
            pool = key[len(kind):].strip() or "primary"
            print_visits(kind, f"{pool} pool {rays8.shape[1]} rays", r[5], s)
        return r

    probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    scene = probe.scene
    o, d, _ = primary_pool(probe)
    full8, _ = ci.pack_rays8(o, d, tile)
    for kind in ("K4", "K5", "K6[cap=0]", "K6[cap>0]"):
        err, k_ms, p_ms, frac, b, _ = check(kind, kind, full8)
        print(f"{kind} primary pool {full8.shape[1]} rays: bit-equal, "
              f"max|dt| {err:.3g}, hit {frac:.3f}, kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.1f} ms (once), bound {b[0]:.4f} ms ({b[1]})",
              flush=True)
    pool = bounce_pool(probe)
    n_alive = int(pool["alive"].sum())
    full8, _ = ci.pack_rays8(pool["origin"], pool["direction"], tile)
    for kind, tiles in (("K4", BOUNCE_TILES), ("K5", BOUNCE_TILES),
                        ("K6[cap>0]", K6_BOUNCE_TILES),
                        ("K6[cap=0]", K6_BOUNCE_TILES)):
        sub8 = sub_pool(full8, tile, n_alive, tiles)
        k_full = event_ms(runner(kind, scene, full8, tile)[0], 10)
        err, k_ms, p_ms, _, b, _ = check(f"{kind} bounce", kind, sub8)
        print(f"{kind} bounce pool ({n_alive} alive): kernel {k_full:.3f} ms "
              f"on {full8.shape[1]} rays; on {sub8.shape[1]} rays bit-equal, "
              f"max|dt| {err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms "
              f"(once), bound {b[0]:.4f} ms ({b[1]}) [{card}]", flush=True)
    del probe, pool, full8, sub8

    probe = ProgressiveRenderer(host, cfg.replace(nee=True), host_seed=1,
                                device=dev)
    scene = probe.scene
    so, sd, t_max, n_alive = shadow_pool(probe)
    full8, _ = ci.pack_rays8(so, sd, tile, t_max=t_max)
    # K6's cap = 0 body ignores any_hit: its t_max mode, t, tri and obj.
    for kind, tiles, any_hit in (("K4", SHADOW_TILES, True),
                                 ("K6[cap>0]", K6_SHADOW_TILES, True),
                                 ("K6[cap=0]", K6_SHADOW_TILES, False)):
        shadow = dict(has_tmax=True, any_hit=any_hit)
        k_full = event_ms(runner(kind, scene, full8, tile, **shadow)[0], 10)
        sub8 = sub_pool(full8, tile, n_alive, tiles)
        key = f"{kind} {'any_hit' if any_hit else 'tmax'}"
        err, k_ms, p_ms, frac, b, _ = check(key, kind, sub8, **shadow)
        what = ("t_max+any-hit", "t", "blocked") if any_hit else \
            ("t_max", "t, tri and obj", "hit")
        print(f"{kind} {what[0]} shadow pool ({n_alive} lanes alive): "
              f"kernel {k_full:.3f} ms on {full8.shape[1]} lanes; on "
              f"{sub8.shape[1]} lanes the plain {what[1]} on every lane, "
              f"{frac:.3f} {what[2]}, max|dt| {err:.3g}, kernel {k_ms:.3f} "
              f"ms, plain {p_ms:.1f} ms (once), bound {b[0]:.4f} ms "
              f"({b[1]}) [{card}]", flush=True)
    del probe, so, sd, t_max, full8, sub8

    # (b) the main path
    renderer = ProgressiveRenderer(host, cfg, host_seed=0, device=dev)
    reset_counts()
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts()
    modes = modes_of("stream_cluster")
    assert rad.shape == (cfg.height, cfg.width, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k in ("stream_cluster", "shade", "flush"):
        assert counts[k][0] > 0, f"outside path never launched kernel {k}"
    for k in ("compact_intersect", "worklist_chunk", "octant_chunk"):
        assert counts[k][0] == 0, f"outside path launched kernel {k}"
    assert_no_plain()
    print(f"outside main path {cfg.width}x{cfg.height} spp 4: {sps:.3f} "
          f"samples/s, {mrays:.2f} Mrays/s, iterations per chunk {iters}, "
          f"mean radiance {mean!r}, rays {renderer.total_rays} [{card}]",
          flush=True)
    print(f"outside launches: {json.dumps(counts)} K4 by mode "
          f"{json.dumps(modes)} (5 samples)", flush=True)
    main_run = f"{cfg.width}^2 main path"
    launches = {"K4": (counts["stream_cluster"][0], main_run)}
    del renderer

    # (c) each other route and the NEE route, timed as the main path
    for label, kw, name, mode in (
            ("K5", dict(stream_granularity="chunk"), "worklist_chunk",
             "closest"),
            ("K6[cap>0]", dict(stream_worklist=False), "octant_chunk",
             "cap/closest"),
            ("K6[cap>0] any_hit", dict(stream_worklist=False, nee=True),
             "octant_chunk", "cap/any_hit"),
            ("K6[cap=0]", dict(stream_compact=False), "octant_chunk",
             "cap0/closest"),
            ("K6[cap=0] tmax", dict(stream_compact=False, nee=True),
             "octant_chunk", "cap0/any_hit"),
            ("K4 any_hit", dict(nee=True), "stream_cluster", "any_hit")):
        r = ProgressiveRenderer(host, cfg.replace(**kw), host_seed=0,
                                device=dev)
        reset_counts()
        sps_r, mrays_r, iters, rad = timed_steps(r)
        n = modes_of(name)[mode]
        assert n > 0, f"{kw}: kernel {label} never launched"
        assert_no_plain()
        assert np.isfinite(rad).all() and 1e-3 < float(rad.mean()) < 10.0
        launches[label] = (n, f"{cfg.width}^2 route " + " ".join(
            f"{k}={v}" for k, v in kw.items()))
        print(f"route {json.dumps(kw)} {cfg.width}x{cfg.height} spp 4: "
              f"{sps_r:.3f} samples/s, {mrays_r:.2f} Mrays/s (path rays), "
              f"iterations per chunk {iters}, {label} launched {n} times in "
              f"5 samples, mean radiance {float(rad.mean())!r}, rays "
              f"{r.total_rays} [{card}]", flush=True)
        del r

    # (d) card vs CPU on the default route
    small = RenderConfig(width=64, height=64, pool_size=4096)
    img_gpu, _ = render_radiance(host, small, dev, 7, (2, 2))
    img_cpu, _ = render_radiance(host, small, "cpu", 7, (2, 2))
    close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(-1)
    print(f"outside card vs CPU 64x64 2+2 spp: {close.mean():.5f} of pixels "
          f"close", flush=True)
    assert close.mean() >= IMG_FRAC, "outside card and CPU renders disagree"
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s", flush=True)

    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    return [(name, src, where, *launches[run], res[key])
            for name, src, where, run, key in (
                ("stream_cluster", k4.SOURCE, k4.REPLACES, "K4", "K4"),
                ("stream_cluster[bounce]", k4.SOURCE, k4.REPLACES, "K4",
                 "K4 bounce"),
                ("stream_cluster[tmax+any_hit]", k4.SOURCE, k4.REPLACES,
                 "K4 any_hit", "K4 any_hit"),
                ("worklist_chunk", ci.WORKLIST_SOURCE, ci.WORKLIST_REPLACES,
                 "K5", "K5"),
                ("worklist_chunk[bounce]", ci.WORKLIST_SOURCE,
                 ci.WORKLIST_REPLACES, "K5", "K5 bounce"),
                ("octant_chunk[cap=0]", k6.SOURCE, k6.REPLACES, "K6[cap=0]",
                 "K6[cap=0]"),
                ("octant_chunk[cap=0 bounce]", k6.SOURCE, k6.REPLACES,
                 "K6[cap=0]", "K6[cap=0] bounce"),
                ("octant_chunk[cap=0 tmax]", k6.SOURCE, k6.REPLACES,
                 "K6[cap=0] tmax", "K6[cap=0] tmax"),
                ("octant_chunk[cap>0]", k6.SOURCE, k6.REPLACES_CAP,
                 "K6[cap>0]", "K6[cap>0]"),
                ("octant_chunk[cap>0 bounce]", k6.SOURCE, k6.REPLACES_CAP,
                 "K6[cap>0]", "K6[cap>0] bounce"),
                ("octant_chunk[cap>0 tmax+any_hit]", k6.SOURCE,
                 k6.REPLACES_CAP, "K6[cap>0] any_hit", "K6[cap>0] any_hit"))]


def wavefront_k7(host_scene, cfg, dev, card, flagship_rate):
    """Phase 8e: the flagship wavefront with compact_worklist=False (K7,
    no per-ray prepass), timed as phase 4 in the same call."""
    from logipathtracer_tpu_torch import ProgressiveRenderer
    renderer = ProgressiveRenderer(host_scene,
                                   cfg.replace(compact_worklist=False),
                                   host_seed=0, device=dev)
    reset_counts()
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts()
    assert np.isfinite(rad).all() and 1e-3 < float(rad.mean()) < 10.0
    assert counts["compact_order"][0] > 0, "K7 never launched"
    assert counts["compact_intersect"][0] == 0, "K1 launched on the K7 route"
    assert_no_plain()
    print(f"wavefront 1024x1024 compact_worklist=False (K7): {sps:.3f} "
          f"samples/s, {mrays:.2f} Mrays/s, iterations per chunk {iters}, "
          f"mean radiance {float(rad.mean()):.6f}; K1 with its prepass in "
          f"phase 4: {flagship_rate[0]:.3f} samples/s, "
          f"{flagship_rate[1]:.2f} Mrays/s [{card}]", flush=True)
    print(f"K7 wavefront launches: {counts['compact_order'][0]} "
          f"(5 samples)", flush=True)
    return sps, mrays


def megakernel_phase(dev, card):
    """Phase 8: the megakernel renderer (module docstring).  Returns the
    K7 and K8 kernel rows (name, source, replaces, launches, run, result
    of check_isect and pool)."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k8
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci

    t_phase = time.perf_counter()
    host = load_scene(None)
    cfg = RenderConfig(width=1024, height=1024, renderer="megakernel")

    # (a) K7 and K8 against their plain versions on the megakernel's pools
    res = {}
    for kind, route in (("K7", dict(compact_worklist=False)),
                        ("K8", dict(intersect="sweep"))):
        rcfg = cfg.replace(**route)
        tile = rcfg.compact_tile if kind == "K7" else rcfg.sweep_tile
        probe = ProgressiveRenderer(host, rcfg, host_seed=1, device=dev)
        primary, bounce, shadow, n_alive = megakernel_pools(probe)
        for pool, (o, d, *t_max) in (("primary", primary),
                                     ("bounce", bounce),
                                     ("shadow", shadow)):
            kw = {}
            if t_max:
                kw = (dict(has_tmax=True, any_hit=True) if kind == "K7"
                      else dict(has_tmax=True))
            rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max[0] if t_max
                                     else None)
            # What the count pass costs the plain time: K7's plain version
            # alone on the primary pool, before and after the counted call.
            bare = (runner(kind, probe.scene, rays8, tile)[1]
                    if (kind, pool) == ("K7", "primary") else None)
            bare_ms = [_time_once(bare)[1]] if bare else []
            r = check_isect(kind, probe.scene, rays8, tile, **kw)
            if bare:
                bare_ms.append(_time_once(bare)[1])
                print(f"K7 plain on the primary pool without the count "
                      f"pass: {bare_ms[0]:.1f} ms before, {bare_ms[1]:.1f} "
                      f"after, {r[2]:.1f} with it", flush=True)
            res[kind, pool] = (*r[:5], rays8.shape[1])
            if r[5]:
                print_visits(kind, f"megakernel {pool} pool", r[5],
                             probe.scene.cl_tris.shape[2])
            what = ("blocked" if t_max else "hit")
            print(f"{kind} megakernel {pool} pool {rays8.shape[1]} rays"
                  + (f" ({n_alive} alive)" if pool == "bounce" else "")
                  + (f" {json.dumps(kw)}" if kw else "")
                  + ": bit-equal"
                  + f": max|dt| {r[0]:.3g}, {what} {r[3]:.3f}, kernel "
                  f"{r[1]:.3f} ms, plain {r[2]:.1f} ms (once), bound "
                  f"{r[4][0]:.4f} ms ({r[4][1]})", flush=True)
        del probe, primary, bounce, shadow

    # (b) the megakernel main path through K1 and K2
    renderer = ProgressiveRenderer(host, cfg, host_seed=0, device=dev)
    reset_counts()
    sps, mrays, _, rad = timed_steps(renderer)
    counts = read_counts()
    assert rad.shape == (1024, 1024, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k in ("compact_intersect", "worklist_prepass", "shade"):
        assert counts[k][0] > 0, f"megakernel never launched kernel {k}"
    for k in ("flush", "compact_order", "dense_sweep"):
        assert counts[k][0] == 0, f"megakernel launched kernel {k}"
    assert_no_plain()
    print(f"megakernel main path 1024x1024 spp 4: {sps:.3f} samples/s, "
          f"{mrays:.2f} Mrays/s, mean radiance {mean:.6f} [{card}]",
          flush=True)
    print(f"megakernel launches (5 samples): {json.dumps(counts)}",
          flush=True)
    del renderer

    # (c) one step(1) at full width on each other route, (d) the BVH walk
    launches = {}
    for label, kw, name, mode in (
            ("K7", dict(compact_worklist=False), "compact_order", "closest"),
            ("K7 any_hit", dict(compact_worklist=False, nee=True),
             "compact_order", "any_hit"),
            ("K8", dict(intersect="sweep"), "dense_sweep", "closest"),
            ("K8 tmax", dict(intersect="sweep", nee=True), "dense_sweep",
             "tmax"),
            ("BVH", dict(intersect="bvh", width=512, height=512), "shade",
             "base")):
        rcfg = cfg.replace(**kw)
        r = ProgressiveRenderer(host, rcfg, host_seed=2, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        r.step(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = modes_of(name)[mode]
        assert n > 0, f"{kw}: {label} never launched {name}"
        counts = read_counts()
        assert counts["compact_intersect"][0] == 0, f"{kw}: K1 launched"
        if label == "BVH":
            assert counts["compact_order"][0] == counts["dense_sweep"][0] \
                == 0, "the BVH route launched an intersect kernel"
        assert_no_plain()
        rad = r.radiance()
        assert np.isfinite(rad).all() and rad.mean() > 1e-3
        launches[label] = (n, f"{rcfg.width}^2 megakernel step(1) " + " ".join(
            f"{k}={v}" for k, v in kw.items() if k not in ("width", "height")))
        print(f"megakernel route {json.dumps(kw)} {rcfg.width}x"
              f"{rcfg.height} step(1): {label} launched {name} {n} times "
              f"({mode}), {wall:.3f} s, {1e-6 * r.total_rays / wall:.2f} "
              f"Mrays/s, mean radiance {float(rad.mean()):.6f}", flush=True)
        del r

    # (f) card vs CPU on the megakernel through K1, K8 and K7
    for label, kw in (("K1", {}), ("K8", dict(intersect="sweep")),
                      ("K7", dict(compact_worklist=False))):
        small = RenderConfig(width=64, height=64, renderer="megakernel", **kw)
        img_gpu, rg = render_radiance(host, small, dev, 7, (2, 2))
        img_cpu, rc = render_radiance(host, small, "cpu", 7, (2, 2))
        close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                           atol=IMG_ATOL).all(-1)
        print(f"megakernel {label} card vs CPU 64x64 2+2 spp: "
              f"{close.mean():.5f} of pixels close, rays "
              f"{rg.total_rays:.0f} / {rc.total_rays:.0f}", flush=True)
        assert close.mean() >= IMG_FRAC, f"megakernel {label}: card and " \
            "CPU renders disagree"
        assert rg.total_rays == rc.total_rays
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s", flush=True)

    rows = [(name, src, where, *launches[key], res[kind, pool])
            for name, src, where, key, kind, pool in (
                ("compact_order", ci.ORDER_SOURCE, ci.ORDER_REPLACES, "K7",
                 "K7", "primary"),
                ("compact_order[bounce]", ci.ORDER_SOURCE, ci.ORDER_REPLACES,
                 "K7", "K7", "bounce"),
                ("compact_order[tmax+any_hit]", ci.ORDER_SOURCE,
                 ci.ORDER_REPLACES, "K7 any_hit", "K7", "shadow"),
                ("dense_sweep", k8.SWEEP_SOURCE, k8.SWEEP_REPLACES, "K8",
                 "K8", "primary"),
                ("dense_sweep[bounce]", k8.SWEEP_SOURCE, k8.SWEEP_REPLACES,
                 "K8", "K8", "bounce"),
                ("dense_sweep[tmax]", k8.SWEEP_SOURCE, k8.SWEEP_REPLACES,
                 "K8 tmax", "K8", "shadow"))]
    return rows


# Phase 9's command-line runs: each subprocess's time limit (seconds).
CLI_TIMEOUT = 180


def _cli(*argv, cwd):
    """Start ``python -m logipathtracer_tpu_torch.cli.main *argv`` from the
    checkout's root, its output in pipes."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "logipathtracer_tpu_torch.cli.main", *argv],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc, what):
    """Wait for a CLI subprocess (killing it past CLI_TIMEOUT); fail on a
    non-zero exit.  Returns its standard output."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no exit within {CLI_TIMEOUT} s")
    assert proc.returncode == 0, \
        f"{what}: exit {proc.returncode}\n{err[-4000:]}"
    return out


def _fetch(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read(), dict(r.headers)


def web_frame(web, port_file):
    """Poll a ``web`` subprocess's /stats until a frame is published,
    then fetch /frame.raw.  Returns (stats, body, (frame width, frame
    height, display width, display height))."""
    t0 = time.perf_counter()
    stats = raw = None
    while time.perf_counter() - t0 < CLI_TIMEOUT:
        assert web.poll() is None, "web exited before a frame " \
            f"was fetched: {web.communicate()[1][-4000:]}"
        if os.path.exists(port_file) and open(port_file).read():
            base = f"http://127.0.0.1:{open(port_file).read()}"
            stats = json.loads(_fetch(base + "/stats")[0])
            if not stats["compiling"] and stats["frame_gen"] > 0:
                raw = _fetch(base + "/frame.raw")
                break
        time.sleep(0.05)
    assert raw is not None, f"web served no frame: {stats}"
    body, head = raw
    return stats, body, tuple(int(head[f"X-{k}"]) for k in (
        "Frame-Width", "Frame-Height", "Display-Width", "Display-Height"))


def cli_runs(card):
    """Phase 9e: the command line on the card, as subprocesses: the box
    written with tools/glb.write_glb; ``render`` at 1024x1024, 4 spp, with
    and without ``--basic`` (JSON report, PNG, radiance .npz and EXR
    checked), ``compare`` on the two, and ``web`` at 256x256 for 3 frames
    with /stats and /frame.raw fetched while it serves."""
    import tempfile

    from logipathtracer_tpu_torch.film.exr import encode_exr
    from logipathtracer_tpu_torch.film.png import decode_png
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    from logipathtracer_tpu_torch.tools.glb import write_glb

    res, web_res = 1024, 256

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            glb = write_glb(make_box_scene(spheres=10, subdiv=3),
                            os.path.join(tmp, "box.glb"))
            renders = {}
            for name, flags in (("heitz", ()), ("basic", ("--basic",))):
                paths = {k: os.path.join(tmp, f"{name}.{k}")
                         for k in ("npz", "exr", "png")}
                proc = _cli("render", glb, "--width", str(res), "--height",
                            str(res), "--spp", "4", "--radiance",
                            paths["npz"], "--exr", paths["exr"], "-o",
                            paths["png"], *flags, cwd=tmp)
                procs.append(proc)
                renders[name] = (proc, paths)
            port_file = os.path.join(tmp, "port")
            web = _cli("web", glb, "--width", str(web_res), "--height",
                       str(web_res), "--frames", "3", "--port", "0",
                       "--port-file", port_file, "--linger", "2", cwd=tmp)
            procs.append(web)

            # /stats and /frame.raw once, while web serves its frames.
            stats, body, size = web_frame(web, port_file)
            assert size == (web_res,) * 4, size
            frame = np.frombuffer(body, np.uint8).reshape(web_res, web_res,
                                                          4)
            assert frame[..., 3].min() == 255 and frame[..., :3].max() > 0
            _finish(web, "web")
            print(f"CLI web {web_res}x{web_res} --frames 3: /stats spp "
                  f"{stats['spp']} ({stats['mode']}), /frame.raw "
                  f"{len(body)} bytes, {size[0]}x{size[1]} frame and "
                  "display", flush=True)

            for name, (proc, paths) in renders.items():
                report = json.loads(
                    _finish(proc, f"render {name}").strip().splitlines()[-1])
                png = decode_png(open(paths["png"], "rb").read())
                assert png.shape[:2] == (res, res), png.shape
                data = np.load(paths["npz"])
                rad = data["radiance"]
                assert rad.shape == (res, res, 3) and np.isfinite(rad).all()
                assert int(data["sample_count"]) == report["spp"] == 4
                assert report["total_rays"] > 0 and rad.mean() > 1e-3
                assert open(paths["exr"], "rb").read() == encode_exr(rad), \
                    f"render {name}: the EXR is not the radiance's"
                print(f"CLI render {name} {res}x{res} 4 spp: "
                      f"{json.dumps(report)} mean radiance "
                      f"{float(rad.mean()):.6f} [{card}]", flush=True)
            cmp = _cli("compare", renders["heitz"][1]["npz"],
                       renders["basic"][1]["npz"], cwd=tmp)
            procs.append(cmp)
            result = json.loads(_finish(cmp, "compare").strip())
            assert result["shape"] == [res, res, 3] \
                and np.isfinite(result["rmse"])
            print(f"CLI compare heitz basic: {json.dumps(result)}",
                  flush=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def basic_phase(dev, card, flagship_rate):
    """Phase 9: the basic BSDF and the command line (module docstring).
    The kernels it launches are held to their plain versions in phase 3
    at the same shapes."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.tools.stages import eager, stage_timers

    t_phase = time.perf_counter()
    host = load_scene(None)
    cfg = RenderConfig(width=1024, height=1024, use_microfacet=False)

    # (a) the basic main path: the worklist kernel, K1, K3, never K2
    renderer = ProgressiveRenderer(host, cfg, host_seed=0, device=dev)
    reset_counts()
    sk.basic_calls = 0
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts(FLAGSHIP)
    basic_calls = sk.basic_calls
    assert rad.shape == (1024, 1024, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k in ("compact_intersect", "worklist_prepass", "flush"):
        assert counts[k][0] > 0, f"basic path never launched kernel {k}"
    assert counts["shade"][0] == 0, "the basic path launched K2"
    assert basic_calls > 0, "the basic path never ran the basic route"
    assert_no_plain()
    # The basic route's time per iteration: one more step(2) with every
    # stage between device syncs (tools/stages.py), in the eager form
    # (a replayed graph calls no Python stage).
    seconds = {}
    with eager(renderer), stage_timers(dev, seconds):
        renderer.step(2)
    route_s, calls = seconds["basic route"]
    it_s, n_it = seconds["iteration total"]
    print(f"basic main path 1024x1024 spp 4: {sps:.3f} samples/s, "
          f"{mrays:.2f} Mrays/s, iterations per chunk {iters}, mean "
          f"radiance {mean:.6f}; flagship {flagship_rate[0]:.3f} samples/s, "
          f"{flagship_rate[1]:.2f} Mrays/s [{card}]", flush=True)
    print(f"basic route: {1e3 * route_s / calls:.3f} ms per iteration, "
          f"{route_s / it_s:.1%} of a step(2)'s {n_it} iterations of "
          f"{1e3 * it_s / n_it:.3f} ms with every stage synced", flush=True)
    print(f"basic launches: {json.dumps(counts)}, basic route calls "
          f"{basic_calls}", flush=True)
    del renderer

    # (b) NEE: K1 in its any-hit mode too; (c) the megakernel
    for label, kw in (("NEE", dict(nee=True)),
                      ("megakernel", dict(renderer="megakernel"))):
        r = ProgressiveRenderer(host, cfg.replace(**kw), host_seed=2,
                                device=dev)
        reset_counts()
        sk.basic_calls = 0
        t0 = time.perf_counter()
        r.step(1)
        rad = r.radiance()              # the wavefront drains its pool
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert counts["compact_intersect"][0] > 0, f"{label}: K1 never ran"
        assert counts["worklist_prepass"][0] > 0, \
            f"{label}: the worklist kernel never ran"
        assert counts["shade"][0] == 0, f"{label}: K2 launched"
        assert sk.basic_calls > 0, f"{label}: the basic route never ran"
        if label == "NEE":
            assert ci.mode_launches["any_hit"] > 0, "NEE: no K1 any-hit"
        else:
            assert counts["flush"][0] == 0, "megakernel: K3 launched"
        assert_no_plain()
        assert np.isfinite(rad).all() and rad.mean() > 1e-3
        print(f"basic {label} 1024x1024 step(1) and radiance(): "
              f"{wall:.3f} s, "
              f"{1e-6 * r.total_rays / wall:.2f} Mrays/s, mean radiance "
              f"{float(rad.mean()):.6f}; K1 by mode "
              f"{json.dumps(dict(ci.mode_launches))}, basic route calls "
              f"{sk.basic_calls}", flush=True)
        del r

    # (d) card vs CPU, NEE off and on
    for nee in (False, True):
        small = RenderConfig(width=64, height=64, pool_size=4096,
                             use_microfacet=False, nee=nee)
        img_gpu, rg = render_radiance(host, small, dev, 7, (2, 2))
        img_cpu, rc = render_radiance(host, small, "cpu", 7, (2, 2))
        close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                           atol=IMG_ATOL).all(-1)
        print(f"basic nee={nee} card vs CPU 64x64 2+2 spp: "
              f"{close.mean():.5f} of pixels close, rays "
              f"{rg.total_rays:.0f} / {rc.total_rays:.0f}", flush=True)
        assert close.mean() >= IMG_FRAC, \
            f"basic nee={nee}: card and CPU renders disagree"
        assert rg.total_rays == rc.total_rays

    # (e) the command line
    t_cli = time.perf_counter()
    cli_runs(card)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s (CLI "
          f"{time.perf_counter() - t_cli:.1f} s)", flush=True)


def _slabs_equal(scene, cfg, cam, fov, seeds, what, rows=512):
    """render_wavefront of the full frame with the launch counts set to
    0 just before it, then of its slabs of ``rows`` rows: the slabs
    concatenated must equal the frame bit for bit and their rays add up.
    Returns (frame, rays, iterations, ms, launches of the frame's call,
    launches by mode)."""
    from logipathtracer_tpu_torch import render_wavefront
    h = cfg.render_height
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, rays, iters = render_wavefront(scene, cfg, cam, fov, seeds)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    modes = {k: modes_of(k) for k in ("compact_intersect", "shade")}
    assert_no_plain()
    parts = [render_wavefront(scene, cfg, cam, fov, seeds, y0=y0, rows=rows)
             for y0 in range(0, h, rows)]
    tiled = torch.cat([p[0] for p in parts])
    assert torch.equal(tiled, full), f"{what}: slabs differ from the frame"
    assert sum(p[1] for p in parts) == rays, f"{what}: slab rays differ"
    assert full.shape == (h, cfg.render_width, 3)
    assert bool(torch.isfinite(full).all()) and float(full.mean()) > 1e-3
    print(f"render_wavefront {what}: {ms:.1f} ms, {rays} rays, {iters} "
          f"iterations, mean {float(full.mean()):.6f}; {h // rows} slabs of "
          f"{rows} rows bit-equal, iterations "
          f"{[p[2] for p in parts]}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v[0]})} by "
          f"mode {json.dumps(modes)}", flush=True)
    return full, rays, iters, ms, counts, modes


def single_shot_phase(dev, card, flagship_rate):
    """Phase 10: render_wavefront and the device mesh (module
    docstring)."""
    from logipathtracer_tpu_torch import (MeshRenderer, ProgressiveRenderer,
                                          RenderConfig, render_wavefront)
    from logipathtracer_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    host = load_scene(None)
    cfg = RenderConfig(width=1024, height=1024)
    cam_h = host.cameras[0]
    cam = torch.from_numpy(np.asarray(cam_h.world_matrix,
                                      np.float32)).to(dev)
    fov = float(cam_h.yfov)
    seeds = torch.tensor([[12345, 678]], dtype=torch.int64, device=dev)

    # (a) the flagship: full frame and two 512-row slabs
    *_, counts, _ = _slabs_equal(host.to(dev), cfg, cam, fov, seeds,
                                 "flagship 1024^2 1 spp")
    for k in FLAGSHIP:
        assert counts[k][0] > 0, f"render_wavefront never launched {k}"

    # (b) NEE on the textured box (K1 any-hit), then the outside class (K4)
    tex = load_scene(None, textured=True)
    *_, modes = _slabs_equal(tex.to(dev), cfg.replace(nee=True), cam, fov,
                             seeds, "NEE+textured 1024^2 1 spp")
    assert modes["compact_intersect"].get("any_hit", 0) > 0, \
        "render_wavefront with NEE never launched K1 any-hit"
    outside = outside_scene()
    cam_o = outside.cameras[0]
    reset_counts()
    t0 = time.perf_counter()
    img, rays, iters = render_wavefront(
        outside.to(dev), cfg, torch.from_numpy(np.asarray(
            cam_o.world_matrix, np.float32)).to(dev), float(cam_o.yfov),
        seeds)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    assert counts["stream_cluster"][0] > 0, "the outside frame never ran K4"
    assert_no_plain()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3
    print(f"render_wavefront outside 1024^2 1 spp: {ms:.1f} ms, {rays} "
          f"rays, {iters} iterations, mean {float(img.mean()):.6f}; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v[0]})}",
          flush=True)
    del tex, outside, img

    # (c) the single-shot session, timed as phase 4
    single = cfg.replace(pool_carryover=False)
    renderer = ProgressiveRenderer(host, single, host_seed=0, device=dev)
    reset_counts()
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts(FLAGSHIP)
    assert_no_plain()
    assert all(n > 0 for n, _ in counts.values())
    assert np.isfinite(rad).all() and 1e-3 < float(rad.mean()) < 10.0
    print(f"single-shot session (pool_carryover=False) 1024x1024 spp 4: "
          f"{sps:.3f} samples/s, {mrays:.2f} Mrays/s, iterations per call "
          f"{iters}, mean radiance {float(rad.mean()):.6f}; carried-over "
          f"pool (phase 4): {flagship_rate[0]:.3f} samples/s, "
          f"{flagship_rate[1]:.2f} Mrays/s [{card}]", flush=True)
    print(f"single-shot launches: {json.dumps(counts)} (5 samples)",
          flush=True)
    del renderer

    # (d) the mesh on the card against the single-device session
    rounds = 3

    def session(c, mesh=None):
        if mesh is None:
            r = ProgressiveRenderer(host, c, host_seed=5, device=dev)
        else:
            r = MeshRenderer(host, c, mesh, host_seed=5)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(rounds):
            r.step(1)
        rad = r.radiance()
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert_no_plain()
        assert counts["compact_intersect"][0] > 0, "K1 never launched"
        return rad, r.total_rays, wall, counts

    for label, c in (("wavefront", single),
                     ("megakernel", cfg.replace(renderer="megakernel"))):
        ref = session(c)
        runs = [("1x1", make_mesh(["cuda:0"])),
                ("1x2", make_mesh(["cuda:0"] * 2, samples=1, tiles=2))]
        if label == "megakernel":
            runs = runs[:1]
        for shape, mesh in runs:
            got = session(c, mesh)
            assert np.array_equal(got[0], ref[0]), \
                f"{label} mesh {shape} differs from the session"
            assert got[1] == ref[1], f"{label} mesh {shape}: rays differ"
            launched = {k: v for k, v in got[3].items() if v[0]}
            print(f"mesh {shape} {label} 1024x1024, {rounds} rounds: "
                  f"bit-equal to the session's {rounds} step(1), rays "
                  f"{got[1]:.0f}; {got[2]:.3f} s against {ref[2]:.3f} s; "
                  f"launches {json.dumps(launched)}", flush=True)

    # (e) card against CPU on a 64x64 (1, 2) wavefront mesh, and one
    # mesh over both (a worker thread each)
    small = RenderConfig(width=64, height=64, pool_size=4096,
                         renderer="wavefront")
    meshes = {}
    for key, devs in (("card", ["cuda:0"] * 2), ("cpu", ["cpu"] * 2),
                      ("both", ["cuda:0", "cpu"])):
        m = MeshRenderer(host, small, make_mesh(devs, samples=1, tiles=2),
                         host_seed=7)
        m.step(2)
        meshes[key] = m
    card_rad, cpu_rad = (meshes[k].radiance() for k in ("card", "cpu"))
    close = np.isclose(card_rad, cpu_rad, rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(-1)
    both = meshes["both"].accum[0]
    assert torch.equal(both[0], meshes["card"].accum[0][0])
    assert torch.equal(both[1], meshes["cpu"].accum[0][1])
    print(f"mesh 1x2 card vs CPU 64x64 2 rounds: {close.mean():.5f} of "
          f"pixels close, rays {meshes['card'].total_rays:.0f} / "
          f"{meshes['cpu'].total_rays:.0f}; a mesh of the card and the CPU "
          f"equals each tile bit for bit", flush=True)
    assert close.mean() >= IMG_FRAC, "mesh: card and CPU renders disagree"
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase 11: the card against the CPU at small shapes with the traits of
# the default configuration's (module docstring): (label, RenderConfig
# fields).  Each renders step(2), rotate(1, 0.05), step(1), step(1).
DEFAULT_TRAITS = (
    ("wavefront 120x68", dict(width=120, height=68)),
    ("megakernel 120x68", dict(width=120, height=68,
                               renderer="megakernel")),
    ("wavefront 96x54 pool 2048", dict(width=96, height=54,
                                       pool_size=2048)),
    ("render_scale=2 60x34, image()", dict(width=60, height=34,
                                           render_scale=2)),
)


@contextlib.contextmanager
def cpu_shadowed():
    """Every call of the worklist kernel, K1, K2 and K3 in the block runs
    again as its plain version on the CPU, on the same inputs: the
    worklists, K1 (t, tri and obj; t alone in any-hit) and K3 must equal
    it bit for bit, K2 its floats on every lane whose RNG draws and alive
    flag agree (``shade.shade_agreement``).  A K2 lane whose draws or
    alive flag differ from the CPU's must have the same ones as K2's
    plain version on the card: a walk the device's libm steers otherwise
    than the host's, not a kernel fault.  Yields a dict: after the block,
    "calls" (card calls shadowed) and "diverged" (such K2 lanes)."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import flush as fl
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.render import wavefront as wf
    saved = (ci.build_chunk_worklists, ci.compact_wl_intersect, sk.shade,
             wf.flush_sorted)
    seen = {"calls": 0, "diverged": 0}

    def on_cpu(xs):
        return [x.cpu() if isinstance(x, torch.Tensor) else x for x in xs]

    def worklists(*a, **kw):
        got = saved[0](*a, **kw)
        if got[1].is_cuda:
            wlp, wnp = ci.build_chunk_worklists_plain(*on_cpu(a), **kw)
            wl, wn = got[0].cpu(), got[1].cpu()
            live = torch.arange(wl.shape[1])[None] < wn[:, None]
            assert torch.equal(wn, wnp) and torch.equal(wl[live], wlp[live]), \
                "the worklist kernel differs from the CPU's plain version"
            seen["calls"] += 1
        return got

    def k1(*a, **kw):
        got = saved[1](*a, **kw)
        if got[0].is_cuda:
            ref = ci.compact_wl_intersect_plain(*on_cpu(a), **kw)
            n = 1 if kw.get("any_hit") else 3
            for name, g, p in list(zip(("t", "tri", "obj"), got, ref))[:n]:
                assert torch.equal(g.cpu(), p), \
                    f"K1 {name} differs from the CPU's plain version"
            seen["calls"] += 1
        return got

    def k2(*a, **kw):
        got = saved[2](*a, **kw)
        if got[0].is_cuda:
            host = [x.cpu() for x in got]
            ref = sk.shade_plain(*on_cpu(a), **dict(zip(
                kw, on_cpu(kw.values()))))
            same = (host[4] == ref[4]) & (host[5] == ref[5]).all(-1)
            lanes = (~same).nonzero().squeeze(1)
            if lanes.numel():
                card = sk.shade_plain(*a, **kw)
                at = lanes.to(got[0].device)
                for i in (4, 5):        # alive, seed
                    assert torch.equal(got[i][at], card[i][at]), \
                        "K2 differs from its plain version on the card"
                seen["diverged"] += lanes.numel()
            sk.shade_agreement([x.numpy() for x in ref],
                               [x.numpy() for x in host])
            seen["calls"] += 1
        return got

    def k3(accum, pix, acc):
        before = accum.cpu()
        got = saved[3](accum, pix, acc)
        if got.is_cuda:
            ref = fl.flush_sorted_plain(before, pix.cpu(), acc.cpu())
            assert torch.equal(got.cpu(), ref), \
                "K3 differs from the CPU's plain version"
            seen["calls"] += 1
        return got

    ci.build_chunk_worklists, ci.compact_wl_intersect = worklists, k1
    sk.shade, wf.flush_sorted = k2, k3
    try:
        yield seen
    finally:
        (ci.build_chunk_worklists, ci.compact_wl_intersect, sk.shade,
         wf.flush_sorted) = saved


def mean_lists(host, cfg, dev):
    """The mean worklist length a tile of ``cfg``'s primary and bounce
    pools (harness ``primary_pool``, ``bounce_pool``) gets from the
    worklist kernel: (primary, bounce, pixels blocked)."""
    from logipathtracer_tpu_torch import ProgressiveRenderer
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
    from logipathtracer_tpu_torch.render.wavefront import pix_layout
    probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    bounds = scene_cluster_bounds(probe.scene)
    o, d, _ = primary_pool(probe)
    pool = bounce_pool(probe)
    out = []
    for o, d in ((o, d), (pool["origin"], pool["direction"])):
        rays8, _ = ci.pack_rays8(o, d, cfg.compact_tile)
        _, wn = ci.build_chunk_worklists(*bounds, rays8, cfg.compact_tile)
        out.append(float(wn.float().mean()))
    blocked = pix_layout(cfg, probe.scene, cfg.render_height,
                         cfg.render_width)[0]
    return out[0], out[1], blocked


def step_launches(renderer, chunks, what):
    """Step ``renderer`` through ``chunks`` with the launch counts set
    to 0 just before; returns (wall s, launches, radiance), the radiance
    finite and plausible and no plain version run."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in chunks:
        renderer.step(n)
    rad = renderer.radiance()
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert_no_plain()
    cfg = renderer.config
    assert rad.shape == (cfg.render_height, cfg.render_width, 3), rad.shape
    assert np.isfinite(rad).all() and 1e-3 < float(rad.mean()) < 10.0, \
        f"{what}: implausible radiance"
    return wall, counts, rad


def default_cli_runs(card):
    """Phase 11g: ``render`` and ``web`` on the box .glb with no size
    flags, as subprocesses: 1920x1080 by the CLI's defaults."""
    import tempfile

    from logipathtracer_tpu_torch.film.png import decode_png
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    from logipathtracer_tpu_torch.tools.glb import write_glb

    w, h = 1920, 1080
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            glb = write_glb(make_box_scene(spheres=10, subdiv=3),
                            os.path.join(tmp, "box.glb"))
            png, npz = (os.path.join(tmp, f"r.{k}") for k in ("png", "npz"))
            render = _cli("render", glb, "--spp", "2", "-o", png,
                          "--radiance", npz, cwd=tmp)
            procs.append(render)
            port_file = os.path.join(tmp, "port")
            web = _cli("web", glb, "--frames", "3", "--port", "0",
                       "--port-file", port_file, "--linger", "2", cwd=tmp)
            procs.append(web)
            stats, body, size = web_frame(web, port_file)
            assert size == (w, h, w, h), size
            frame = np.frombuffer(body, np.uint8).reshape(h, w, 4)
            assert frame[..., 3].min() == 255 and frame[..., :3].max() > 0
            _finish(web, "web")
            print(f"CLI web (no size flags) --frames 3: /stats spp "
                  f"{stats['spp']} ({stats['mode']}), /frame.raw "
                  f"{len(body)} bytes, frame and display {w}x{h}",
                  flush=True)
            report = json.loads(
                _finish(render, "render").strip().splitlines()[-1])
            assert (report["width"], report["height"]) == (w, h), report
            img = decode_png(open(png, "rb").read())
            assert img.shape[:2] == (h, w), img.shape
            rad = np.load(npz)["radiance"]
            assert rad.shape == (h, w, 3) and np.isfinite(rad).all()
            assert report["spp"] == 2 and rad.mean() > 1e-3
            print(f"CLI render (no size flags) --spp 2: {json.dumps(report)} "
                  f"PNG {img.shape}, mean radiance {float(rad.mean()):.6f} "
                  f"[{card}]", flush=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def default_config_phase(dev, card, flagship):
    """Phase 11: the system's default configuration, 1920x1080 (module
    docstring).  ``flagship``: phase 4's (samples/s, Mrays/s,
    iterations per chunk).  Returns its kernel rows (name, source,
    replaces, launches, run, pool, max err, ms, plain ms, bound[,
    library ms])."""
    import tempfile

    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.film.png import decode_png
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import flush
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    from logipathtracer_tpu_torch.tools import interactive

    t_phase = time.perf_counter()
    host = load_scene(None)
    cfg = RenderConfig()
    w, h = cfg.width, cfg.height
    assert (w, h) == (1920, 1080), (w, h)
    tile = cfg.compact_tile
    rows = []

    def k1_rows(what, run, launched, scene, o, d):
        """K1 and its worklist kernel against their plain versions on a
        pool of this phase, as in phase 3, the plain K1's time that of
        the compared call (it takes seconds on the 1080p pools)."""
        k1 = check_k1(scene, o, d, tile, cfg.eps, runs=(10, 0))
        print_k1(f"{what} {o.shape[0]} rays, hit {k1[3]:.3f}", k1, card)
        wk_ms, wp_ms, wb = k1[5][1:]
        rows.append(("compact_intersect[" + what + "]", ci.SOURCE,
                     ci.REPLACES, launched, run, o.shape[0], *k1[:3], k1[4]))
        rows.append(("compact_intersect[worklist " + what + "]", ci.SOURCE,
                     ci.PREPASS_REPLACES, launched, run, o.shape[0],
                     k1[5][0], wk_ms, wp_ms, wb))

    # (a) the flagship session at 1920x1080
    parts = {}
    t_part = time.perf_counter()
    lists = mean_lists(host, cfg, dev)
    lists_1024 = mean_lists(host, cfg.replace(width=1024, height=1024), dev)
    assert not lists[2] and lists_1024[2], "pixel layouts not as expected"
    renderer = ProgressiveRenderer(host, cfg, host_seed=0, device=dev)
    reset_counts()
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts(FLAGSHIP)
    assert_no_plain()
    for k, (launched, _) in counts.items():
        assert launched > 0, f"1080p main path never launched kernel {k}"
    assert rad.shape == (h, w, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    print(f"(a) flagship {w}x{h} spp 4: {sps:.3f} samples/s, {mrays:.2f} "
          f"Mrays/s, iterations per step(2) {iters}, mean radiance "
          f"{mean:.6f}; phase 4 at 1024^2: {flagship[0]:.3f} samples/s "
          f"(/ {h * w / 1024 ** 2:.3f} = "
          f"{flagship[0] * 1024 ** 2 / (h * w):.3f}), {flagship[1]:.2f} "
          f"Mrays/s, iterations {flagship[2]} [{card}]",
          flush=True)
    print(f"(a) mean worklist per {tile}-ray tile, primary / bounce pool: "
          f"{lists[0]:.2f} / {lists[1]:.2f} clusters at {w}x{h} (row-major)"
          f", {lists_1024[0]:.2f} / {lists_1024[1]:.2f} at 1024^2 "
          f"(32x128 blocks), of {host.cl_tris.shape[0]}; launches "
          f"{json.dumps(counts)}", flush=True)
    o, d, _ = primary_pool(renderer)
    k1_rows("1080p primary", "1080p main path",
            counts["compact_intersect"][0], renderer.scene, o, d)
    del renderer, o, d
    parts["a"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (b) the megakernel at 1920x1080: 2,073,600 rays, 507 tiles, the last
    # padded
    mk_cfg = cfg.replace(renderer="megakernel")
    r = ProgressiveRenderer(host, mk_cfg, host_seed=2, device=dev)
    wall, counts, rad = step_launches(r, (1,), "megakernel")
    for k in ("compact_intersect", "worklist_prepass", "shade"):
        assert counts[k][0] > 0, f"1080p megakernel never launched {k}"
    assert counts["flush"][0] == 0, "the megakernel launched K3"
    print(f"(b) megakernel {w}x{h} step(1): {wall:.3f} s, "
          f"{1e-6 * r.total_rays / wall:.2f} Mrays/s, mean radiance "
          f"{float(rad.mean()):.6f}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v[0]})}",
          flush=True)
    primary = megakernel_pools(r)[0]
    k1_rows("1080p megakernel primary", "1080p megakernel step(1)",
            counts["compact_intersect"][0], r.scene, *primary)
    del r, primary
    parts["b"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (c) NEE + textured at 1920x1080
    tex = load_scene(None, textured=True)
    r = ProgressiveRenderer(tex, cfg.replace(nee=True), host_seed=2,
                            device=dev)
    wall, counts, rad = step_launches(r, (2,), "NEE + textured")
    modes = {"K1 any_hit": ci.mode_launches["any_hit"],
             "K2 tex+nee": sk.mode_launches["tex+nee"]}
    assert all(modes.values()), f"1080p NEE + textured: {modes}"
    print(f"(c) NEE + textured {w}x{h} step(2): {wall:.3f} s, mean radiance "
          f"{float(rad.mean()):.6f}; launches by mode {json.dumps(modes)}",
          flush=True)
    del r, tex
    parts["c"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (d) the outside class at 1920x1080
    r = ProgressiveRenderer(outside_scene(), cfg, host_seed=2, device=dev)
    wall, counts, rad = step_launches(r, (1,), "outside")
    assert counts["stream_cluster"][0] > 0, "1080p outside never ran K4"
    print(f"(d) outside class {w}x{h} step(1): {wall:.3f} s, mean radiance "
          f"{float(rad.mean()):.6f}; K4 launched "
          f"{counts['stream_cluster'][0]} times", flush=True)
    del r
    parts["d"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (e) render_scale=2: 3840x2160 rendered, 8,294,400 pixel ids into K3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    r = ProgressiveRenderer(host, cfg.replace(render_scale=2), host_seed=2,
                            device=dev)
    reset_counts()
    t0 = time.perf_counter()
    r.step(1)
    img = r.image()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(FLAGSHIP)
    assert_no_plain()
    peak = torch.cuda.max_memory_allocated(dev)
    assert img.shape == (h, w, 3), img.shape
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3
    assert counts["flush"][0] > 0, "render_scale=2 never launched K3"
    print(f"(e) render_scale=2 {w}x{h} ({r.config.render_width}x"
          f"{r.config.render_height} rendered) step(1) + image(): "
          f"{wall:.3f} s, image {tuple(img.shape)} mean "
          f"{float(img.mean()):.6f}; peak memory "
          f"{peak / 2 ** 20:.1f} MiB allocated ({(peak - base) / 2 ** 20:.1f}"
          f" MiB above the {base / 2 ** 20:.1f} MiB held before) [{card}]",
          flush=True)
    del r, img
    k3 = check_k3(dev, npix=2 * w * 2 * h, device=False)
    print(f"K3 2^18 retired of 2^20 rows into {2 * w}x{2 * h}: max|d| "
          f"{k3[0]:.3g}, kernel {k3[1]:.4f} ms, index_add_ {k3[4]:.4f} ms, "
          f"plain {k3[2]:.3f} ms, bound {k3[3][0]:.4f} ms ({k3[3][1]})",
          flush=True)
    rows.append(("flush[2160p]", flush.SOURCE, flush.REPLACES,
                 counts["flush"][0], "render_scale=2 step(1) + image()",
                 1 << 20, *k3[:3], k3[3], k3[4]))
    parts["e"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (f) the interactive loop, tools/interactive.py, at its defaults
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        report, _ = interactive.run(interactive.parse_args(
            ["--out", os.path.join(tmp, "session")]))
        counts = read_counts(FLAGSHIP)
        assert_no_plain()
        png = decode_png(open(os.path.join(tmp, "session.png"), "rb").read())
    for k, (launched, _) in counts.items():
        assert launched > 0, f"the interactive loop never launched {k}"
    assert (report["resolution"], report["preview_resolution"],
            report["preview_depth"]) == ("1920x1080", "480x270", 4), report
    assert png.shape[:2] == (h, w) and png[..., :3].max() > 0, \
        "the converged PNG is black"
    nav, acc = report["navigate_1spp"], report["converge_accum"]
    print(f"(f) interactive loop: navigate {report['preview_resolution']} "
          f"depth {report['preview_depth']}: {nav['fps_mean']:.3f} fps mean, "
          f"{nav['fps_best']:.3f} best, {nav['frame_ms_median']:.3f} ms "
          f"median, {nav['samples_per_sec']:.3f} samples/s, "
          f"{nav['mrays_per_sec']:.3f} Mrays/s; converge "
          f"{report['resolution']}: {acc['fps_mean']:.3f} fps mean, "
          f"{acc['fps_best']:.3f} best, {acc['frame_ms_median']:.3f} ms "
          f"median, {acc['samples_per_sec']:.3f} samples/s, "
          f"{acc['mrays_per_sec']:.3f} Mrays/s; warm-up "
          f"{report['warmup_s']:.3f} s, PNG {report['png_screenshot_s']:.3f}"
          f" s; launches {json.dumps(counts)} [{card}]", flush=True)
    run = "interactive loop (navigate + converge)"
    pcfg = RenderConfig(width=w // 4, height=h // 4, max_depth=4)
    probe = ProgressiveRenderer(host, pcfg, host_seed=1, device=dev)
    o, d, _ = primary_pool(probe)
    k1_rows("preview primary", run, counts["compact_intersect"][0],
            probe.scene, o, d)
    pool = bounce_pool(probe)
    t, _, tri = intersect_scene_sweep(probe.scene, pool["origin"],
                                      pool["direction"], eps=cfg.eps,
                                      tile=tile)
    k2 = check_k2(probe.scene, pcfg, pool, t, tri, parity=True)
    k2_line(f"preview bounce pool {t.shape[0]} lanes", k2, card)
    rows.append(("shade[preview]", sk.SOURCE, sk.REPLACES,
                 counts["shade"][0], run, t.shape[0], *k2[1:5]))
    n = pcfg.width * pcfg.height
    k3 = check_k3(dev, npix=n, rows=n, retired=n // 4, device=False)
    print(f"K3 {n // 4} retired of {n} rows into {pcfg.width}x"
          f"{pcfg.height}: max|d| {k3[0]:.3g}, kernel {k3[1]:.4f} ms, "
          f"plain {k3[2]:.3f} ms, bound {k3[3][0]:.4f} ms ({k3[3][1]})",
          flush=True)
    rows.append(("flush[preview]", flush.SOURCE, flush.REPLACES,
                 counts["flush"][0], run, n, *k3[:3], k3[3], k3[4]))
    del probe, pool, o, d, t, tri
    parts["f"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (g) the command line at its defaults
    default_cli_runs(card)
    parts["g"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (h) card against CPU at shapes with the default's traits, every
    # kernel call of the card's render shadowed on the CPU
    for label, kw in DEFAULT_TRAITS:
        c = RenderConfig(**kw)
        out = []
        for device in (dev, "cpu"):
            r = ProgressiveRenderer(host, c, host_seed=3, device=device)
            # The shadows wrap the kernels' Python wrappers, which a
            # replayed graph does not call: the card runs the eager form.
            r._eager = True
            with (cpu_shadowed() if device == dev
                  else contextlib.nullcontext({})) as seen:
                r.step(2)
                r.rotate(1, 0.05)
                r.step(1)
                r.step(1)
                rad = r.radiance()
                img = r.image().cpu().numpy() if c.render_scale > 1 else None
            out.append((rad, img, r.total_rays, seen))
        (a, ia, ra, seen), (b, ib, rb, _) = out
        close = np.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
        line = (f"(h) {label} card vs CPU, step(2) rotate step(1) step(1): "
                f"{close.mean():.5f} of pixels close")
        if ia is not None:
            close_i = np.isclose(ia, ib, rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
            line += f" ({close_i.mean():.5f} of image() pixels)"
            assert close_i.mean() >= IMG_FRAC, f"{label}: images disagree"
        print(f"{line}, rays {ra:.0f} / {rb:.0f}; {seen['calls']} kernel "
              f"calls equal to the CPU's plain versions on their inputs, "
              f"{seen['diverged']} K2 lanes drawn otherwise by the device's "
              f"libm", flush=True)
        assert close.mean() >= IMG_FRAC, f"{label}: card and CPU disagree"
        # Rays may differ only by the paths of those lanes.
        assert abs(ra - rb) <= seen["diverged"] * c.max_depth, \
            f"{label}: ray counts differ"
    parts["h"] = time.perf_counter() - t_part
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; by part (s) "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}",
          flush=True)
    return rows


# Phase 12: the wavefront loop through its captured CUDA graphs against
# its eager form (module docstring): (label, scene, RenderConfig fields).
GRAPH_CONFIGS = (
    ("flagship 1024^2", "box", dict(width=1024, height=1024)),
    ("NEE + textured 1024^2", "textured",
     dict(width=1024, height=1024, nee=True)),
    ("outside 1024^2 (K4)", "outside", dict(width=1024, height=1024)),
    ("1920x1080", "box", {}),
)


def graph_stats(cache):
    """(captures, warm-ups, replays) of a GraphCache, or zeros without
    one."""
    return ((cache.captures, cache.warm_ups, cache.replays) if cache
            else (0, 0, 0))


def graph_session(host, cfg, dev, eager):
    """One form of a phase-12 session: step(1), step(2), step(2) and the
    drain, counted; then, after a camera reset, ``timed_steps`` and the
    busy share (tools/stages.py ``busy_share``).  Returns a dict."""
    from logipathtracer_tpu_torch import ProgressiveRenderer
    from logipathtracer_tpu_torch.render.graph import graph_cache
    from logipathtracer_tpu_torch.tools.stages import busy_share
    r = ProgressiveRenderer(host, cfg, host_seed=0, device=dev)
    r._eager = eager
    cache = None if eager else graph_cache(r.scene)
    reset_counts()
    before = graph_stats(cache)
    iters = []
    for n in (1, 2, 2):
        r.step(n)
        iters.append(r.last_iterations)
    frame = r._frame_sum().clone()           # drains the pool
    iters.append(r.last_iterations)
    counts = read_counts()
    modes = {k: modes_of(k) for k, v in COUNTERS.items() if v[3]}
    assert_no_plain()
    after = graph_stats(cache)
    rays = r.total_rays
    r.reset()
    sps, mrays, t_iters, _ = timed_steps(r)
    busy = busy_share(r)
    out = dict(frame=frame, rays=rays, iters=iters, counts=counts,
               modes=modes, sps=sps, mrays=mrays,
               ms_per_iteration=sum((2, 2)) / sps * 1e3 / sum(t_iters),
               busy=busy, stages=tuple(a - b for a, b in zip(after,
                                                             before)))
    if cache is not None:
        out.update(captures=cache.captures,
                   capture_s=cache.capture_seconds,
                   pool_mib=cache.capture_bytes / 2 ** 20)
    del r
    return out


def preview_frames(host, dev, eager, frames=12):
    """The 480x270 depth-4 preview with a camera turn before each frame
    (``tools/interactive.py``'s navigation): every frame's sum, the rays
    and the launch counts."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.tools.interactive import TURN
    r = ProgressiveRenderer(host, RenderConfig(width=480, height=270,
                                               max_depth=4),
                            host_seed=0, device=dev)
    r._eager = eager
    reset_counts()
    sums, rays = [], []
    for _ in range(frames):
        r.rotate(1, TURN)
        r.step(1)
        sums.append(r._frame_sum().clone())
        rays.append(r.total_rays)
    counts = read_counts()
    assert_no_plain()
    return sums, rays, counts


def graph_phase(dev, card):
    """Phase 12: the wavefront loop's iterations as replays of captured
    CUDA graphs (render/graph.py) against its eager form, bit for bit
    (module docstring)."""
    import gc

    from logipathtracer_tpu_torch import RenderConfig
    from logipathtracer_tpu_torch.parallel.mesh import (MeshRenderer,
                                                        make_mesh)
    from logipathtracer_tpu_torch.render.graph import graph_cache
    from logipathtracer_tpu_torch.render.wavefront import render_wavefront
    from logipathtracer_tpu_torch.tools import interactive

    t_phase = time.perf_counter()
    box = load_scene(None)
    scenes = {"box": lambda: box,
              "textured": lambda: load_scene(None, textured=True),
              "outside": outside_scene}
    # (a) sessions: flagship, NEE + textured, outside (K4), 1920x1080
    for label, scene_name, fields in GRAPH_CONFIGS:
        host = scenes[scene_name]()
        cfg = RenderConfig(**fields)
        e = graph_session(host, cfg, dev, eager=True)
        g = graph_session(host, cfg, dev, eager=False)
        gc.collect()
        assert torch.equal(g["frame"], e["frame"]), \
            f"{label}: graph and eager radiance differ"
        assert (g["rays"], g["iters"]) == (e["rays"], e["iters"]), \
            f"{label}: rays or iterations differ"
        assert (g["counts"], g["modes"]) == (e["counts"], e["modes"]), \
            f"{label}: launch counts differ: {g['counts']} {e['counts']}"
        for k in ("shade", "flush") + (
                ("stream_cluster",) if scene_name == "outside"
                else ("compact_intersect", "worklist_prepass")):
            assert g["counts"][k][0] > 0, f"{label}: never launched {k}"
        # Every iteration: one stage-A replay, one stage-B replay (a
        # first use is a warm-up run and a capture).
        assert sum(g["stages"][1:]) == 2 * sum(g["iters"]), g["stages"]
        print(f"(a) {label} graph vs eager, step(1) step(2) step(2) + "
              f"drain: radiance bit-equal, rays {g['rays']:.0f}, "
              f"iterations {g['iters']}, launches equal "
              f"{json.dumps(g['counts'])}; {g['stages'][0]} captures "
              f"({g['stages'][1]} of them warm-ups), {g['stages'][2]} "
              f"replays [{card}]", flush=True)
        for form, x in (("graph", g), ("eager", e)):
            b = x["busy"]
            print(f"    {form}: {x['sps']:.3f} samples/s, {x['mrays']:.2f} "
                  f"Mrays/s, {x['ms_per_iteration']:.3f} ms per iteration; "
                  f"busy {b['busy']:.3f} ({b['device_ms_per_iteration']:.3f}"
                  f" device ms per iteration of a profiled step(2) of "
                  f"{b['iterations']}, {b['wall_ms_per_iteration']:.3f} wall"
                  f" ms per iteration of three of {b['wall_iterations']})"
                  + (
                      f"; {x['captures']} graphs captured in "
                      f"{x['capture_s']:.3f} s, {x['pool_mib']:.1f} MiB "
                      f"reserved by the captures" if form == "graph" else "")
                  + f" [{card}]", flush=True)

    # (b) the 480x270 preview, a camera turn before every frame
    ge, gg = (preview_frames(box, dev, eager) for eager in (True, False))
    assert all(torch.equal(a, b) for a, b in zip(ge[0], gg[0])), \
        "preview: graph and eager frames differ"
    assert ge[1] == gg[1] and ge[2] == gg[2], "preview: rays or launches"
    print(f"(b) preview 480x270 depth 4, {len(ge[0])} frames each after a "
          f"camera turn: every frame bit-equal, rays {gg[1][-1]:.0f}, "
          f"launches equal {json.dumps(gg[2])}", flush=True)

    # (c) render_wavefront: a frame, then another camera and field of
    # view replayed, against the eager form at that camera
    cfg = RenderConfig(width=1024, height=1024)
    scene = box.to(dev)
    cam = torch.from_numpy(np.asarray(box.cameras[0].world_matrix,
                                      np.float32)).to(dev)
    fov = float(box.cameras[0].yfov)
    seeds = torch.tensor([[5, 7]], device=dev)
    render_wavefront(scene, cfg, cam, fov, seeds)
    moved = cam.clone()
    moved[:3, 3] += 0.05
    cache = graph_cache(scene)
    before = graph_stats(cache)
    reset_counts()
    g = render_wavefront(scene, cfg, moved, fov * 0.9, seeds)
    g_counts = read_counts()
    after = graph_stats(cache)
    reset_counts()
    e = render_wavefront(scene, cfg, moved, fov * 0.9, seeds, _eager=True)
    assert torch.equal(g[0], e[0]) and g[1:] == e[1:], \
        "render_wavefront: graph and eager differ"
    assert g_counts == read_counts(), "render_wavefront: launches differ"
    assert after[0] == before[0] and after[2] - before[2] == 2 * g[2], \
        "render_wavefront: a moved camera captured again"
    print(f"(c) render_wavefront 1024^2 1 spp, camera and field of view "
          f"moved: bit-equal to the eager form, rays {g[1]}, iterations "
          f"{g[2]}, {after[2] - before[2]} replays and no capture",
          flush=True)
    del scene, cache

    # (d) a 1x1 mesh on the card, graph against eager
    sums = []
    for eager_form in (True, False):
        m = MeshRenderer(box, RenderConfig(width=512, height=512),
                         make_mesh([dev]), host_seed=4)
        m._eager = eager_form
        m.step(1)
        m.step(1)
        sums.append((m._frame_sum().clone(), m.total_rays))
    assert torch.equal(sums[0][0], sums[1][0]) and sums[0][1] == sums[1][1]
    assert graph_cache(m.scene).replays > 0, "the mesh replayed no graph"
    print(f"(d) 1x1 mesh 512^2, two rounds: graph bit-equal to eager, "
          f"{graph_cache(m.scene).replays} replays", flush=True)
    del m

    # (e) the interactive session, tools/interactive.py, both ways
    fps = {}
    for loop, flag in (("graphs", []), ("eager", ["--eager"])):
        fps[loop], _ = interactive.run(interactive.parse_args(flag))
    for loop, rep in fps.items():
        nav, acc = rep["navigate_1spp"], rep["converge_accum"]
        print(f"(e) interactive ({loop}): navigate "
              f"{rep['preview_resolution']} depth {rep['preview_depth']} "
              f"{nav['fps_mean']:.3f} fps mean, {nav['frame_ms_median']:.3f}"
              f" ms median; converge {rep['resolution']} "
              f"{acc['fps_mean']:.3f} fps mean, {acc['frame_ms_median']:.3f}"
              f" ms median, {acc['samples_per_sec']:.3f} samples/s; warm-up "
              f"{rep['warmup_s']:.3f} s [{card}]", flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None,
                    help="glTF scene (default: procedural box)")
    args = ap.parse_args(argv)

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    # The package comes first: a copy of this script without the rest
    # of the repository fails here, before printing anything.
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_all(("compact_intersect", "shade", "flush", "stream_cluster",
                     "stream_chunk", "cluster_sweep"))
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(_build.BUILD_SECONDS)}", flush=True)

    t0 = time.perf_counter()
    host_scene = load_scene(args.scene)
    cfg = RenderConfig(width=1024, height=1024)
    print(f"scene: {host_scene.num_triangles} triangles, "
          f"{host_scene.num_objects} objects, "
          f"{host_scene.cl_tris.shape[0]} clusters "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 3. kernels vs plain at main-path shapes --------------------------
    probe = ProgressiveRenderer(host_scene, cfg, host_seed=1, device=dev)
    scene = probe.scene
    tile = cfg.compact_tile
    o, d, _ = primary_pool(probe)
    k1p = check_k1(scene, o, d, tile, cfg.eps)
    print_k1(f"primary pool {o.shape[0]} rays, hit {k1p[3]:.3f}", k1p, card)
    pool = bounce_pool(probe)
    k1b = check_k1(scene, pool["origin"], pool["direction"], tile, cfg.eps)
    print_k1(f"bounce pool ({int(pool['alive'].sum())} alive)", k1b, card)
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    t, _, tri = intersect_scene_sweep(scene, pool["origin"],
                                      pool["direction"], eps=cfg.eps,
                                      tile=tile)
    k2 = check_k2(scene, cfg, pool, t, tri, parity=True)
    k2_line(f"parity {pool['alive'].shape[0]} lanes", k2, card)
    k2t = check_k2(scene, cfg, pool, t, tri, parity=False, runs=(3, 1))
    k2_line("threefry (plain once)", k2t)
    k3 = check_k3(dev)
    print(f"K3 2^18 retired of 2^20 rows into 1024^2: max|d| {k3[0]:.3g}, "
          f"bit-identical repeat, events around one call: kernel "
          f"{k3[1]:.4f} ms, index_add_ {k3[4]:.4f} ms; device time "
          f"(profiler, {DEVICE_RUNS} calls): kernel {k3[5][0]:.4f} ms, "
          f"index_add_ {k3[6][0]:.4f} ms; {DEVICE_RUNS} calls back to "
          f"back: kernel {k3[5][1]:.4f} ms, index_add_ {k3[6][1]:.4f} ms "
          f"per call, issued in {k3[5][2]:.1f} / {k3[6][2]:.1f} µs of host "
          f"time each; plain {k3[2]:.3f} ms, bound {k3[3][0]:.4f} ms "
          f"({k3[3][1]}) [{card}]", flush=True)
    del probe, pool

    # ---- 4. the main path ----------------------------------------------
    renderer = ProgressiveRenderer(host_scene, cfg, host_seed=0, device=dev)
    reset_counts()
    sps, mrays, iters, rad = timed_steps(renderer)
    counts = read_counts(FLAGSHIP)
    assert rad.shape == (1024, 1024, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k, (launched, plain) in counts.items():
        assert launched > 0, f"main path never launched kernel {k}"
    assert_no_plain()
    print(f"main path 1024x1024 spp 4: {sps:.3f} samples/s, "
          f"{mrays:.2f} Mrays/s, iterations per chunk {iters}, "
          f"mean radiance {mean:.6f} [{card}]", flush=True)
    print(f"launches: {json.dumps(counts)}", flush=True)
    flagship_rate = (sps, mrays)
    flagship_iters = iters
    del renderer

    # ---- 8e. beside it: the flagship wavefront through K7 ----------------
    wavefront_k7(host_scene, cfg, dev, card, flagship_rate)

    # ---- 5. card vs CPU image ------------------------------------------
    small = RenderConfig(width=64, height=64, pool_size=4096)
    img_gpu, _ = render_radiance(host_scene, small, dev, 7, (2, 2))
    img_cpu, _ = render_radiance(host_scene, small, "cpu", 7, (2, 2))
    close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(-1)
    print(f"card vs CPU 64x64 2+2 spp: {close.mean():.5f} of pixels close",
          flush=True)
    assert close.mean() >= IMG_FRAC, "card and CPU renders disagree"

    # ---- 6. textured + NEE path -----------------------------------------
    nee = nee_phase(dev, card, flagship_rate)

    # ---- 7. outside-class path (streamed clusters) ----------------------
    outside = outside_phase(dev, card)

    # ---- 8. the megakernel renderer (K7, K8, the BVH walk) ---------------
    order_rows = megakernel_phase(dev, card)

    # ---- 9. the basic BSDF and the command line --------------------------
    basic_phase(dev, card, flagship_rate)

    # ---- 10. render_wavefront and the device mesh -------------------------
    single_shot_phase(dev, card, flagship_rate)

    # ---- 11. the default configuration, 1920x1080 -------------------------
    default_rows = default_config_phase(dev, card,
                                        (*flagship_rate, flagship_iters))

    # ---- 12. the wavefront loop's CUDA graphs against its eager form ------
    graph_phase(dev, card)

    from logipathtracer_tpu_torch.ops.kernels import (compact_intersect,
                                                      flush, shade,
                                                      tex_prologue)
    k1_any = "logipathtracer_tpu/ops/pallas/compact_intersect.py:243"
    pool = 1 << 20          # rays, lanes or rows of phases 3 and 6's checks
    main_run, nee_run = "1024^2 main path", "1024^2 NEE main path"

    def row(name, src, where, launched, run, n_pool, err, k_ms, p_ms, b,
            lib_ms=None):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": where, "launches": launched, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib_ms, "run": run,
                "pool": n_pool}

    rows = [
        row("compact_intersect", compact_intersect.SOURCE,
            compact_intersect.REPLACES, counts["compact_intersect"][0],
            main_run, pool, *k1p[:3], k1p[4]),
        row("compact_intersect[bounce]", compact_intersect.SOURCE,
            compact_intersect.REPLACES, counts["compact_intersect"][0],
            main_run, pool, *k1b[:3], k1b[4]),
        row("compact_intersect[tmax+any_hit]", compact_intersect.SOURCE,
            k1_any, nee["modes"]["any_hit"], nee_run, pool, *nee["k1"]),
        row("compact_intersect[worklist]", compact_intersect.SOURCE,
            compact_intersect.PREPASS_REPLACES,
            counts["worklist_prepass"][0], main_run, pool, *k1p[5]),
        row("compact_intersect[worklist tmax]", compact_intersect.SOURCE,
            compact_intersect.PREPASS_REPLACES, nee["prepass"], nee_run,
            pool, *nee["worklist"]),
        row("shade", shade.SOURCE, shade.REPLACES, counts["shade"][0],
            main_run, pool, *k2[1:5]),
        row("shade[tex+nee]", shade.SOURCE, shade.REPLACES,
            nee["modes"]["tex+nee"], nee_run, pool, *nee["k2"][1:5]),
        row("flush", flush.SOURCE, flush.REPLACES, counts["flush"][0],
            main_run, pool, *k3[:3], k3[3], k3[4]),
    ]
    rows[-1].update(device_ms=k3[5][0], library_device_ms=k3[6][0])
    tex = nee["tex"]
    rows.append(row("tex_prologue", tex_prologue.SOURCE,
                    tex_prologue.REPLACES, nee["tex_launches"], nee_run,
                    pool, *tex[:4]))
    rows[-1].update(device_ms=tex[4], bound_ms_sectors=tex[7],
                    scene="the PBR cell's, full size")
    # r: check_isect's (max |dt|, ms, plain ms, fraction, bound, pool)
    rows += [row(n, src, where, launched, run, r[5], *r[:3], r[4])
             for n, src, where, launched, run, r in outside + order_rows]
    rows += [row(*r) for r in default_rows]
    # Beside the contract's keys: "run", the run whose launches are
    # counted, and "pool", the rays (lanes, rows) that max_abs_err, ms,
    # plain_ms and the bound were measured on; on K3's, the device times
    # of device_ms; on the texture prologue's, its device time, its
    # bound with a 32-B sector a texel and the scene its pool came from.
    # The worklist rows' plain_ms is the plain version on the card, the
    # prepass the earlier route ran.
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
