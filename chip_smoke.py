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
     and no plain version;
     (d) the 64x64 card-vs-CPU render of 5 on this path;
  7. the outside-class path, scenes beyond the resident budget that
     stream cluster blocks: ``make_outside_scene()`` (394,242 triangles,
     51 objects, 1,233 clusters of 512) with the default RenderConfig,
     which routes it to K4 — (a) K4, K5 and K6 (cap 0 and cap > 0
     bodies) against their plain versions on the whole 2^20-ray primary
     pool; K4 and K5 on a bounce pool, and K4 in its t_max / any-hit
     mode on the shadow pool of one NEE step, on as many tiles of those
     pools as the plain version covers in about 15 s (BOUNCE_TILES,
     SHADOW_TILES), and timed on the whole pool too.  K4 and K5 (the
     compacted visit) must equal their plain versions bit for bit (t,
     tri and obj; t alone in any-hit), K6 agree under hits_agree.  The
     count pass of each check prints what the compacted visit rests on:
     the mean worklist length, the share of listed clusters that some
     ray of a 256-ray block passes, and the cluster blocks staged per
     launch by the one-thread-per-ray ring (every listed cluster, per
     256-ray block) and by the kernel (what its blocks pass, or may
     pass ahead with the prefetch); (b) the main path at 1024x1024,
     timed as in 4, which must run K4, K2 and K3, never K1 and no plain
     version; (c) one 1024x1024 step(1) on each other route
     (``stream_granularity="chunk"``: K5; ``stream_worklist=False``: K6
     cap > 0; ``stream_compact=False``: K6 cap 0), each launching its
     kernel, and the NEE route (``nee=True``: K4 any-hit) timed as in
     4; (d) the 64x64 card-vs-CPU render of 5 on this path;
  8. the lockstep megakernel renderer (``renderer="megakernel"``) on the
     flagship box — (a) K7 (``compact_worklist=False``) and K8
     (``intersect="sweep"``) against their plain versions on the
     megakernel's 2^20-ray primary pool (camera rays in each route's
     block-major order, sorted by coherence key) and on its bounce pool
     after one bounce; K7 in its t_max / any-hit mode and K8 in its t_max
     mode on that bounce's NEE shadow pool (and K7's plain version
     once more before and after its check, without the count pass, to
     show what that pass costs); (b) the megakernel main path
     at 1024x1024 through the worklist kernel, K1 and K2, timed as in 4;
     (c) one 1024x1024
     step(1) on each other route (K7, K7 any-hit with NEE, K8, K8 t_max
     with NEE), each launching its kernel; (d) the BVH walk at 512x512,
     one step(1); (e) beside phase 4, in the same call: the flagship
     wavefront with ``compact_worklist=False`` (K7, no per-ray prepass),
     timed the same way; (f) the 64x64 card-vs-CPU render of 5 on the
     megakernel through K1, K8 and K7.

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
over the plain version's run on the same pool (``counted``): SLAB_OPS
per slab test it made and MT_OPS per ray-triangle test its rays' own
slab passes imply — S per pass, less, with any_hit, the tests after the
first accepted triangle (``any_hit_saved``).  The worklist kernel makes
WORLD_SLAB_OPS per (ray, box) slab test, every ray against every box as
its plain version does.  K3 moves 4 bytes of pixel id per row, 12 of
radiance per retired row and a read and a write of each pixel it
flushes.  ``library_ms`` is the time of one PyTorch call that computes
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
    bounce_pool, device_ms, event_ms, make_tail, primary_pool, runner,
    scene_tables, shadow_pool, timed_steps)

# Tolerances.  K1, K4 and K5 (the compacted visit) must equal their
# plain versions bit for bit; K2 and K6-K8 use the rules kept beside
# their kernels (compact_intersect.hits_agree: t within rtol 2e-6 / atol
# 1e-6, tri/obj differing only on t ties; shade.shade_agreement: at most
# 0.5% of lanes with another seed or alive flag, floats close on the
# rest).
K3_RTOL, K3_ATOL = 1e-6, 1e-6           # f32 reassociation

# Bounds (module docstring).  Operation counts, a divide or a compare
# counted as one: a slab test is 64, the local ray (33), three
# reciprocals (3) and the slab table (28: 12 for the six plane
# distances, 10 for t0 and t1, 6 compares); a ray-triangle test is
# Möller–Trumbore with its acceptance (52).  K2 is given a floor of 200 per alive lane (hit
# point, barycentrics, normal, frame, one BSDF sample, Russian roulette;
# the Heitz walk's further orders are not counted); K3 one add per
# retired channel.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SLAB_OPS, MT_OPS, K2_OPS = 64, 52, 200
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


@contextlib.contextmanager
def counted(block=256, prefetch=False, chunk=16):
    """The count pass: the plain intersect versions run in the block with
    every cluster visit's lanes observed (``PlainSweep.lanes``).  The
    dict it yields holds, after the block, "slab": the slab tests made
    (each visit's lanes, within its gate), and "own": the lanes whose own
    slab test passed; and, per visit of a cluster by a tile, "listed":
    the 256-ray blocks that visit it (within the gate), "passed": those
    with some own pass, and "staged": the ``block``-ray blocks whose
    compacted visit stages the cluster (closest_hit.cuh compact_visit) —
    some own pass, or with ``prefetch`` some pass ahead: the slab against
    the best before the previous cluster of the same visit (the first
    cluster of a tile, or of a ``chunk``-cluster chunk behind a gate, is
    staged on an own pass).  The sums stay on the device until the block
    ends: no host read per visit."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    plain = ci.PlainSweep
    slab, gated, own = [0], [], []
    listed, passed, staged = [], [], []
    last = {}

    class Counting(plain):
        def lanes(self, sl, c, gate=None):
            lo, ld, hit = super().lanes(sl, c, gate)
            if gate is None:
                slab[0] += hit.numel()
            else:
                gated.append(gate.sum())
            own.append(hit.sum())
            if not isinstance(sl, slice) or hit.numel() % max(block, 256):
                return lo, ld, hit          # not a tile of K1, K4 or K5
            g = torch.ones_like(hit) if gate is None else gate
            listed.append(g.reshape(-1, 256).any(dim=1).sum())
            passed.append(hit.reshape(-1, 256).any(dim=1).sum())
            key = (id(self), sl.start)
            ahead = hit
            if prefetch and last.get("key") == key and not (
                    gate is not None and c % chunk == 0):
                ahead = ci._slab_table(lo, [1.0 / x for x in ld],
                                       self.aabb[c], last["best"]) & g
            staged.append(ahead.reshape(-1, block).any(dim=1).sum())
            last.update(key=key, best=self.best_t[sl].clone())
            return lo, ld, hit

    work = {}
    ci.PlainSweep = Counting
    try:
        yield work
    finally:
        ci.PlainSweep = plain
    total = lambda xs: int(torch.stack(xs).sum()) if xs else 0
    work["slab"] = slab[0] + total(gated)
    work["own"] = total(own)
    work.update(listed=total(listed), passed=total(passed),
                staged=total(staged))


def plain_work(plain, **staging):
    """(result, ms, work) of one plain intersect call, timed, with its
    count pass (``staging``: ``counted``'s block and prefetch)."""
    with counted(**staging) as work:
        out, ms = _time_once(plain)
    return out, ms, work


def any_hit_saved(rays8, tri, obj, tables, eps):
    """Triangle tests that any-hit lanes skip: the kernels stop at the
    first accepted slot j of the cluster that blocks a lane
    (closest_hit.cuh closest_in_cluster), so that visit makes j + 1
    tests, not S.  Summed over the lanes the plain result blocks (tri >=
    0).  The blocking cluster is the one of the lane's object with the
    largest triangle base <= tri; the best t at that visit is still the
    initial one, min(t_max, BIG)."""
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
    operations (``saved`` triangle tests fewer), its inputs read once and
    (t, tri, obj) written once."""
    s = scene.cl_tris.shape[2]
    ops = work["slab"] * SLAB_OPS + (work["own"] * s - saved) * MT_OPS
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
    bound))."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
    rays8, _ = ci.pack_rays8(origin, direction, tile)
    wmin, wmax = scene_cluster_bounds(scene)
    wl, wn, *wrow = check_worklist(wmin, wmax, rays8, tile)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb,
            scene.cl_tris, tile, eps)
    got = ci.compact_wl_intersect(*args)
    ref, _, work = plain_work(lambda: ci.compact_wl_intersect_plain(*args))
    for name, g, p in zip(("t", "tri", "obj"), got, ref):
        assert torch.equal(g, p), f"K1: {name} differs from the plain version"
    err = float((got[0] - ref[0]).abs().max())
    hit_frac = float((ref[0] < ci.BIG).float().mean())
    k_ms = event_ms(lambda: ci.compact_wl_intersect(*args), runs[0])
    p_ms = event_ms(lambda: ci.compact_wl_intersect_plain(*args), runs[1])
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
    texture / NEE inputs.  runs[1] == 1 times the plain version once,
    on the very call that is compared.  Returns (diverged, max err,
    kernel ms, plain ms, bound)."""
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    args = (scene.tri_shade, pool["origin"], pool["direction"], pool["acc"],
            pool["mask"], pool["alive"], pool["seed"], pool["bounce"], t,
            tri)
    kw = dict(env=cfg.env_color, rr_threshold=cfg.rr_threshold,
              rr_bounces=cfg.rr_bounces, max_order=cfg.heitz_max_order,
              parity=parity, **(opt or {}))
    got = sk.shade(*args, **kw)
    ref, p_once = _time_once(lambda: sk.shade_plain(*args, **kw))
    diverged, err = sk.shade_agreement([x.cpu() for x in ref],
                                       [x.cpu() for x in got])
    k_ms = event_ms(lambda: sk.shade(*args, **kw), runs[0])
    p_ms = (p_once if runs[1] <= 1 else
            event_ms(lambda: sk.shade_plain(*args, **kw), runs[1]))
    b = bound(K2_OPS * int(pool["alive"].sum()),
              nbytes(*args, *(opt or {}).values(), *got))
    return diverged, err, k_ms, p_ms, b


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


def check_k3(dev, npix=1 << 20, rows=1 << 20, retired=1 << 18, runs=(10, 3)):
    """K3 against its plain version; returns (max err, kernel ms, plain
    ms, bound, ms of ``index_add_`` of the retired rows into the same
    accumulator, ``device_ms`` of K3, the same of ``index_add_``)."""
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
    k_dev = device_ms(lambda: flush.flush_sorted(work, pix, acc), DEVICE_RUNS)
    lib_dev = device_ms(lambda: work.index_add_(0, pix_r, acc_r), DEVICE_RUNS)
    flushed = int(torch.unique(pix_r).numel())
    b = bound(3 * retired, 4 * rows + 12 * retired + 24 * flushed)
    return err, k_ms, p_ms, b, lib_ms, k_dev, lib_dev


def render_radiance(scene, cfg, dev, host_seed, chunks):
    from logipathtracer_tpu_torch import ProgressiveRenderer
    r = ProgressiveRenderer(scene, cfg, host_seed=host_seed, device=dev)
    for n in chunks:
        r.step(n)
    return r.radiance(), r


def nee_phase(dev, card, flagship_rate):
    """Phase 6: the textured + NEE path (module docstring).  Returns the
    K1 any-hit and K2 tex+nee rows (max err, kernel ms, plain ms) and the
    main path's launches by mode."""
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
    print(f"K2 tex+nee parity {t.shape[0]} lanes: diverged {k2[0]:.5f}, "
          f"max|d| {k2[1]:.3g}, kernel {k2[2]:.3f} ms, plain {k2[3]:.1f} ms "
          f"(once)", flush=True)
    k2t = check_k2(scene, cfg, pool, t, tri, parity=False, runs=(3, 1),
                   opt=opt)
    print(f"K2 tex+nee threefry: diverged {k2t[0]:.5f}, max|d| "
          f"{k2t[1]:.3g}, kernel {k2t[2]:.3f} ms, plain {k2t[3]:.1f} ms "
          f"(once)", flush=True)
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
    print(f"K2 on a {small.num_triangles}-triangle scene (tri_sel class), "
          f"{n} lanes: diverged {k2s[0]:.5f}, max|d| {k2s[1]:.3g}, kernel "
          f"{k2s[2]:.3f} ms, plain {k2s[3]:.1f} ms (once), bound "
          f"{k2s[4][0]:.4f} ms ({k2s[4][1]})", flush=True)
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
          f"{json.dumps(modes)} in {n_it} iterations", flush=True)
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
    return {"k1": (*k1[:3], k1[5]), "worklist": k1[6], "k2": k2[1:],
            "modes": modes, "prepass": counts["worklist_prepass"][0]}


# Phase 7: K4, K5 and K6 are held against their plain versions on the
# whole 2^20-ray primary pool.  The plain versions loop over tiles and
# clusters on the host; on bounce and shadow rays they take far longer
# per tile (K4 plain: 55 s on 128 bounce tiles, 59 s on 64 shadow tiles,
# H100 80GB HBM3, 700 W), so those pools are cut to the tiles that
# finish in about 15 s, spread over the pool's live tiles.
BOUNCE_TILES = 32                       # 2^17 rays
SHADOW_TILES = 16                       # 2^16 rays


def sub_pool(rays8, tile, n_live, tiles):
    """``tiles`` whole tiles of rays8, evenly spread over the tiles that
    hold the first ``n_live`` lanes."""
    total = rays8.shape[1] // tile
    n = min(tiles, total)
    live = min(total, max(-(-n_live // tile), n))
    pick = torch.linspace(0, live - 1, n).round().long()
    idx = (pick[:, None] * tile + torch.arange(tile)).reshape(-1)
    return rays8[:, idx.to(rays8.device)].contiguous()


def staging(kind, r, tile):
    """The count pass's ``staging`` for K4 or K5 on an R-ray pool: the
    block and prefetch of its compacted visit (K4 gates then loads,
    csrc/stream_cluster.cu; K5 prefetches, csrc/stream_chunk.cu); {} for
    the others."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    if kind not in ("K4", "K5"):
        return {}
    return dict(block=ci._block_threads(r, tile, kind),
                prefetch=kind == "K5")


def check_isect(kind, scene, rays8, tile, runs=10, **kw):
    """An intersect kernel against its plain version on one packed pool:
    K4 and K5 (the compacted visit) bit for bit — t, tri and obj; t alone
    with any_hit — the others under hits_agree, with any_hit the
    visibility t < t_max on every lane.  Returns (max |dt|, kernel ms
    (median of ``runs``), plain ms (once), hit or blocked fraction,
    bound, visits), all on that pool; visits (K4, K5): the count pass's
    listed / passed / staged block visits and the mean worklist length
    "wn", else None."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    kernel, plain, inputs, wn = runner(kind, scene, rays8, tile, **kw)
    got = kernel()
    stage = staging(kind, rays8.shape[1], tile)
    ref, p_ms, work = plain_work(plain, **stage)
    exact = bool(stage)
    saved = 0
    if kw.get("any_hit"):
        saved = any_hit_saved(rays8, ref[1], ref[2], scene_tables(scene),
                              1e-4)
        t_max = rays8[6]
        bad = int(((got[0] < t_max) != (ref[0] < t_max)).sum())
        assert bad == 0, f"{kind} any-hit: visibility differs on {bad} lanes"
        assert not exact or torch.equal(got[0], ref[0]), \
            f"{kind} any-hit: t differs from the plain version"
        err = float((got[0] - ref[0]).abs().max())
        live = rays8[0] < 1e29
        frac = float((got[0] < t_max)[live].float().mean())
    elif exact:
        for name, g, p in zip(("t", "tri", "obj"), got, ref):
            assert torch.equal(g, p), \
                f"{kind}: {name} differs from the plain version"
        err = float((got[0] - ref[0]).abs().max())
        frac = float((ref[1] >= 0).float().mean())
    else:
        err = ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
        frac = float((ref[1] >= 0).float().mean())
    b = isect_bound(work, scene, inputs, rays8.shape[1], saved)
    visits = None
    if exact:
        visits = {k: work[k] for k in ("listed", "passed", "staged")}
        visits.update(wn=float(wn.float().mean()), **stage)
    return err, event_ms(kernel, runs), p_ms, frac, b, visits


def print_visits(kind, what, visits, s):
    """The numbers the compacted visit rests on (check_isect's visits):
    the mean worklist, the share of listed clusters some ray of a 256-ray
    block passes, and the cluster blocks (9 x S floats each) staged per
    launch by the one-thread-per-ray ring — every listed cluster, per
    256-ray block — and by the kernel."""
    blk = 36 * s
    v = visits
    unit = "chunks" if kind == "K5" else "clusters"
    print(f"{kind} {what}: mean worklist {v['wn']:.1f} {unit}; "
          f"{v['listed']} (256-ray block, cluster) visits listed, "
          f"{v['passed'] / max(v['listed'], 1):.4f} of them passed by some "
          f"ray of the block; staged per launch: {v['listed'] * blk / 1e9:.3f}"
          f" GB by the one-thread-per-ray ring, {v['staged'] * blk / 1e9:.3f}"
          f" GB by the kernel ({v['block']}-ray blocks, prefetch "
          f"{v['prefetch']})", flush=True)


def outside_phase(dev, card):
    """Phase 7: the outside-class path (module docstring).  Returns the
    kernel rows (name, source, replaces, launches, run, result of
    check_isect and pool)."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.render.megakernel import \
        resolve_intersect_mode
    from logipathtracer_tpu_torch.scene.procedural import make_outside_scene

    t_phase = time.perf_counter()
    host = compile_scene(make_outside_scene())
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
            print_visits(kind, f"{key} pool {rays8.shape[1]} rays", r[5], s)
        return r

    probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    scene = probe.scene
    o, d, _ = primary_pool(probe)
    full8, _ = ci.pack_rays8(o, d, tile)
    for kind in ("K4", "K5", "K6[cap=0]", "K6[cap>0]"):
        err, k_ms, p_ms, frac, b, _ = check(kind, kind, full8)
        print(f"{kind} primary pool {full8.shape[1]} rays: "
              f"{'bit-equal, ' if kind in ('K4', 'K5') else ''}max|dt| "
              f"{err:.3g}, hit {frac:.3f}, kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms (once), bound {b[0]:.4f} ms ({b[1]})",
              flush=True)
    pool = bounce_pool(probe)
    n_alive = int(pool["alive"].sum())
    full8, _ = ci.pack_rays8(pool["origin"], pool["direction"], tile)
    sub8 = sub_pool(full8, tile, n_alive, BOUNCE_TILES)
    for kind in ("K4", "K5"):
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
    shadow = dict(has_tmax=True, any_hit=True)
    full8, _ = ci.pack_rays8(so, sd, tile, t_max=t_max)
    k_full = event_ms(runner("K4", scene, full8, tile, **shadow)[0], 10)
    sub8 = sub_pool(full8, tile, n_alive, SHADOW_TILES)
    err, k_ms, p_ms, frac, b, _ = check("K4 any_hit", "K4", sub8, **shadow)
    print(f"K4 t_max+any-hit shadow pool ({n_alive} lanes alive): kernel "
          f"{k_full:.3f} ms on {full8.shape[1]} lanes; on {sub8.shape[1]} "
          f"lanes the plain t on every lane, {frac:.3f} blocked, max|dt| "
          f"{err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms (once), "
          f"bound {b[0]:.4f} ms ({b[1]}) [{card}]", flush=True)
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

    # (c) one step(1) at full width on each other route, and the NEE
    # route timed as the main path
    for label, kw, name, mode in (
            ("K5", dict(stream_granularity="chunk"), "worklist_chunk",
             "closest"),
            ("K6[cap>0]", dict(stream_worklist=False), "octant_chunk",
             "cap/closest"),
            ("K6[cap=0]", dict(stream_compact=False), "octant_chunk",
             "cap0/closest")):
        r = ProgressiveRenderer(host, cfg.replace(**kw), host_seed=2,
                                device=dev)
        reset_counts()
        t0 = time.perf_counter()
        r.step(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n_it = modes_of(name)[mode], r.last_iterations
        assert n > 0, f"{kw}: kernel {label} never launched"
        assert_no_plain()
        launches[label] = (n, f"{cfg.width}^2 step(1) " + " ".join(
            f"{k}={v}" for k, v in kw.items()))
        rad = r.radiance()                  # drains the pool
        assert np.isfinite(rad).all() and rad.mean() > 1e-3
        print(f"route {json.dumps(kw)} {cfg.width}x{cfg.height} step(1): "
              f"{label} launched {n} times in {n_it} iterations, "
              f"{wall:.3f} s, mean radiance after the drain "
              f"{float(rad.mean()):.6f}", flush=True)
        del r
    r = ProgressiveRenderer(host, cfg.replace(nee=True), host_seed=0,
                            device=dev)
    reset_counts()
    sps_nee, mrays_nee, iters, rad = timed_steps(r)
    n = modes_of("stream_cluster")["any_hit"]
    assert n > 0, "the NEE route never launched K4 any-hit"
    assert_no_plain()
    assert np.isfinite(rad).all() and 1e-3 < float(rad.mean()) < 10.0
    launches["K4 any_hit"] = (n, f"{cfg.width}^2 NEE route")
    print(f"outside NEE route {cfg.width}x{cfg.height} spp 4: "
          f"{sps_nee:.3f} samples/s, {mrays_nee:.2f} Mrays/s (path rays), "
          f"iterations per chunk {iters}, K4 any-hit launched {n} times in 5 "
          f"samples, mean radiance {float(rad.mean()):.6f} [{card}]",
          flush=True)
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
                ("octant_chunk[cap>0]", k6.SOURCE, k6.REPLACES_CAP,
                 "K6[cap>0]", "K6[cap>0]"))]


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


def megakernel_pools(renderer, seed_xy=(48271, 16807)):
    """The megakernel's intersect inputs at the renderer's size: the
    primary pool (every pixel's camera ray in the route's block-major
    order, sorted by coherence key as sorted_intersect sorts them), the
    pool of the second bounce (dead lanes parked, sorted) and that
    bounce's NEE shadow pool (shadow rays in pixel order, through the
    unsorted closure as trace_rays casts them).  Each is (origin,
    direction[, t_max])."""
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.render import megakernel as mk
    cfg, dev, scene = renderer.config, renderer.device, renderer.scene
    pix, _ = mk.block_pixels(cfg, scene, 0, cfg.render_height, dev)
    cam = torch.from_numpy(renderer.camera_world).to(dev)
    o, d, seed = mk.camera_rays(cfg, cam, renderer.fov_y,
                                torch.tensor(seed_xy, device=dev), pix)
    o, d = o.contiguous(), d.contiguous()

    def in_key_order(o, d):
        _, perm = torch.sort(mk.ray_sort_key(scene, o, d), stable=True)
        return o[perm].contiguous(), d[perm].contiguous()

    isect = mk.pick_intersect(cfg, scene)
    n = o.shape[0]
    t, obj, tri = mk.sorted_intersect(isect, scene, o, d, cfg.eps)
    o1, d1, acc, mask, alive, seed, prev = mk.shade_step(
        scene, cfg, o, d, torch.zeros_like(o), torch.ones_like(o),
        torch.ones(n, dtype=torch.bool, device=dev), seed, 0, t, obj, tri)
    oi = torch.where(alive[:, None], o1, 1e30)
    di = torch.where(alive[:, None], d1, 1.0)
    t, obj, tri = mk.sorted_intersect(isect, scene, oi, di, cfg.eps)
    out = sk.shade(scene.tri_shade, o1, d1, acc, mask, alive, seed,
                   torch.ones(n, dtype=torch.int32, device=dev), t, tri,
                   env=cfg.env_color, rr_threshold=cfg.rr_threshold,
                   rr_bounces=cfg.rr_bounces, max_order=cfg.heitz_max_order,
                   parity=cfg.parity_rng, light_tris=scene.light_tris,
                   light_cdf=scene.light_cdf, prev_pdf=prev,
                   nee_mis=cfg.nee_mis,
                   total_light_area=float(scene.total_light_area))
    return (in_key_order(o, d), in_key_order(oi, di),
            (out[7].contiguous(), out[8].contiguous(), out[9].contiguous()),
            int(alive.sum()))


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
            what = ("blocked" if t_max else "hit")
            print(f"{kind} megakernel {pool} pool {rays8.shape[1]} rays"
                  + (f" ({n_alive} alive)" if pool == "bounce" else "")
                  + (f" {json.dumps(kw)}" if kw else "")
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
                ("compact_order[tmax+any_hit]", ci.ORDER_SOURCE,
                 ci.ORDER_REPLACES, "K7 any_hit", "K7", "shadow"),
                ("dense_sweep", k8.SWEEP_SOURCE, k8.SWEEP_REPLACES, "K8",
                 "K8", "primary"),
                ("dense_sweep[tmax]", k8.SWEEP_SOURCE, k8.SWEEP_REPLACES,
                 "K8 tmax", "K8", "shadow"))]
    return rows


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
    print(f"K2 parity {pool['alive'].shape[0]} lanes: diverged "
          f"{k2[0]:.5f}, max|d| {k2[1]:.3g}, kernel {k2[2]:.3f} ms, "
          f"plain {k2[3]:.1f} ms", flush=True)
    k2t = check_k2(scene, cfg, pool, t, tri, parity=False, runs=(3, 1))
    print(f"K2 threefry: diverged {k2t[0]:.5f}, max|d| {k2t[1]:.3g}, "
          f"kernel {k2t[2]:.3f} ms", flush=True)
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

    from logipathtracer_tpu_torch.ops.kernels import (compact_intersect,
                                                      flush, shade)
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
            main_run, pool, *k2[1:]),
        row("shade[tex+nee]", shade.SOURCE, shade.REPLACES,
            nee["modes"]["tex+nee"], nee_run, pool, *nee["k2"]),
        row("flush", flush.SOURCE, flush.REPLACES, counts["flush"][0],
            main_run, pool, *k3[:3], k3[3], k3[4]),
    ]
    rows[-1].update(device_ms=k3[5][0], library_device_ms=k3[6][0])
    # r: check_isect's (max |dt|, ms, plain ms, fraction, bound, pool)
    rows += [row(n, src, where, launched, run, r[5], *r[:3], r[4])
             for n, src, where, launched, run, r in outside + order_rows]
    # Beside the contract's keys: "run", the run whose launches are
    # counted, and "pool", the rays (lanes, rows) that max_abs_err, ms,
    # plain_ms and the bound were measured on; on K3's, the device times
    # of device_ms.  The worklist rows' plain_ms is the
    # plain version on the card, the prepass the earlier route ran.
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
