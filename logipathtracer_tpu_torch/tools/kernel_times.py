"""Kernel times on the card for this checkout's package or another's:
K3 beside ``index_add_`` (``flush``), the intersect kernels K1 and
K4-K8 with the rates of the routes they serve (``isect``), the shade
kernel K2 on the main paths' pools (``shade``) and the texture
prologue's kernel (``tex``).

    python logipathtracer_tpu_torch/tools/kernel_times.py flush
        [--root DIR] [--label NAME] [--runs 50]
    python logipathtracer_tpu_torch/tools/kernel_times.py isect
        [--root DIR] [--label NAME] [--runs 10] [--main-runs N]
        [--kinds k4,k6,k5,k6cap0,k1,k7,k8] [--routes NAME,...]
        [--count-tiles N]
    python logipathtracer_tpu_torch/tools/kernel_times.py shade
        [--root DIR] [--label NAME] [--runs 10] [--main-runs N]
    python logipathtracer_tpu_torch/tools/kernel_times.py tex
        --glb SCENE.glb [--root DIR] [--label NAME] [--runs 10]
    python logipathtracer_tpu_torch/tools/kernel_times.py ptxas
        [--root DIR] [--label NAME]

Times the ``logipathtracer_tpu_torch`` package under ``--root`` (default:
the checkout that holds this script), so that an earlier commit, e.g. a
``git archive`` unpacked into the git-ignored ``.checkout/``, is measured
by the same code in the same call: the inputs and timers are this
checkout's ``tools/harness.py``, loaded by its path.  Run it as a file,
not with ``-m``: the package must be imported from ``--root``.  Prints
one JSON line with the card's name and power limit.

``flush``: the inputs of ``chip_smoke.py``'s K3 check, a sorted pool
tail of 2^20 rows, the last 2^18 retired with ascending pixel ids of a
1024^2 accumulator (``harness.make_tail``).  K3 must equal its plain
version and repeat bit for bit.  For K3 and for ``index_add_`` of the
retired rows into the same accumulator:

  event_ms:  the median of 10 single calls between two CUDA events on an
             idle device (what ``chip_smoke.py``'s kernel rows hold): the
             host's time to issue the call, then the device's;
  device_ms: the kernel rows of ``torch.profiler`` over ``--runs`` calls,
             divided by the calls: the device's own time;
  stream_ms: ``--runs`` calls back to back between two events, divided
             by the calls;
  host_us:   the host's time to issue one of those calls.

``isect``: the pools are ``chip_smoke.py``'s, 2^20 rays each, from fixed
seeds (``harness.pools``): on ``make_outside_scene()`` under the default
RenderConfig at 1024^2, which routes it to K4, the primary pool, the
bounce pool after one step and that bounce's NEE shadow pool (t_max +
any-hit); on the flagship box ``make_box_scene(spheres=10, subdiv=3)``
(K1) the same three, and the megakernel's three pools of the routes
``compact_worklist=False`` (K7) and ``intersect="sweep"`` (K8;
``harness.megakernel_pools``).  Each time is the median of ``--runs``
single calls between two CUDA events.  ``--kinds`` times only the
kernels it names, ``--routes`` runs only the main routes it names
(default: all of each).

  k4, k6, k5, k6cap0, k1, k7, k8: ms per pool (k6 is K6's cap > 0 body,
              the route ``stream_worklist=False``, k6cap0 its cap = 0
              body, the route ``stream_compact=False``, in its t_max
              mode on the shadow pool; K5 on the outside primary and
              bounce pools; K8 in its t_max mode on the shadow pool),
              with the mean list length wn of K4's, K5's and K6's pools;
  digest:     sha256 of each kernel's (t, tri, obj) per pool, so that two
              checkouts' runs show whether they agree bit for bit;
  count:      with ``--count-tiles N`` and k4: the count pass
              (``harness.isect_counted``) of K4's plain version on N
              tiles of each pool, spread over its live lanes — the slab
              tests, the own slab passes (queued rays), K4's group box
              tests, those that pass and the slots tested, and their
              line (``harness.group_line``: the share of group tests
              that pass, the slots tested a queued ray; "no group test"
              for a package without them) — with K4's ms on those tiles
              (``--runs`` calls);
  main:       with ``--main-runs N``: each route N times, each a fresh
              renderer (host seed 0): a warm-up session (step(1),
              step(2) twice, a camera reset: on the card the wavefront
              captures its stages there, render/graph.py), then a
              step(1) and step(2) twice, the two timed — samples/s,
              Mrays/s, mean radiance and ray count.  Routes: the
              flagship main path (K1) and its single-shot session
              (``pool_carryover=False``, through ``render_wavefront``),
              the outside main path (K4), the outside with
              ``stream_worklist=False`` (K6 cap > 0) and with
              ``stream_compact=False`` (K6 cap = 0), the flagship
              wavefront and megakernel with ``compact_worklist=False``
              (K7), and the megakernel with ``intersect="sweep"`` (K8).

``shade``: K2 on ``harness.shade_pools``' 2^20-lane pools from fixed
seeds — the flagship box's bounce pool with parity and with Threefry
draws, the textured box's NEE bounce pool (tex+nee), the megakernel's
fifth bounce (dead lanes among the live ones) and a 92-triangle box's
camera rays (the tri_sel class).  Per pool:

  event_ms, device_ms, stream_ms, host_us: as in ``flush`` (device_ms
             and host_us over ``--runs`` x 5 calls);
  digest:    sha256 of every output, in order, so that two checkouts'
             runs show whether they agree bit for bit;
  diverged:  shade_agreement against the plain version (the count
             pass's call);
  ops, bound_ms, bound_by: the count pass (``harness.shade_ops``)
             beside the bytes;
  walk:      the walk's warp efficiency and with the lobes apart, one
             thread a lane in pool order as K2 runs it
             (``harness.walk_efficiency``); the lanes that hit, the mean
             orders of their walks and the lanes walking more than 2;
  main:      with ``--main-runs N``, as in ``isect``: the flagship, the
             NEE + textured box, the outside class and the megakernel,
             each at its defaults (K2 on each).

``tex``: the texture prologue on the textured scene ``--glb`` (for the
PBR benchmark cell's shapes, its full-size scene from the benchmark's
generator: 34 maps of 1024^2 in a 142.6 MB packed atlas, four slots),
on the 2^20-lane bounce pool of a 1024^2 NEE session
(``harness.tex_pool``), with its alive mask:

  event_ms, device_ms, stream_ms, host_us: the kernel, as in ``flush``
             (device_ms and host_us over ``--runs`` x 5 calls);
  plain_ms:  its plain version on the card, the median of 3 calls
             between two CUDA events;
  bit_equal, max_abs_err: the kernel's outputs against the plain
             version's on the live lanes, zeros elsewhere
             (``harness.tex_agreement``);
  live, taps: the live lanes and their texture taps (four texels each);
  bytes, bound_ms: ``harness.tex_bytes`` ÷ 3.35 TB/s (the lanes' inputs
             and outputs, 4 B a texel, the tri_shade and obj_tex rows
             once a call: they stay in L2); bound_ms_sectors with a
             32-B sector a texel;
  digest:    sha256 of the outputs.

``ptxas``: each source built as the package builds it, with ``-Xptxas
-v``: per kernel, ptxas's lines on its registers, spills and shared
memory.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))


def load_harness():
    """This checkout's tools/harness.py, loaded by its path, so that it
    does not import the package before ``--root`` is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "_lpt_harness", os.path.join(_HERE, "harness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flush_times(h, dev, runs, npix=1 << 20, rows=1 << 20, retired=1 << 18):
    """{"k3": times, "index_add_": times} on ``make_tail``'s inputs, each
    times a dict of event_ms, device_ms, stream_ms and host_us; K3 checked
    against its plain version and a repeat first."""
    from logipathtracer_tpu_torch.ops.kernels import flush
    pix, acc = h.make_tail(npix, rows, retired, dev)
    base = torch.rand((npix, 3), generator=torch.Generator().manual_seed(1))
    base = base.to(dev)
    k1 = flush.flush_sorted(base.clone(), pix, acc)
    k2 = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    assert torch.equal(k1, k2), "K3: repeat run not bit-identical"
    assert torch.equal(k1, p), "K3: differs from its plain version"
    work = base.clone()
    tail = slice(rows - retired, rows)
    pix_r, acc_r = pix[tail].contiguous(), acc[tail].contiguous()
    out = {}
    for name, fn in (("k3", lambda: flush.flush_sorted(work, pix, acc)),
                     ("index_add_", lambda: work.index_add_(0, pix_r,
                                                            acc_r))):
        ev = h.event_ms(fn)
        d, s, us = h.device_ms(fn, runs)
        out[name] = {"event_ms": ev, "device_ms": d, "stream_ms": s,
                     "host_us": us}
    return out


MAIN_ROUTES = {
    "flagship": ("box", {}),
    "single-shot": ("box", dict(pool_carryover=False)),
    "outside": ("outside", {}),
    "outside stream_worklist=False": ("outside",
                                      dict(stream_worklist=False)),
    "outside stream_compact=False": ("outside",
                                     dict(stream_compact=False)),
    "wavefront compact_worklist=False": ("box",
                                         dict(compact_worklist=False)),
    "megakernel compact_worklist=False": (
        "box", dict(renderer="megakernel", compact_worklist=False)),
    "megakernel intersect=sweep": (
        "box", dict(renderer="megakernel", intersect="sweep")),
}

# The kernels ``isect`` times: its output key -> the harness runner's
# kind.
ISECT_KINDS = {"k4": "K4", "k6": "K6[cap>0]", "k5": "K5",
               "k6cap0": "K6[cap=0]", "k1": "K1", "k7": "K7", "k8": "K8"}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: two checkouts' runs agree
    bit for bit where their digests do."""
    import hashlib
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def pick(routes, names):
    """``routes`` restricted to the comma-separated ``names`` (None: all)."""
    if names is None:
        return routes
    names = names.split(",")
    unknown = set(names) - set(routes)
    if unknown:
        sys.exit(f"kernel_times: unknown routes {sorted(unknown)}")
    return {k: routes[k] for k in names}


def isect_times(h, dev, runs, main_runs, kinds=tuple(ISECT_KINDS),
                routes=MAIN_ROUTES, count_tiles=0):
    """{kind: ms per pool for each of ``kinds`` (ISECT_KINDS' keys), "wn":
    mean list per K4 / K5 / K6 pool, "count": K4's count pass on
    ``count_tiles`` tiles of each pool, "main": each of ``routes``'
    runs}."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.ops.kernels import _build
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                           make_outside_scene)
    _build.load_all(("compact_intersect", "shade", "flush", "stream_cluster",
                     "stream_chunk", "cluster_sweep"))
    out = {k: {} for k in (*kinds, "wn", "digest", "count")}
    cfg = RenderConfig(width=1024, height=1024)
    scenes = {}
    streamed = [k for k in ("k4", "k6", "k5", "k6cap0") if k in kinds]
    if streamed:
        outside = scenes["outside"] = compile_scene(make_outside_scene())
        scene = outside.to(dev)
        tile = cfg.stream_tile
        for name, (rays8, kw) in h.pools(outside, cfg, dev, tile).items():
            for key in streamed:
                kind = ISECT_KINDS[key]
                if name == "shadow" and key == "k5":
                    continue
                # K6's cap = 0 body ignores any_hit: its t_max mode.
                kwk = dict(kw, any_hit=False) if key == "k6cap0" and kw \
                    else kw
                kernel, _, _, wn = h.runner(kind, scene, rays8, tile, **kwk)
                out[key][name] = h.event_ms(kernel, runs)
                out["digest"][f"{key} {name}"] = digest(kernel())
                out["wn"][f"{kind} {name}"] = float(wn.float().mean())
                if key == "k4" and count_tiles:
                    out["count"][name] = k4_count(h, scene, rays8, tile,
                                                  count_tiles, kwk, runs)
    if {"k1", "k7", "k8"} & set(kinds):
        box = scenes["box"] = compile_scene(
            make_box_scene(spheres=10, subdiv=3))
    if "k1" in kinds:
        btile = cfg.compact_tile
        bscene = box.to(dev)
        for name, (rays8, kw) in h.pools(box, cfg, dev, btile).items():
            kernel = h.runner("K1", bscene, rays8, btile, **kw)[0]
            out["k1"][name] = h.event_ms(kernel, runs)
            out["digest"][f"k1 {name}"] = digest(kernel())
    for key, route in (("k7", dict(compact_worklist=False)),
                       ("k8", dict(intersect="sweep"))):
        if key not in kinds:
            continue
        rcfg = cfg.replace(renderer="megakernel", **route)
        tile = rcfg.compact_tile if key == "k7" else rcfg.sweep_tile
        probe = ProgressiveRenderer(box, rcfg, host_seed=1, device=dev)
        primary, bounce, shadow, _ = h.megakernel_pools(probe)
        for name, (o, d, *t_max) in (("primary", primary),
                                     ("bounce", bounce), ("shadow", shadow)):
            kw = {}
            if t_max:       # K8 answers the closest hit under t_max
                kw = (dict(has_tmax=True, any_hit=True) if key == "k7"
                      else dict(has_tmax=True))
            rays8, _ = ci.pack_rays8(o, d, tile,
                                     t_max=t_max[0] if t_max else None)
            kernel = h.runner(ISECT_KINDS[key], probe.scene, rays8, tile,
                              **kw)[0]
            out[key][name] = h.event_ms(kernel, runs)
            out["digest"][f"{key} {name}"] = digest(kernel())
        del probe, primary, bounce, shadow
    out["main"] = main_routes(h, dev, routes, main_runs, scenes)
    return out


def k4_count(h, scene, rays8, tile, tiles, kw, runs):
    """K4's count pass on ``tiles`` tiles of a pool spread over its live
    lanes: {rays, slab, own, tested, group_tests, group_passed,
    group_slots, line, kernel_ms}."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    n_live = int((rays8[0] < 1e29).sum())
    sub8 = h.sub_pool(rays8, tile, n_live, tiles)
    kernel, plain, _, _ = h.runner("K4", scene, sub8, tile, **kw)
    block = ci._block_threads(sub8.shape[1], tile, "K4")
    with h.isect_counted(block=block, groups=True) as work:
        plain()
    keys = ("slab", "own", "tested", "group_tests", "group_passed",
            "group_slots")
    return {"rays": sub8.shape[1], **{k: work[k] for k in keys},
            "line": h.group_line(work),
            "kernel_ms": h.event_ms(kernel, runs)}


# The main paths K2 serves: (scene, RenderConfig fields).
SHADE_ROUTES = {
    "flagship": ("box", {}),
    "nee+textured": ("textured", dict(nee=True)),
    "outside": ("outside", {}),
    "megakernel": ("box", dict(renderer="megakernel")),
}


def main_routes(h, dev, routes, main_runs, scenes=None):
    """{route: [samples/s, Mrays/s, iterations, mean radiance, rays of
    each run]}: ``main_runs`` fresh renderers (host seed 0) a route, each
    a warm-up session (step(1), step(2) twice, a camera reset), then a
    step(1) and step(2) twice, timed.  ``scenes``: the host scenes
    already compiled, by name ("box", "textured", "outside")."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                           make_outside_scene)
    scenes = dict(scenes or {})

    def scene(which):
        if which not in scenes:
            scenes[which] = compile_scene(
                make_outside_scene() if which == "outside" else
                make_box_scene(spheres=10, subdiv=3,
                               textured=which == "textured"))
        return scenes[which]

    cfg = RenderConfig(width=1024, height=1024)
    main = {}
    for route, (which, kw) in routes.items():
        main[route] = []
        for _ in range(main_runs):
            r = ProgressiveRenderer(scene(which), cfg.replace(**kw),
                                    host_seed=0, device=dev)
            for n in (1, 2, 2):
                r.step(n)
            r.reset()
            sps, mrays, iters, rad = h.timed_steps(r)
            main[route].append({
                "samples_per_s": sps, "mrays_per_s": mrays,
                "iterations": iters, "mean_radiance": float(rad.mean()),
                "rays": int(r.total_rays)})
            del r
    return main


def shade_times(h, dev, runs):
    """{pool: times, digest, count pass} of K2 (module docstring)."""
    from logipathtracer_tpu_torch.ops.kernels import _build
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    _build.load_all(("compact_intersect", "shade", "flush"))
    out = {}
    for name, (args, kw) in h.shade_pools(dev).items():
        got = sk.shade(*args, **kw)
        with h.shade_counted() as calls:
            ref = sk.shade_plain(*args, **kw)
        work = h.shade_work(calls[0])
        diverged, _ = sk.shade_agreement([x.cpu() for x in ref],
                                         [x.cpu() for x in got])
        ops = h.shade_ops(work)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (*args, *kw.values(), *got)
                      if isinstance(t, torch.Tensor))
        t_ops, t_bytes = ops / 67e12 * 1e3, n_bytes / 3.35e12 * 1e3
        fn = (lambda: sk.shade(*args, **kw))
        ev = h.event_ms(fn, runs)
        d, st, us = h.device_ms(fn, 5 * runs)
        orders, lobe = work["orders"].cpu(), work["lobe"].cpu()
        live = work["live"].cpu().bool()
        out[name] = {
            "lanes": int(live.shape[0]), "hit": int(live.sum()),
            "event_ms": ev, "device_ms": d, "stream_ms": st, "host_us": us,
            "digest": digest(got), "diverged": diverged,
            "ops": ops, "bytes": n_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "walk": {"thread_a_lane": h.walk_efficiency(orders, lobe),
                     "mean_orders": float(orders[live].float().mean()),
                     "over_2": int((orders > 2).sum())}}
        del got, ref, args, kw
    return out


def tex_times(h, dev, runs, glb):
    """The texture prologue's kernel beside its plain version on the
    scene ``glb`` (module docstring)."""
    from logipathtracer_tpu_torch import (RenderConfig, compile_scene,
                                          load_gltf)
    from logipathtracer_tpu_torch.ops.kernels import tex_prologue as tp
    cfg = RenderConfig(width=1024, height=1024, nee=True)
    host = compile_scene(load_gltf(glb), cfg)
    scene, pool, t, obj, tri = h.tex_pool(host, cfg, dev)
    args = (scene, cfg, pool["origin"], pool["direction"], t, obj, tri)
    alive = pool["alive"]

    def fn():
        return tp.tex_prologue(*args, alive=alive)

    def plain():
        return tp.prologue_plain(*args)

    got = fn()
    equal, err = h.tex_agreement(got, plain(), h.tex_live(alive, t))
    b = h.tex_bytes(scene, t, obj, tri, alive)
    d, st, us = h.device_ms(fn, 5 * runs)
    return {"lanes": int(t.shape[0]), "live": b["live"], "taps": b["taps"],
            "atlas_bytes": scene.tex_atlas.numel()
            * scene.tex_atlas.element_size(),
            "event_ms": h.event_ms(fn, runs), "device_ms": d,
            "stream_ms": st, "host_us": us, "plain_ms": h.event_ms(plain, 3),
            "bit_equal": equal, "max_abs_err": err, "bytes": b["bytes"],
            "bound_ms": b["bytes"] / 3.35e12 * 1e3,
            "bound_ms_sectors": b["bytes_sectors"] / 3.35e12 * 1e3,
            "digest": digest([x for x in got if x is not None])}


def ptxas_report():
    """{source: ptxas -v lines}: each csrc source compiled as ``_build``
    compiles it, into the build directory, with ``-Xptxas -v``."""
    from logipathtracer_tpu_torch.ops.kernels import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = {}
    for name in _build.EXTRA_FLAGS:
        so = os.path.join(_build.BUILD_DIR, f"ptxas_{name}.so")
        res = subprocess.run(_build.nvcc_command(name, so, "-Xptxas", "-v"),
                             capture_output=True, text=True, check=True)
        out[name] = [ln.strip() for ln in res.stderr.splitlines()
                     if "Compiling entry" in ln or "Used" in ln
                     or "spill" in ln]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels",
                    choices=("flush", "isect", "shade", "tex", "ptxas"))
    ap.add_argument("--root", default=_ROOT,
                    help="checkout whose logipathtracer_tpu_torch to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=None,
                    help="calls per time (flush: 50; isect, shade and "
                    "tex: 10)")
    ap.add_argument("--main-runs", type=int, default=0,
                    help="isect, shade: runs of each main route")
    ap.add_argument("--kinds", default=",".join(ISECT_KINDS),
                    help="isect: the kernels to time, comma-separated")
    ap.add_argument("--routes", default=None,
                    help="isect, shade: the main routes to run, "
                    "comma-separated (default: all)")
    ap.add_argument("--glb", default=None,
                    help="tex: the textured scene to run the prologue on")
    ap.add_argument("--count-tiles", type=int, default=0,
                    help="isect: K4's count pass on this many tiles of "
                    "each pool (0: none)")
    args = ap.parse_args(argv)
    if args.kernels == "tex" and not args.glb:
        ap.error("tex needs --glb")
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    root = os.path.abspath(args.root)
    h = load_harness()
    sys.path.insert(0, root)
    import logipathtracer_tpu_torch as pkg
    assert os.path.abspath(pkg.__file__).startswith(root + os.sep), \
        f"imported {pkg.__file__}, not the package under {root}"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runs = None
    if args.kernels == "ptxas":
        res = {"ptxas": ptxas_report()}
    elif args.kernels == "flush":
        runs = args.runs or 50
        res = flush_times(h, dev, runs)
    elif args.kernels == "tex":
        runs = args.runs or 10
        res = {"tex": tex_times(h, dev, runs, os.path.abspath(args.glb))}
    elif args.kernels == "shade":
        runs = args.runs or 10
        res = {"shade": shade_times(h, dev, runs),
               "main": main_routes(h, dev, pick(SHADE_ROUTES, args.routes),
                                   args.main_runs)}
    else:
        runs = args.runs or 10
        kinds = tuple(args.kinds.split(","))
        unknown = set(kinds) - set(ISECT_KINDS)
        if unknown:
            sys.exit(f"kernel_times: unknown kinds {sorted(unknown)}")
        res = isect_times(h, dev, runs, args.main_runs, kinds,
                          pick(MAIN_ROUTES, args.routes), args.count_tiles)
    print(json.dumps({"label": args.label or root, "card": card,
                      "kernels": args.kernels, "runs": runs, **res,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
