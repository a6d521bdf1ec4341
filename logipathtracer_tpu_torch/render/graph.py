"""CUDA graphs of the wavefront loop's stages: the port's counterpart of
the JAX package's ``jax.jit`` around its ``lax.while_loop``
(``logipathtracer_tpu/render/wavefront.py``), which the JAX package has
no module for.

A wavefront iteration (render/wavefront.py ``_Body``) is two
static-shape stages around one host read: stage A (sort, flush, count)
and stage B (regen, park, trace, shade) on a window from a fixed ladder.
On a CUDA device each (stage, variant, rung) of a pool is captured once
into a ``torch.cuda.CUDAGraph`` and replayed after: about two hundred
launches become one replay.  Every tensor a stage reads or writes sits
at a fixed address (the pool state, the frame's input buffers), and
nothing in a stage reads the host, so a replay does what the captured
call did.

``GraphCache`` holds one graph memory pool for a scene's device copy
(one per renderer: ``ProgressiveRenderer`` commits its own copy), the
loop bodies keyed by pool and frame, and ``render_wavefront``'s pools;
``graph_cache`` finds it on the scene.  The first call of a stage is
its warm-up: it runs eagerly on a side stream (which also builds and
binds the kernels' libraries, ``ops/kernels/_build.py``) and does that
iteration's work; the capture follows.  Once a stage B has run regen
and trace, the body captures stage B at every other window of the
ladder too, without running them, so no later iteration waits on a
capture.  A capture records what the wrappers it ran added to the
launch counts (``_build.recording``: a capture launches nothing, so
the counts are put back), and every replay adds that again
(``_build.add``), so the counts count launches as the eager loop does.
A capture that fails raises: nothing falls back to the eager loop.

Captures use ``capture_error_mode="thread_local"``: the device mesh
(``parallel/mesh.py``) renders on one worker thread per device, and a
capture on one must not fail another thread's launches.  The counts'
lock (``_build.COUNT_LOCK``, re-entrant) is held through a capture, so
another thread's launches are not taken for the captured ones.
"""

from __future__ import annotations

import time
import weakref

import torch

from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.utils import trace as tracing

# Intersect modes whose loops read the host while they run, so a stage
# holding them cannot be captured: the BVH walk tests ``any(sp > 0)``
# every trip (ops/traverse.py ``intersect_scene``) and the jnp twin of
# the sweep reads the cluster table and updates the best hit through
# boolean masks (ops/kernels/cluster_intersect.py
# ``cluster_intersect_jnp``).  The wavefront loop runs them eagerly.
EAGER_MODES = ("bvh", "sweep_jnp")


class CapturedStage:
    """One captured stage: its graph and what its capture added to the
    launch counts (a ``_build.recording`` delta).  It refers to its
    cache weakly: the cache holds it, and a cycle would keep the graphs'
    memory until a garbage collection."""

    def __init__(self, graph, deltas, cache):
        self.graph = graph
        self.deltas = deltas
        self._cache = weakref.ref(cache)

    def replay(self):
        self.graph.replay()
        with _build.COUNT_LOCK:
            _build.add(self.deltas)
            cache = self._cache()
            if cache is not None:
                cache.replays += 1


class _PoolUse:
    """A graph memory pool and the count of its live graphs.  Once every
    graph of a pool is gone (a body's stages captured again, a pool
    dropped) torch retires the pool and refuses a new capture into it,
    so the next capture takes a new pool."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.live = 0

    def release(self):
        # A finalizer: it may run on whichever thread drops a stage.
        with _build.COUNT_LOCK:
            self.live -= 1


class GraphCache:
    """The captured stages of one device's scene copy: one graph memory
    pool, the loop bodies and kept pools (``keep``) and the capture
    statistics — ``captures``, ``warm_ups`` (the captures whose stage
    ran first: an iteration's work), ``capture_seconds`` (warm-ups
    excluded),
    ``capture_bytes`` (the device memory the captures reserved) and
    ``replays``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = _PoolUse()
        self._side = torch.cuda.Stream(device=self.device)
        self._kept: dict = {}
        self.captures = 0
        self.warm_ups = 0
        self.capture_seconds = 0.0
        self.capture_bytes = 0
        self.replays = 0

    def keep(self, key, make):
        """The object of ``key`` — a loop body (keyed by pool, config and
        frame) or a kept pool state — made by ``make()`` on first use.
        The cache holds it, and so its pool: an id in a key cannot be
        reused while the cache lives."""
        b = self._kept.get(key)
        if b is None:
            b = self._kept[key] = make()
        return b

    def drop(self, state):
        """Forget the pool ``state`` and the bodies (with their graphs)
        that run it."""
        self._kept = {k: b for k, b in self._kept.items()
                      if b is not state and getattr(b, "st", None)
                      is not state}

    def capture(self, fn, warm_up: bool = True) -> CapturedStage:
        """Run ``fn`` eagerly on the side stream (the warm-up; its work
        is this call's), then capture it; ``warm_up=False`` only
        captures (a variant of a stage that has run).  Raises if the
        capture fails.  The host span ``capture`` marks it."""
        with tracing.span("capture"):
            return self._capture(fn, warm_up)

    def _capture(self, fn, warm_up: bool) -> CapturedStage:
        if warm_up:
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                fn()
            cur.wait_stream(self._side)
            self._side.synchronize()
            self.warm_ups += 1
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with _build.COUNT_LOCK:
            if self._pool.live == 0 and self.captures:
                self._pool = _PoolUse()
            pool = self._pool
            with _build.recording() as deltas, \
                    torch.cuda.stream(self._side):
                graph.capture_begin(pool=pool.handle,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()
            pool.live += 1
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        self.capture_bytes += (torch.cuda.memory_reserved(self.device)
                               - reserved)
        stage = CapturedStage(graph, deltas, self)
        weakref.finalize(stage, pool.release)
        return stage


def graph_cache(scene) -> GraphCache:
    """The GraphCache of a CUDA scene copy, made on first use and kept on
    the scene (as ops/traverse.py keeps its derived constants)."""
    cache = scene.__dict__.get("_graph_cache")
    if cache is None:
        cache = scene.__dict__["_graph_cache"] = GraphCache(
            scene.cl_tris.device)
    return cache


def uses_graphs(cfg, scene, device, eager: bool = False) -> bool:
    """Whether the wavefront loop on ``device`` runs through captured
    stages: on a CUDA device, unless ``eager`` asks for the eager form
    or the intersect mode is one of EAGER_MODES."""
    from logipathtracer_tpu_torch.render.megakernel import \
        resolve_intersect_mode
    return (torch.device(device).type == "cuda" and not eager
            and resolve_intersect_mode(cfg, scene) not in EAGER_MODES)
