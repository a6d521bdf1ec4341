"""Run one cell of the port's benchmark once, on the CUDA card, and
print its result as the last line of standard output:

    python portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

The cells, metrics and bounds are in BENCHMARK.json at the repository's
root; the program under test is ``logipathtracer_tpu_torch``.  Exits
non-zero, and prints no result, without a card, without the program, or
if JAX or the JAX package was loaded.  Kernel builds stay in the
checkout's fixed build directories."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    # Kernel caches stay at fixed paths in the checkout.  The port builds
    # its CUDA kernels into its own build directory and uses neither of
    # these today; a kernel that does will find them set.
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    from portbench import harness
    sys.exit(harness.main())
