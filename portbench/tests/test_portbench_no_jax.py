"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program.  The
walk follows every import statement, at any depth in a function too,
through the repository's own modules."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "logipathtracer_tpu"}
PORT = "logipathtracer_tpu_torch"


def _file_of(module: str):
    base = os.path.join(ROOT, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _imports(path: str, package: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")[:len(package.split("."))
                                          - node.level + 1]
                base = ".".join(parts + ([node.module] if node.module
                                         else []))
            else:
                base = node.module
            yield base
            for a in node.names:
                yield f"{base}.{a.name}"


def walk(start: str) -> set:
    """Every module name imported from ``start`` (a file), following the
    repository's own modules."""
    seen, names = set(), set()
    todo = [(start, "portbench")]
    while todo:
        path, pkg = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path, pkg):
            names.add(name)
            f = _file_of(name)
            if f is not None:
                mod_pkg = name if f.endswith("__init__.py") else \
                    name.rpartition(".")[0]
                todo.append((f, mod_pkg))
    return names


def _harness_files():
    out = [os.path.join(HERE, "run.py")]
    for sub in ("drivers", "metrics", "scenes", "refs"):
        d = os.path.join(HERE, sub)
        out += [os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(".py")]
    return out


def test_harness_imports_no_jax():
    for f in _harness_files():
        bad = {n for n in walk(f) if n.split(".")[0] in FORBIDDEN}
        assert not bad, (f, bad)


def test_reference_imports_nothing_of_the_program():
    names = walk(os.path.join(HERE, "refs", "pathtrace.py"))
    assert not {n for n in names if n.split(".")[0] in FORBIDDEN}
    assert not {n for n in names if n.split(".")[0] == PORT}
    assert "torch" in names


def test_loaded_modules_after_import():
    """What importing the harness, its parts and the program's modules
    it drives loads, in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.harness, portbench.check, portbench.trace\n"
        "import portbench.drivers.viewer, portbench.drivers.render\n"
        "from logipathtracer_tpu_torch.render.progressive import "
        "ProgressiveRenderer\n"
        "from logipathtracer_tpu_torch.cli.webview import _HostFrame\n"
        "from logipathtracer_tpu_torch.scene.compile import compile_scene\n"
        "from logipathtracer_tpu_torch.render.graph import graph_cache\n"
        "print(portbench.harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
