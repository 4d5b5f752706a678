"""A run loads neither JAX nor the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the reference
side imports nothing of the port."""

import ast
import os
import subprocess
import sys
import types

from benchmark import harness
from benchmark.tests import tinyroot

# The files the check's reference side is built from.
REFERENCE_SIDE = ("reference.py", "compare.py", "scene.py", "traffic.py", "roofline.py", "control.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_side_imports_nothing_of_the_port():
    for name in REFERENCE_SIDE:
        for mod in _imports(os.path.join(tinyroot.BENCH, name)):
            assert mod.split(".")[0] not in ("rend3_tpu_torch",) + harness.FORBIDDEN, (name, mod)
    code = ("import sys; sys.path.insert(0, {!r}); import benchmark.reference, benchmark.compare, benchmark.control; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'rend3_tpu_torch', 'rend3_tpu', 'jax'}}))")
    out = subprocess.run([sys.executable, "-c", code.format(tinyroot.REPO)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names():
    fakes = ("rend3_tpu_torch_like", "jaxtyping_like", "rend3_tpu.ops", "jax.numpy")
    for name in fakes:
        sys.modules[name] = types.ModuleType(name)
    try:
        found = harness.forbidden_modules()
        assert "rend3_tpu" in found and "jax" in found
        assert not {"rend3_tpu_torch", "rend3_tpu_torch_like", "jaxtyping_like"} & set(found)
    finally:
        for name in fakes:
            sys.modules.pop(name, None)


def test_a_run_loads_no_jax(tmp_path):
    root = tinyroot.make(tmp_path)
    code = ("import sys; sys.path.insert(0, {repo!r}); from benchmark import harness; "
            "r = harness.run_cell({root!r}, 'bistro-proxy-1080p.static', 7, 0.5, False, device='cpu'); "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & set(harness.FORBIDDEN)), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code.format(repo=tinyroot.REPO, root=root)], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
