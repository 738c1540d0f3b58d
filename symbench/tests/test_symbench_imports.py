"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port."""
import ast
import os
import subprocess
import sys

from bench import manifest

BANNED = ("jax", "jaxlib", "flax", "repro")
ROOT = os.path.dirname(manifest.BENCH)
_TINY_RUNS = """
import sys
sys.path[:0] = [{src!r}, {bench!r}, {tests!r}]
import torch
torch.set_num_threads(2)
import tiny
from bench import manifest
log = lambda m: None
for cfg, mix, cell in (
        ("granite-3-8b", tiny.serve_mix("serve_open"), "tiny-serve-open"),
        ("deepseek-moe-16b", tiny.serve_mix("serve_backlog"),
         "tiny-serve-backlog"),
        ("deepseek-moe-16b", tiny.train_mix("ft-4jobs"),
         "deepseek-ft-4jobs")):
    manifest.loop(mix).run(tiny.arch(cfg), mix, cell, 3, 0.5, False, "cpu",
                           log)
for name in ("control", "sweep", "run"):
    __import__(name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in {banned!r})
assert not bad, bad
assert "repro_torch" in sys.modules
print("clean")
"""


def _python(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = _TINY_RUNS.format(src=os.path.join(ROOT, "src"),
                             bench=manifest.BENCH,
                             tests=os.path.join(manifest.BENCH, "tests"),
                             banned=BANNED)
    r = _python(code)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-3000:]


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path[:0] = [{manifest.BENCH!r}]\n"
            "import bench.reference, bench.check\n"
            "for f in ('dense', 'moe'): bench.reference.family_ffn(f)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{BANNED + ('repro_torch',)!r})\n"
            "assert not bad, bad\nprint('clean')\n")
    r = _python(code)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-3000:]


def test_the_reference_source_imports_torch_and_the_standard_library_only():
    refs = os.path.join(manifest.BENCH, "refs")
    paths = [os.path.join(manifest.BENCH, "bench", "reference.py")] + [
        os.path.join(refs, f) for f in sorted(os.listdir(refs))
        if f.endswith(".py")]
    assert len(paths) >= 3
    for path in paths:
        tree = ast.parse(open(path).read())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add((node.module or "").split(".")[0])
        assert tops <= {"__future__", "contextlib", "importlib", "math", "os",
                        "sys", "torch"}, (path, tops)


def test_harness_sources_never_name_the_jax_package():
    for dirpath, _, files in os.walk(manifest.BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in BANNED, (f, n)
