"""Nothing under perfbench imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from perfbench.harness import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "asr_streaming_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources(HERE):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(HERE, "reference")):
        assert "asr_streaming_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, perfbench.reference.ctc, perfbench.reference.rnnt; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'asr_streaming_tpu_torch', 'asr_streaming_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
