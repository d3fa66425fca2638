"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
top-level name whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.HERE)
               for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.HERE) for p in FILES])
def test_no_jax_import(path):
    names = top_level_imports(path)
    assert not names & {"jax", "jaxlib", "flax", "basicrenderer_tpu"}
    if os.sep + "reference" + os.sep in path:
        assert "basicrenderer_tpu_torch" not in names


def test_loaded_modules():
    """A process that loads the port, the harness and the reference holds
    no module of JAX or the JAX package; the reference alone holds none of
    the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import reference\n"
        "from portbench.reference import raster, shade\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'basicrenderer_tpu_torch' not in tops, tops\n"
        "from portbench import harness, check, roofline\n"
        "import basicrenderer_tpu_torch.renderer\n"
        "print(sorted(set(harness.FORBIDDEN) & "
        "{m.split('.')[0] for m in sys.modules}))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "basicrenderer_tpu_torch_x", sys)
    assert "basicrenderer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "basicrenderer_tpu.sub", sys)
    assert harness.forbidden_modules() == ["basicrenderer_tpu"]
