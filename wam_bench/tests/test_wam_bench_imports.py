"""No module of wam_bench imports JAX or the JAX package, by whole
top-level names (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from wam_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "webaudio_modem_tpu"}
SOURCES = sorted(p for p in harness.ROOT.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_source_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_are_compared():
    assert "webaudio_modem_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "webaudio_modem_tpu.ops".split(".")[0] in FORBIDDEN


def test_loading_every_module_loads_no_jax():
    """Import every harness module, driver and reader (and through them
    the port) in a fresh interpreter; then look at sys.modules."""
    code = (
        "import importlib, sys\n"
        "from wam_bench import harness\n"
        "for p in sorted(harness.ROOT.rglob('*.py')):\n"
        "    rel = p.relative_to(harness.ROOT)\n"
        "    if 'tests' in rel.parts or p.name == 'run.py':\n"
        "        continue\n"
        "    if rel.parts[0] == 'metrics':\n"
        "        harness.load_reader(p.stem)\n"
        "    else:\n"
        "        importlib.import_module('wam_bench.' + '.'.join(\n"
        "            rel.with_suffix('').parts).replace('.__init__', ''))\n"
        "import webaudio_modem_tpu_torch.models.farm\n"
        "import webaudio_modem_tpu_torch.ops.soft_fsk\n"
        "print(','.join(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, timeout=300,
                         check=True)
    assert out.stdout.strip() == ""
