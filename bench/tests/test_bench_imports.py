"""The import rule: nothing of the benchmark imports JAX or the JAX
package (``repro``), compared by whole top-level names (``repro_torch``
is the port); the plain reference imports nothing of the port either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_plain_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imports(path))
    assert "repro_torch" not in path.read_text()


def test_harness_loads_no_jax():
    """Importing the harness, every reader and the port's training path
    loads no JAX module and no module of the JAX package."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from bench import harness\n"
            "for m in ('train_tokens_per_s', 'mfu_pct', 'flash_roofline', 'ssd_roofline'):\n"
            "    harness.reader(m)\n"
            "import repro_torch.train.train_loop, repro_torch.models.model\n"
            "import repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan\n"
            "print(harness.loaded_forbidden())\n")
    root = BENCH.parent
    out = subprocess.run([sys.executable, "-c", code, str(root), str(root / "src")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
