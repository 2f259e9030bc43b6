"""Nothing perfbench loads imports JAX, its libraries or the JAX package,
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fusion_tpu"}

WALK = """
import importlib, importlib.util, json, pkgutil, sys
from pathlib import Path
import perfbench
names = [m.name for m in pkgutil.walk_packages(perfbench.__path__, "perfbench.")
         if ".tests" not in m.name and m.name not in ("perfbench.run", "perfbench.control")] + {extra}
for name in names:
    importlib.import_module(name)
for path in sorted(Path("perfbench/metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_anything_perfbench_loads():
    loaded = _top_levels(WALK.format(extra='["perfbench.run", "perfbench.control", "fusion_tpu_torch.serving"]'))
    assert "perfbench" in loaded and "fusion_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import perfbench.reference.hybrid, perfbench.reference.encoder, perfbench.check, perfbench.corpus\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    loaded = _top_levels(code)
    assert "fusion_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_sources_name_no_forbidden_module():
    """Every import statement under perfbench/, by its top-level name, whole;
    the reference's also never name the program."""
    for path in PB.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & FORBIDDEN, (path, tops)
            if "reference" in path.parts:
                assert "fusion_tpu_torch" not in tops, (path, tops)
