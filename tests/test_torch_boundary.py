"""davo_tpu_torch and chip_smoke.py stand alone: no JAX, Flax or davo_tpu."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "davo_tpu_torch"
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|davo_tpu)(?![\w])", re.M
)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import davo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(davo_tpu_torch.__path__, 'davo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'davo_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax(path):
    source = (REPO / path).read_text()
    assert not _FORBIDDEN_IMPORT.findall(source), path


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "  import flax.linen as nn",
                 "from davo_tpu.core import geometry", "import davo_tpu"):
        assert _FORBIDDEN_IMPORT.search(line), line
    for line in ("import davo_tpu_torch", "from davo_tpu_torch.models import presets",
                 "# jax is the reference", "import jaxtyping_free"):
        assert not _FORBIDDEN_IMPORT.search(line), line
