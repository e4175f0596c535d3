"""What a run loads: no module whose top-level name is `jax` or the JAX
package's (`davo_tpu`), compared as whole names (the program's own
`davo_tpu_torch` begins with the JAX package's name); the reference
loads nothing of the program; without a card the command exits non-zero
with a message and prints no result."""

import json
import subprocess
import sys

from vobench.harness import BENCH_DIR, forbidden_loaded

ROOT = BENCH_DIR.parent
ENV_PREFIX = "import sys; sys.path.insert(0, %r); " % str(ROOT)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", ENV_PREFIX + code], capture_output=True, text=True,
                          cwd=ROOT, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import json, time; from pathlib import Path; from vobench import harness; "
        "from vobench.tests.tiny import write_layout; "
        f"lay = write_layout(Path({str(tmp_path)!r})); "
        "r = harness.run_cell('tiny-fast.serve', 5, 0.3, True, 'cpu', time.perf_counter(), lay); "
        "r = harness.run_cell('tiny.train', 5, 0.3, False, 'cpu', time.perf_counter(), lay); "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "davo_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "davo_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import vobench.reference.model, vobench.reference.losses, vobench.reference.train, "
        "vobench.reference.ops, vobench.reference.geometry, vobench.data, vobench.flops, vobench.roofline; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "davo_tpu_torch" not in proc.stdout and "'davo_tpu'" not in proc.stdout and "jax" not in proc.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "davo_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "davo_tpu.models", sys)
    assert forbidden_loaded() == ["davo_tpu.models"]


def test_without_a_card_the_command_refuses(card_absent):
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "davo-fused.serve-b256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr and proc.stdout.strip() == ""


def test_without_the_program_the_command_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "vobench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "davo.train-b64", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
