"""The port's validated serving flags against the JAX package (CPU, `tiny`):
`utils/serving_flags.py`'s fingerprint and gate, `promote` against the
reference's promotion script (tools/dev/update_bench_flags.py) on the
same synthetic probe results, and `infer --serving-flags` in both CLIs.
The probe itself measures the card: chip_smoke.py phase 18."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from davo_tpu.cli.main import main as j_cli_main
from davo_tpu.train import loop as jloop
from davo_tpu.utils import serving_flags as jserving_flags
from davo_tpu_torch.bench.serving_probe import SERVING_FLAGS
from davo_tpu_torch.cli.main import main as cli_main
from davo_tpu_torch.utils import serving_flags
from test_bench_flags import _load_module
from test_torch_geopose import _JitInitDavoModel

NO_FLAGS_LINE = "infer: no validated BENCH_FLAGS for this code; serving plain config"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("changed", serving_flags.FINGERPRINT_FILES)
def test_fingerprint_changes_with_each_listed_file(changed, tmp_path):
    """On a copy of the listed files, the fingerprint equals the repo's,
    and moves when any one of them changes."""
    for rel in serving_flags.FINGERPRINT_FILES:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(serving_flags.ROOT, rel), tmp_path / rel)
    before = serving_flags.fingerprint(str(tmp_path))
    assert before == serving_flags.fingerprint() and len(before) == 16
    with open(tmp_path / changed, "ab") as f:
        f.write(b"\n")
    assert serving_flags.fingerprint(str(tmp_path)) != before


def _flags(**kw):
    return {"overrides": {"model.fuse_flow_level": True}, "validated_on": "gpu",
            "fingerprint": serving_flags.fingerprint(), **kw}


@pytest.mark.parametrize("case", ["missing", "validated on a tpu", "stale fingerprint", "valid"])
def test_load_validated_flags_gate(case, tmp_path):
    """{} for a missing file, a file validated on a TPU (the JAX
    package's) and a stale fingerprint; the file's dict for a matching
    GPU file."""
    path = tmp_path / "BENCH_FLAGS_torch.json"
    content = {"validated on a tpu": _flags(validated_on="tpu"),
               "stale fingerprint": _flags(fingerprint="0123456789abcdef"), "valid": _flags()}.get(case)
    if content is not None:
        path.write_text(json.dumps(content))
    got = serving_flags.load_validated_flags(str(path))
    assert got == (content if case == "valid" else {})


BASE = {"status": "done", "ms": 10.0, "fps": 12800.0, "base": "davo-fast", "overrides": {},
        "equality_checked": False, "out_absmax": 1.0}
PROBES = {
    "winner": {
        "davo-fast (fuse_estimator)": {"status": "done", "fps": 14000.0, "base": "davo-fast",
                                       "overrides": {"fuse_estimator": True}, "equality_checked": True,
                                       "maxerr": 1e-4},
        "davo-fast (all fused)": {"status": "done", "fps": 15000.0, "base": "davo-fast",
                                  "overrides": dict.fromkeys(SERVING_FLAGS, True), "equality_checked": True,
                                  "maxerr": 2e-4},
        "davo-fast (unchecked)": {"status": "done", "fps": 20000.0, "base": "davo-fast",
                                  "overrides": {"flow_levels": 3}, "equality_checked": False},
        "davo-fast (failed)": {"status": "failed", "base": "davo-fast", "overrides": {"fuse_pyramid": True},
                               "equality_checked": True, "error": "RuntimeError: launch"},
    },
    "over tolerance": {
        "davo-fast (all fused)": {"status": "done", "fps": 19000.0, "base": "davo-fast",
                                  "overrides": dict.fromkeys(SERVING_FLAGS, True), "equality_checked": True,
                                  "maxerr": 0.0201},
    },
    "under MIN_SPEEDUP": {
        "davo-fast (fuse_estimator)": {"status": "done", "fps": 12850.0, "base": "davo-fast",
                                       "overrides": {"fuse_estimator": True}, "equality_checked": True,
                                       "maxerr": 1e-4},
    },
    "stale fingerprint": {},
}


@pytest.mark.parametrize("case", list(PROBES))
def test_promote_matches_the_reference_rule(case, tmp_path, monkeypatch):
    """On the same probe results (each package's own fingerprint, or a
    stale one), the port's `promote` and the reference's
    update_bench_flags pick the same winner and write the same
    overrides, probe, maxerr and tolerance; a stale fingerprint removes
    an existing flags file in both; no winner leaves none."""
    ref = _load_module(tmp_path, monkeypatch)
    port_path = str(tmp_path / "BENCH_FLAGS_torch.json")
    fps = {"ref": ref.fingerprint(), "port": serving_flags.fingerprint()}
    if case == "stale fingerprint":
        fps = dict.fromkeys(fps, "not-the-current-code")
        for path in (ref.FLAGS, port_path):
            with open(path, "w") as f:
                json.dump({"overrides": {"model.fuse_estimator": True}}, f)
    results = {"davo-fast (slices baseline)": BASE, **PROBES[case]}
    with open(ref.RESULTS, "w") as f:
        json.dump({"_fingerprint": fps["ref"], **results}, f)
    with contextlib.redirect_stdout(io.StringIO()):
        ref.main()
        written = serving_flags.promote({"_fingerprint": fps["port"], "_card": "card, 1 W", **results}, port_path)
    assert os.path.exists(ref.FLAGS) == os.path.exists(port_path) == (case == "winner")
    if case != "winner":
        assert written is None
        return
    want, got = json.load(open(ref.FLAGS)), json.load(open(port_path))
    assert got == written
    for key in ("overrides", "probe", "probe_fps", "baseline_fps", "maxerr", "tolerance"):
        assert got[key] == want[key], key
    assert got["probe"] == "davo-fast (all fused)"
    assert (got["validated_on"], want["validated_on"]) == ("gpu", "tpu")
    assert got["fingerprint"] == serving_flags.fingerprint() and got["card"] == "card, 1 W"
    assert "compiler_options" not in got


def _infer(tmp_path, name, *extra):
    out = str(tmp_path / f"{name}.txt")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["infer", "--version", "tiny", "--seq", "1", "--out", out, "--batch-size", "8",
                       "--device", "cpu", *extra])
    assert rc == 0
    return np.loadtxt(out), err.getvalue()


def test_cli_serving_flags_without_a_file_serves_the_plain_config(tmp_path, monkeypatch):
    monkeypatch.setattr(serving_flags, "FLAGS", str(tmp_path / "missing.json"))
    got, err = _infer(tmp_path, "flags", "--serving-flags")
    want, plain_err = _infer(tmp_path, "plain")
    assert NO_FLAGS_LINE in err and NO_FLAGS_LINE not in plain_err
    assert got.shape == (32, 12)
    np.testing.assert_array_equal(got, want)


def test_cli_serving_flags_applies_the_validated_overrides(tmp_path, monkeypatch):
    """A matching GPU file with the four serving flags: the same poses as
    those flags given by --set (on the CPU the fused flags run their
    plain versions)."""
    path = tmp_path / "BENCH_FLAGS_torch.json"
    overrides = {f"model.{k}": True for k in SERVING_FLAGS}
    path.write_text(json.dumps(_flags(overrides=overrides)))
    monkeypatch.setattr(serving_flags, "FLAGS", str(path))
    got, err = _infer(tmp_path, "flags", "--serving-flags")
    sets = [arg for k in overrides for arg in ("--set", f"{k}=true")]
    want, _ = _infer(tmp_path, "sets", *sets)
    assert f"infer: applying BENCH_FLAGS {overrides}" in err and NO_FLAGS_LINE not in err
    np.testing.assert_array_equal(got, want)


def test_reference_serving_flags_without_a_file_says_the_same(tmp_path, monkeypatch, capsys):
    """The reference's `infer --serving-flags` with no BENCH_FLAGS.json
    serves its plain config (rc 0) and prints the line the port prints.
    Behaviour and message only: the two CLIs draw their random weights
    differently."""
    monkeypatch.setattr(jserving_flags, "ROOT", str(tmp_path))
    monkeypatch.setattr(jloop, "DavoModel", _JitInitDavoModel)
    out = tmp_path / "ref.txt"
    rc = j_cli_main(
        ["infer", "--version", "tiny", "--seq", "1", "--out", str(out), "--batch-size", "8", "--serving-flags"])
    err = capsys.readouterr().err
    assert rc == 0 and NO_FLAGS_LINE in err
    assert np.loadtxt(out).shape == (32, 12)


def test_probe_measures_the_card_or_raises():
    """The serving probe has no CPU path: without a card it raises before
    building a model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs")
    from davo_tpu_torch.bench import serving_probe

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_probe.probe()
