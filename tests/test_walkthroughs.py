"""Execute the example walkthroughs end-to-end (the analog of the
reference running its walkthrough notebook under nbval in CI, reference
.github/workflows/tests.yml:36–41), and keep the generated API reference
generatable."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script)],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )
    assert proc.returncode == 0, (
        f"{script} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    )
    return proc.stdout


@pytest.mark.slow
def test_walkthrough_cli():
    out = _run(os.path.join("docs", "walkthrough.py"))
    assert "walkthrough ok" in out


@pytest.mark.slow
def test_walkthrough_tads():
    out = _run(os.path.join("docs", "walkthrough_tads.py"))
    assert "walkthrough_tads OK" in out


def test_api_reference_generates(tmp_path):
    out_path = tmp_path / "api.md"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "tools", "gen_api_docs.py"),
            str(out_path),
        ],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    text = out_path.read_text()
    for needle in (
        "class `PileUpper",
        "class `CoordCreator",
        "`pileup(",
        "coolpuppy_tpu.ops.gather",
    ):
        assert needle in text, needle
