"""Frozen golden outputs for EVERY engine mode.

Each test runs a fixed-seed workload through `pileup()` and compares
against a committed `tests/golden/*.npz` exactly (atol=1e-10): the repo's
durable defense against silent numeric drift while the reference's golden
coolers are unavailable (reference .MISSING_LARGE_BLOBS; the pattern
mirrors the reference's own regression baselines,
reference tests/loop_ref.np.txt:1–33). Covers ooe-expected,
expected-emission, coverage_norm, local, rescale, stripes (incl. stripe
planes + coordinates), trans, bedpe, and by_window.

Regenerate intentionally with REGEN_GOLDEN=1 after a VERIFIED numerics
change; a regenerated golden must be reviewed like a code change.
"""

import os

import numpy as np
import pytest

from fixtures import make_toy_cooler

import golden_cases as gc

GOLDEN = gc.GOLDEN


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "golden_toy.cool"
    return make_toy_cooler(str(path), seed=321)


def _check_or_freeze(name, got):
    """Compare `got` (dict of arrays) against the stored golden; freeze it
    on first run or under REGEN_GOLDEN=1."""
    path = os.path.join(GOLDEN, name + ".npz")
    if os.environ.get("REGEN_GOLDEN") or not os.path.exists(path):
        os.makedirs(GOLDEN, exist_ok=True)
        np.savez_compressed(path, **got)
        pytest.skip(f"golden {name} regenerated")
    gc.compare(name, got, rtol=0, atol=1e-10)


def _run(name, toy):
    _, build = gc.CASES[name]
    _check_or_freeze(name, build(*toy))


def test_golden_ooe(toy):
    _run("mode_ooe", toy)


def test_golden_expected_emission(toy):
    _run("mode_expected_emission", toy)


def test_golden_coverage_norm(toy):
    _run("mode_coverage_norm", toy)


def test_golden_local(toy):
    _run("mode_local", toy)


def test_golden_rescale(toy):
    _run("mode_rescale", toy)


def test_golden_stripes(toy):
    _run("mode_stripes", toy)


def test_golden_trans(toy):
    _run("mode_trans", toy)


def test_golden_bedpe(toy):
    _run("mode_bedpe", toy)


def test_golden_by_window(toy):
    _run("mode_by_window", toy)


def test_golden_controls(toy):
    """Shifted-control normalization (keyed RNG) — freezes the control
    division path end-to-end."""
    _run("mode_controls", toy)
