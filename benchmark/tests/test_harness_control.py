"""The control of the comparison: the reference in bfloat16 in the
program's place must come out as not correct, for every cell (each
driver's frames, ``calibrate.FRAMES``: video, the AA video, session,
still), here at a tiny size on the CPU (on the card at the cells' own
size: ``python3 -m benchmark.calibrate``). An anti-aliased still's
other controls are in ``test_harness_still_tiled.py``."""

from __future__ import annotations

import pytest

from benchmark import calibrate, harness
from conftest import tiny

SPEC = harness.load_benchmark()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_the_control_fails_a_limit(in_workdir, cell):
    driver = harness.load_traffic(cell["traffic"])["driver"]
    got = calibrate.control_numbers(cell["name"], 23, overrides=tiny(driver))
    limits = harness.load_config(cell["config"])["limits"]
    assert got["failed"] > 0
    assert any(got[n] > limits[n] for n in limits), (got, limits)


def test_a_driver_without_a_control_is_refused(monkeypatch):
    real = harness.load_traffic
    monkeypatch.setattr(harness, "load_traffic",
                        lambda name: dict(real(name), driver="unknown"))
    with pytest.raises(ValueError, match="unknown"):
        calibrate.control_numbers("fhd_lifecycle.still", 23)
