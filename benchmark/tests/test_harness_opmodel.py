"""The op model's frozen copy against hand arithmetic."""

from __future__ import annotations

import pytest
import torch

from benchmark import opmodel


def test_constants_are_the_frozen_copy():
    assert opmodel.STEP_OPS == {"slim": 170, "aa": 170, "nodisk": 165}
    assert opmodel.DIFF_STEP_OPS == {"slim": 0, "aa": 336, "nodisk": 0}
    assert opmodel.RAY_OPS == {"slim": 63, "aa": 127, "nodisk": 63}
    assert opmodel.ESCAPE_OPS == 10
    assert opmodel.HIT_OPS == {"slim": 13, "aa": 31, "nodisk": 0}
    assert opmodel.RAY_BYTES == 210
    assert (opmodel.PEAK_FP32, opmodel.PEAK_BYTES) == (67e12, 3.35e12)


def test_trace_work_counts():
    steps = torch.tensor([10, 20, 5], dtype=torch.int32)
    captured = torch.tensor([True, False, False])
    escaped = torch.tensor([False, True, False])
    hits = torch.tensor([1, 2, 0], dtype=torch.int32)
    assert opmodel.trace_work(steps, captured, escaped, hits) == {
        "rays": 3, "steps": 35, "terminated": 2, "escaped": 1, "hits": 3}


def test_fhd_slim_bound_by_hand():
    # The FHD orbit frame at tilt 0 as the plain tracer counts it.
    work = {"rays": 2073600, "steps": 150264136, "terminated": 2073600,
            "escaped": 1873268, "hits": 1387646}
    ops = (170 * 150264136 + 63 * 2073600 + 10 * 1873268 + 13 * 1387646)
    ms, kind = opmodel.bound_ms("slim", work)
    assert kind == "operations"
    assert ms == pytest.approx(ops / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.383766, rel=1e-5)


def test_aa_counts_differentials_on_surviving_steps():
    work = {"rays": 10, "steps": 100, "terminated": 10, "escaped": 4, "hits": 6}
    ms, _ = opmodel.bound_ms("aa", work)
    ops = 170 * 100 + 336 * 90 + 127 * 10 + 10 * 4 + 31 * 6
    assert ms * 67e12 / 1e3 == pytest.approx(max(ops, (56 + 2100) * 67e12 / 3.35e12))


def test_bytes_bound_where_few_steps():
    work = {"rays": 1000, "steps": 1000, "terminated": 1000, "escaped": 1000,
            "hits": 0}
    ms, kind = opmodel.bound_ms("slim", work)
    assert kind == "bytes"
    assert ms == pytest.approx((56 + 1000 * 210) / 3.35e12 * 1e3)
