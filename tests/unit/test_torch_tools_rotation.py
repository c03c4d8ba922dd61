"""``rotation_experiments --verify`` of the port vs ``bhr_tpu``'s.

As ``test_torch_tools.py`` (whose runners this file uses). At 32x128 the
tool passes ``--verify`` in both packages and reaches the same
conclusions: the same checks, each ``ok``, in the same order (their
numbers, timings among them, aside). Its PNGs are textures (static:
1e-5; lifecycle: 1e-3) and component planes, so at most one uint8 step
apart. An integer ``--t`` degenerates the keyframe experiment, and the
port's ``--verify`` then exits 1. Most of the time here is ``bhr_tpu``'s
tool on the CPU (two eager state builds and two compiles of the
lifecycle step, ~45 s).
"""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_tools import (  # noqa: E402
    _few_threads,  # noqa: F401  (autouse fixture)
    assert_pngs_close,
    run_port,
    run_reference,
)


def _conclusions(out):
    """The --verify checks printed, with their numbers taken out."""
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line.strip())
            for line in out.splitlines() if line.strip().startswith("verify [")]


def test_rotation_experiments_verify_matches_bhr_tpu(tmp_path):
    args = ["--n_phi", "128", "--n_r", "32", "--verify"]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    rc, out = run_port("rotation_experiments", [*args, "--out", str(port_dir)])
    assert rc == 0, out
    rc_ref, out_ref = run_reference("rotation_experiments",
                                    [*args, "--out", str(ref_dir)])
    assert rc_ref == 0, out_ref
    ours, theirs = _conclusions(out), _conclusions(out_ref)
    assert len(ours) >= 10 and all("verify [ok]" in c for c in ours)
    assert ours == theirs
    pngs = sorted(f for f in os.listdir(ref_dir) if f.endswith(".png"))
    assert sorted(f for f in os.listdir(port_dir) if f.endswith(".png")) == pngs
    assert len(pngs) == 3 + 13 + 13 + 5
    for name in pngs:
        assert_pngs_close(str(port_dir / name), str(ref_dir / name))
    report = (port_dir / "REPORT.md").read_text()
    assert "## Verification" in report and "0 failures" in report


def test_rotation_experiments_verify_fails_on_a_violation(tmp_path):
    # At an integer t the keyframe experiment degenerates (its blending
    # error is 0): --verify must say so and exit 1.
    rc, out = run_port("rotation_experiments",
                       ["--n_phi", "128", "--n_r", "32", "--t", "5.0", "--verify",
                        "--out", str(tmp_path)])
    assert rc == 1
    assert "verify [FAIL] keyframe blending error" in out and "VERIFY FAILED" in out
