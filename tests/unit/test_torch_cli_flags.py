"""bhr_tpu's command lines in the port's CLI, and the port's build cache.

* Every option of ``bhr_tpu.cli.build_parser()`` (the deprecated ones
  too) is an option of the port's parser with the same destination,
  action and default, and a command line giving it parses; where it has
  choices, the port takes each of them, ``--device`` aside (the port's
  devices are ``cuda`` and ``cpu``; the one both take parses).
* ``main`` with ``--debug_nans --compile_cache`` renders with the NaN
  trap on and leaves it off; ``--no_compile_cache`` in a process of its
  own builds the host PNG library into a temporary directory, leaves
  ``bhr_tpu_torch/_build/`` as it was and removes the directory at exit.
* ``enable_compile_cache`` and ``disable_compile_cache`` round-trip the
  directory ``_build`` builds into.
"""

import os
import re
import subprocess
import sys

import pytest

from bhr_tpu import cli as jcli

from bhr_tpu_torch import _build, cli, native
from bhr_tpu_torch.utils import cache as tcache
from bhr_tpu_torch.utils import nans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _actions(parser):
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings}


JAX_ACTIONS = _actions(jcli.build_parser())


def test_port_parser_has_every_bhr_tpu_option():
    port = cli.build_parser()
    port_opts = {s for a in port._actions for s in a.option_strings}
    for opt, action in JAX_ACTIONS.items():
        assert set(action.option_strings) <= port_opts, opt
    for name in ("--debug_nans", "--compile_cache", "--no_compile_cache",
                 "--ignore_taichi_cache", "--keyframes_count",
                 "--disk_rotation_algorithm"):
        assert name in JAX_ACTIONS


def _value(action):
    """A command-line value ``bhr_tpu`` accepts for ``action``."""
    if action.choices:
        return [str(c) for c in action.choices]
    if action.default is None:
        return ["x" if action.type in (None, str) else "1"]
    if isinstance(action.default, list):
        return [" ".join(str(v) for v in action.default)]
    return [str(action.default)]


@pytest.mark.parametrize("opt", sorted(JAX_ACTIONS))
def test_each_bhr_tpu_option_parses_alike(opt):
    if opt == "-h":
        return
    ja = JAX_ACTIONS[opt]
    pa = {s: a for a in cli.build_parser()._actions for s in a.option_strings}[opt]
    assert (pa.dest, type(pa), pa.nargs) == (ja.dest, type(ja), ja.nargs)
    if opt != "--device":
        assert pa.default == ja.default
    if ja.nargs == 0:
        lines = [[opt]]
    else:
        values = _value(ja)
        if opt == "--device":
            assert set(pa.choices) & set(ja.choices) == {"cpu"}
            values = ["cpu"]
        lines = [[opt, *v.split()] for v in values]
    for argv in lines:
        jv = getattr(jcli.build_parser().parse_args(argv), ja.dest)
        pv = getattr(cli.build_parser().parse_args(argv), pa.dest)
        assert pv == jv, argv


def test_main_runs_bhr_tpu_flags_with_the_trap_on(tmp_path, monkeypatch):
    calls = []
    real = nans._count_nans
    monkeypatch.setattr(nans, "_count_nans",
                        lambda ts: calls.append(len(ts)) or real(ts))
    out = tmp_path / "t.png"
    assert not nans.debug_nans_enabled()
    rc = cli.main(["--debug_nans", "--compile_cache", "--device", "cpu",
                   "--width", "32", "--height", "18", "--n_stars", "50",
                   "-o", str(out)])
    assert rc == 0 and out.stat().st_size > 0
    assert not nans.debug_nans_enabled()
    # skybox, mips (the placeholder), disk_stats, disk_texture, mips,
    # trace, shade, post
    assert len(calls) == 8
    assert tcache.compile_cache_dir() == _build.BUILD_DIR
    # Without the flag, no check runs.
    calls.clear()
    assert cli.main(["--device", "cpu", "--width", "32", "--height", "18",
                     "--n_stars", "50", "-o", str(out)]) == 0
    assert calls == []


def test_main_restores_a_trap_set_by_the_caller(tmp_path):
    with nans.debug_nans():
        assert cli.main(["--device", "cpu", "--width", "32", "--height", "18",
                         "--n_stars", "50", "-o", str(tmp_path / "t.png")]) == 0
        assert nans.debug_nans_enabled()
    assert not nans.debug_nans_enabled()


def _listing(path):
    return {name: os.stat(os.path.join(path, name)).st_mtime_ns
            for name in os.listdir(path)}


def test_no_compile_cache_builds_privately(tmp_path):
    # The persistent cache holds the PNG library already, so a process
    # that read it would build nothing.
    assert native.png_available()
    before = _listing(_build.BUILD_DIR)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    out = tmp_path / "t.png"
    proc = subprocess.run(
        [sys.executable, "-m", "bhr_tpu_torch.cli", "--no_compile_cache",
         "--debug_nans", "--compile_cache", "--device", "cpu", "--width", "32",
         "--height", "18", "--n_stars", "50", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "TMPDIR": str(tmp)})
    assert proc.returncode == 0, proc.stderr
    built = re.findall(r"^built (\S+) in [0-9.]+ s", proc.stdout, re.M)
    assert len(built) == 1 and os.path.basename(built[0]).startswith("libfastpng_")
    private = os.path.dirname(built[0])
    assert os.path.dirname(private) == str(tmp)
    assert os.path.basename(private).startswith("bhr_tpu_torch_build_")
    assert not os.path.exists(private)  # removed at exit
    assert os.listdir(tmp) == []
    after = _listing(_build.BUILD_DIR)
    # Nothing in the persistent cache was rewritten or removed (another
    # test process may add a library of its own meanwhile).
    assert {k: after.get(k) for k in before} == before
    assert out.stat().st_size > 0


def test_compile_cache_switches_round_trip():
    assert tcache.compile_cache_dir() == _build.BUILD_DIR
    try:
        private = tcache.disable_compile_cache()
        assert tcache.compile_cache_dir() == private != _build.BUILD_DIR
        assert os.path.isdir(private) and os.listdir(private) == []
        built = _build.build_host("fastpng", *native._PNG_LINK_ATTEMPTS)
        assert os.path.dirname(built.path) == private and built.seconds > 0
        again = _build.build_host("fastpng", *native._PNG_LINK_ATTEMPTS)
        assert again.path == built.path and again.seconds == 0.0
        second = tcache.disable_compile_cache()
        assert second != private and tcache.compile_cache_dir() == second
    finally:
        tcache.enable_compile_cache()
    assert tcache.compile_cache_dir() == _build.BUILD_DIR
    tcache.enable_compile_cache(private)
    assert tcache.compile_cache_dir() == private
    tcache.enable_compile_cache()
    assert tcache.compile_cache_dir() == _build.BUILD_DIR
