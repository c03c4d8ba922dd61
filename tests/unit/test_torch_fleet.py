"""The port's multi-process video fleet: two real processes on the CPU.

The counterpart of ``tests/unit/test_multihost_video.py``. Two OS
processes join a gloo group through ``initialize_multihost`` on a free
loopback port; each names the one CPU twice (``devices=[cpu, cpu]``, the
port's stand-in for JAX's virtual devices), so the grid has four slots.

* 9 frames in batches of 8 at 32x16 (the second batch is one frame and
  seven padding repeats, some on the other process): both exit 0, every
  PNG is written once and no padding frame, ``progress.json`` is
  complete, process 0 assembles the file.
* The PNG **bytes** equal a one-process run's over four slots, with one
  thread pinned in all of them. A second pass with ``resume`` renders
  nothing. Four V2 frames likewise.
* A non-video mode with ``--coordinator_address`` ends both processes
  with exit code 2 and "sharded orbit video".
* A failure injected into process 1's second batch ends it with exit
  code 1 and "aborting the fleet", and process 0 ends non-zero (its
  barrier fails when its peer's connection closes); neither prints past
  the failure.
* ``initialize_multihost(None)`` returns 1 and creates no group; a
  one-process group through the CLI renders and is torn down.

Every child has its own deadline and is killed past it, and writes its
output to a file (a full pipe would block it inside a collective).
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from bhr_tpu_torch import cli
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import video_temp_paths
from bhr_tpu_torch.parallel import mesh as tmesh
from bhr_tpu_torch.parallel.video import render_video_sharded

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# 9 frames over a 4-slot x 2-frames batch of 8: the second batch is 1
# real frame + 7 padding repeats, so padding lands on both processes.
N_FRAMES = 9
SCENE = dict(width=32, height=16, fov=60.0, step_size=0.2,
             disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
             orbit=True, video=True, fps=4, n_stars=64, device="cpu")

PRELUDE = """
import dataclasses, datetime, os, sys
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import torch
torch.set_num_threads(1)
from bhr_tpu_torch.parallel.mesh import initialize_multihost, process_index
n = initialize_multihost("127.0.0.1:" + port, 2, pid,
                         timeout=datetime.timedelta(seconds=60))
assert n == 2 and process_index() == pid, (n, process_index())
from bhr_tpu_torch.config import SceneConfig
import bhr_tpu_torch.parallel.video as V
from bhr_tpu_torch.ops import geodesic_cuda
calls = [0]
real_trace = geodesic_cuda.trace_geodesics
def counted(*a, **kw):
    calls[0] += 1
    return real_trace(*a, **kw)
geodesic_cuda.trace_geodesics = counted
CPUS = [torch.device("cpu")] * 2
scene = {scene!r}
"""

WORKER = PRELUDE + """
cfg = SceneConfig(n_frames={n_frames}, frames_per_dispatch=2,
                  output=os.path.join(outdir, "mh.mp4"), **scene).validated()
stats = V.render_video_sharded(cfg, devices=CPUS)
print("TRACES", pid, calls[0], stats["own_frames"], stats["padded"],
      stats["assembler"], flush=True)
# Second pass with resume=True: everything is complete, so this drives
# the broadcast resume arbitration (process 0 -> fleet) and the
# reassembly without rendering a single frame.
calls[0] = 0
stats = V.render_video_sharded(dataclasses.replace(cfg, resume=True),
                               devices=CPUS)
print("RESUMED", pid, calls[0], stats["frames"], flush=True)
# The V2 volume disk through the same fleet.
v2_cfg = dataclasses.replace(
    cfg, disk_model="v2", n_frames=4, frames_per_dispatch=1,
    output=os.path.join(outdir, "mh_v2.mp4"))
V.render_video_sharded(v2_cfg, devices=CPUS)
# A grid that leaves slots out is refused on every process.
try:
    V.render_video_sharded(dataclasses.replace(cfg, frame_shards=2),
                           devices=CPUS)
except ValueError as exc:
    print("REFUSED", pid, exc, flush=True)
# Leave the group as cli.main does, so no process exits while a peer's
# connection is still open.
from bhr_tpu_torch.parallel.mesh import fleet_barrier, shutdown_multihost
fleet_barrier()
shutdown_multihost()
print("WORKER_OK", pid, flush=True)
"""

FAIL_WORKER = PRELUDE + """
real = V.render_video_frames_sharded
batches = [0]
def inject(*a, **kw):
    batches[0] += 1
    if pid == 1 and batches[0] == 2:
        raise RuntimeError("injected-batch-failure")
    return real(*a, **kw)
V.render_video_frames_sharded = inject
cfg = SceneConfig(n_frames=16, frames_per_dispatch=1,  # 4 batches of 4
                  output=os.path.join(outdir, "fail.mp4"), **scene).validated()
V.render_video_sharded(cfg, devices=CPUS)
print("UNREACHABLE", pid, flush=True)
"""

GUARD_WORKER = """
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
from bhr_tpu_torch.cli import main
# A mode the fleet cannot share (no --video): every process must reject
# it after the fleet connects, instead of running duplicated renders.
main(["--device", "cpu", "--interactive", "-r", "sd", "-o", "x.png",
      "--coordinator_address", "127.0.0.1:" + port,
      "--num_processes", "2", "--process_id", str(pid)])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(root, script_text, args, deadline_s):
    """Start the script as processes 0 and 1 -> (processes, outputs).
    Each is waited for until the common deadline and killed past it."""
    script = root / "worker.py"
    script.write_text(script_text)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    logs = [root / f"worker{pid}.log" for pid in (0, 1)]
    procs = []
    for pid in (0, 1):
        with open(logs[pid], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(pid), port, *args],
                cwd=str(root), env=env, stdout=log, stderr=log))
    deadline = time.time() + deadline_s
    for p in procs:
        try:
            p.wait(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a fleet process outlived {deadline_s} s:\n" + "\n".join(
                log.read_text()[-2000:] for log in logs))
    return procs, [log.read_text() for log in logs]


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The 2-process video, its resume pass and its V2 video, once."""
    root = tmp_path_factory.mktemp("fleet")
    outdir = root / "out"
    outdir.mkdir()
    t0 = time.time()
    procs, outs = _run_pair(
        root, WORKER.format(scene=SCENE, n_frames=N_FRAMES), [str(outdir)], 300)
    print(f"fleet run: {time.time() - t0:.1f} s")
    return outdir, procs, outs


def _png_bytes(path, n):
    temp_dir = video_temp_paths(str(path))[0]
    names = sorted(f for f in os.listdir(temp_dir) if f.endswith(".png"))
    assert names == [f"frame_{f:04d}.png" for f in range(n)]
    out = []
    for name in names:
        with open(os.path.join(temp_dir, name), "rb") as f:
            out.append(f.read())
    return out


def _stat_line(out, tag):
    (line,) = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    return line.split()[2:]


def test_both_processes_succeed_and_share_the_frames(fleet_run):
    _, procs, outs = fleet_run
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {pid}" in out
    # Plain trace calls (the CPU's route) = frames rendered: 16 slots of
    # two batches, 8 a process; 9 written in all, 7 padding repeats.
    stats = [_stat_line(out, "TRACES") for out in outs]
    assert [int(s[0]) for s in stats] == [8, 8]
    assert [int(s[1]) for s in stats] == [5, 4]  # slots 0, 1 hold frame 8
    assert [int(s[2]) for s in stats] == [7, 7]
    # Process 0 assembles, the other names no assembler; only it prints.
    assert stats[0][3] in ("native", "ffmpeg", "mjpeg", "none")
    assert stats[1][3] == "None"
    assert "All frames rendered" in outs[0]
    assert "All frames rendered" not in outs[1]
    assert "Packing lifecycle" not in outs[1]


def test_all_frames_written_once_and_video_assembled(fleet_run):
    outdir, _, outs = fleet_run
    temp_dir = video_temp_paths(str(outdir / "mh.mp4"))[0]
    assert len(_png_bytes(outdir / "mh.mp4", N_FRAMES)) == N_FRAMES
    with open(os.path.join(temp_dir, "progress.json")) as f:
        progress = json.load(f)
    assert progress["completed"] == list(range(N_FRAMES))
    assert progress["params"]["sharded"] is True
    assembler = _stat_line(outs[0], "TRACES")[3]
    if assembler in ("native", "ffmpeg"):
        assert os.path.getsize(outdir / "mh.mp4") > 0
    elif assembler == "mjpeg":
        assert os.path.getsize(outdir / "mh.avi") > 0


def test_resume_pass_renders_nothing(fleet_run):
    _, _, outs = fleet_run
    for out in outs:
        assert _stat_line(out, "RESUMED") == ["0", "0"]
    assert f"Resuming: {N_FRAMES}/{N_FRAMES}" in outs[0]


def test_fleet_refuses_a_partial_grid(fleet_run):
    _, _, outs = fleet_run
    for out in outs:
        assert "frame_shards == all devices (4), got 2" in out


@pytest.fixture()
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_frames_equal_single_process_bytes(fleet_run, _one_thread):
    """A frame's content depends on neither its batch, its slot nor its
    process: the fleet's PNG files equal one process's byte for byte."""
    outdir, _, _ = fleet_run
    sp = outdir / "sp" / "sp.mp4"
    cfg = SceneConfig(n_frames=N_FRAMES, frames_per_dispatch=2, output=str(sp),
                      **SCENE).validated()
    stats = render_video_sharded(cfg, devices=[torch.device("cpu")] * 4)
    assert (stats["frames"], stats["own_frames"], stats["padded"]) == (9, 9, 7)
    ours, theirs = _png_bytes(sp, N_FRAMES), _png_bytes(outdir / "mh.mp4", N_FRAMES)
    assert [a == b for a, b in zip(ours, theirs)] == [True] * N_FRAMES
    assert len(set(ours)) == N_FRAMES  # the orbit moves


def test_v2_frames_equal_single_process_bytes(fleet_run, _one_thread):
    outdir, _, _ = fleet_run
    sp = outdir / "sp_v2" / "sp.mp4"
    cfg = SceneConfig(n_frames=4, frames_per_dispatch=1, disk_model="v2",
                      frame_shards=4, output=str(sp), **SCENE).validated()
    render_video_sharded(cfg, devices=[torch.device("cpu")] * 4)
    ours, theirs = _png_bytes(sp, 4), _png_bytes(outdir / "mh_v2.mp4", 4)
    assert [a == b for a, b in zip(ours, theirs)] == [True] * 4
    assert len(set(ours)) == 4


def test_fleet_rejects_unsupported_mode(tmp_path):
    """Both processes of a fleet asked for a mode it cannot share exit
    with argparse's error code (the CLI's multi-host mode guard)."""
    procs, outs = _run_pair(tmp_path, GUARD_WORKER, [], 120)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 2, f"process {pid}: rc={p.returncode}\n{out[-2000:]}"
        assert "sharded orbit video" in out, out[-2000:]
    assert "multi-host: 2 processes, 2 devices total" in outs[0]
    assert "multi-host:" not in outs[1]


def test_fleet_aborts_on_worker_failure(tmp_path):
    """A process that fails mid-run takes the whole fleet down loudly:
    what ``_abort_fleet_on_error`` prevents is the survivor waiting in
    the batch barrier."""
    outdir = tmp_path / "out"
    outdir.mkdir()
    t0 = time.time()
    procs, outs = _run_pair(tmp_path, FAIL_WORKER.format(scene=SCENE),
                            [str(outdir)], 150)
    print(f"abort: both processes gone after {time.time() - t0:.1f} s")
    assert procs[1].returncode == 1, outs[1][-2000:]
    assert "injected-batch-failure" in outs[1]
    assert "[process 1] fatal error, aborting the fleet:" in outs[1]
    assert procs[0].returncode != 0, outs[0][-2000:]
    assert "UNREACHABLE" not in outs[0] and "UNREACHABLE" not in outs[1]


def test_single_process_needs_no_group(tmp_path, capsys):
    assert tmesh.initialize_multihost(None) == 1
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_count(), tmesh.process_index()) == (1, 0)
    assert tmesh.fleet_slot_counts(3) == [3]
    tmesh.fleet_barrier()  # nothing to wait for
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tmesh.initialize_multihost("127.0.0.1:1")
    # A group of one through the CLI: announced, rendered, torn down.
    out = tmp_path / "one.png"
    assert cli.main(["--width", "32", "--height", "16", "--n_stars", "50",
                     "--device", "cpu", "-o", str(out), "--coordinator_address",
                     f"127.0.0.1:{_free_port()}", "--num_processes", "1",
                     "--process_id", "0"]) == 0
    assert "multi-host: 1 processes, 1 devices total" in capsys.readouterr().out
    assert out.is_file() and not torch.distributed.is_initialized()
