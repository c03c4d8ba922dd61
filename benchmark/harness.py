"""The benchmark's data, found by name, and one run of a cell.

``BENCHMARK.json`` at the checkout's root names the cells. A cell names
a configuration, ``configs/<config>.json`` (the scene's ``SceneConfig``
fields, its source, what was reduced or assumed, the comparison's
limits), and a traffic mix, ``traffic/<mix>.json`` (its parameters and
the name of its driver, ``drivers/<driver>.py``). Each per-layer metric
is ``metrics/<metric>.py`` with a ``read(rec)`` function of the run's
record. A new scene, mix or metric is new files plus new entries.

A driver module has ``setup(run)``, ``window(run, seconds)``,
``end_to_end(run)``, ``traced(run)``, ``release(run)`` and
``check(run)``; it calls the port only through ``SceneConfig``,
``modes.render_video``, ``InteractiveSession``, ``modes.render_image``
and ``utils.io.save_image`` (the still driver, which also times three of
the port's calls in its traced run and empties the static texture's
cache, ``utils.cache.DEFAULT_CACHE_DIR``, after each still). The still
driver hands ``render_image`` the traffic's ``tile_shards`` (row bands
over the cell's cards) with the scene, and checks every still against
the reference scene that ``reference/still.reference_scene`` chooses:
with AA the AA reference (``reference/frame_aa.py``), else the plain
one, the flare as the configuration states it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bhr_tpu")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return _load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def load_traffic(name: str) -> dict:
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_metric(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (names hold dots,
    so the file is loaded by its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, kind: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries reported in ``cell``."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot, taken
    whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


def scene_seed(seed: int) -> int:
    """The scene's seeds from ``--seed`` (NumPy's generators take any
    whole number from 0 to 2**64 - 1)."""
    return int(seed) % (2 ** 63)


class Run:
    """One run of a cell: its settings, its scratch directory under
    ``TMPDIR``, the state of the mix's driver module and the record the
    metrics read.

    ``overrides`` is the tests' path: ``{"device": "cpu", "scene": {...},
    "traffic": {...}}`` shrink a cell to run on the CPU."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 overrides: Optional[dict] = None, spec: Optional[dict] = None):
        overrides = overrides or {}
        self.spec = spec if spec is not None else load_benchmark()
        self.cell = find_cell(self.spec, workload)
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.chips = int(self.cell["chips"])
        self.config = load_config(self.cell["config"])
        self.traffic = dict(load_traffic(self.cell["traffic"]),
                            **overrides.get("traffic", {}))
        self.device = overrides.get("device", "cuda")
        scene = dict(self.config["scene"], **overrides.get("scene", {}))
        for key in self.config.get("seeded", ()):
            scene[key] = scene_seed(self.seed)
        scene["device"] = self.device
        self.scene = scene
        self.limits = dict(self.config["limits"])
        self.driver = load_driver(self.traffic["driver"])
        self.tmpdir = tempfile.mkdtemp(prefix="bench_")
        self.rec: Dict = {"jobs": [], "steps_ms": [],
                          "driver": self.traffic["driver"],
                          "disk_model": scene["disk_model"],
                          "n_devices": len(self.devices())}
        self.state: Dict = {}

    def scene_config(self, **changes):
        """The port's ``SceneConfig`` of this cell's scene."""
        from bhr_tpu_torch.config import SceneConfig

        return SceneConfig(**dict(self.scene, pov=tuple(self.scene["pov"]),
                                  **changes))

    def devices(self) -> List[str]:
        return ([f"cuda:{i}" for i in range(self.chips)]
                if self.device == "cuda" else ["cpu"])

    def close(self) -> None:
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def sync(run: Run) -> None:
    if run.device == "cuda":
        import torch

        for d in run.devices():
            torch.cuda.synchronize(d)


def now() -> float:
    return time.perf_counter()
