"""Disk-rotation algorithm experiments.

The port of ``tools/rotation_experiments.py``: the rotation strategies
the reference evaluated (baseline per-row roll vs parametric
regeneration vs keyframe interpolation) re-run against this package's
implementations, plus per-component visualizations. On a GPU every
timing window ends in a synchronise.

Usage:
    python -m bhr_tpu_torch.tools.rotation_experiments [--n_phi 512]
        [--n_r 128] [--t 5.5] [--out output/rotation_experiments]
        [--verify] [--device cuda]

``--verify`` also asserts the suite's conclusions: the roll strategy
must beat full regeneration per frame, keyframe interpolation must show
real (but bounded) blending error, every component plane must advect
coherently under the per-row roll (phase-correlation peak at the
predicted Keplerian shift), and the rotating-coords background must stay
within the documented residual of the rigid roll. Exit 1 on any
violation.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import DEVICES, torch_device

COMPONENT_NAMES = [
    "temp_base", "spiral", "spiral_temp", "turbulence", "turb_temp",
    "arcs", "arcs_temp", "rt_spikes", "rt_temp", "hotspot",
    "hotspot_temp", "az_hotspot", "disturb_mod",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_phi", type=int, default=512)
    ap.add_argument("--n_r", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    # Non-integer default: at integer t the keyframe experiment
    # degenerates to frac=0 (bitwise-equal to the roll result) and
    # the interpolation error metric reads 0 without measuring.
    ap.add_argument("--t", type=float, default=5.5)
    ap.add_argument("--out", type=str, default="output/rotation_experiments")
    ap.add_argument("--verify", action="store_true",
                    help="assert the suite's conclusions (exit 1 on any "
                         "violation) — the verify_fix.py analogue")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)
    device = torch_device(args.device)

    def host(x) -> np.ndarray:
        """A tensor on the host (waits for the device's work on it)."""
        return x.cpu().numpy()

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    failures: list = []

    def check(ok: bool, msg: str) -> None:
        status = "ok" if ok else "FAIL"
        print(f"  verify [{status}] {msg}")
        if not ok:
            failures.append(msg)

    from ..models.disk_texture import build_parametric_state, compose_from_state
    from ..models.dynamic_disk import DynamicDiskSystem
    from ..utils.io import save_image

    os.makedirs(args.out, exist_ok=True)
    kw = dict(n_phi=args.n_phi, n_r=args.n_r, seed=args.seed,
              r_inner=2.0, r_outer=3.5, device=device)

    # --- Experiment 1: parametric state roll (the winning strategy) ----
    sync()
    t0 = time.time()
    state = build_parametric_state(**kw)
    sync()
    build_s = time.time() - t0
    # Warm up first, the keyframe times too: experiments 1 and 3 must run
    # warm, so that no first-call cost lands inside a timing window.
    host(compose_from_state(state, args.t))
    host(compose_from_state(state, float(np.floor(args.t))))
    host(compose_from_state(state, float(np.floor(args.t)) + 1.0))
    t0 = time.time()
    tex_roll = host(compose_from_state(state, args.t))
    host(compose_from_state(state, args.t + 0.1))
    roll_s = (time.time() - t0) / 2

    # --- Experiment 2: full regeneration at shifted phases -------------
    # (the reference's "parametric regen": regenerate everything with the
    # rotation baked into the sampling grid — here equivalent to
    # rebuilding the state; measures the cost the roll path avoids)
    t0 = time.time()
    state2 = build_parametric_state(**kw)
    sync()
    regen_s = time.time() - t0

    # --- Experiment 3: keyframe interpolation ---------------------------
    t0 = time.time()
    k0 = host(compose_from_state(state, float(np.floor(args.t))))
    k1 = host(compose_from_state(state, float(np.floor(args.t)) + 1.0))
    frac = args.t - np.floor(args.t)
    tex_keyframe = (1 - frac) * k0 + frac * k1
    key_s = time.time() - t0

    # --- Experiment 4: lifecycle dynamic system -------------------------
    dyn = DynamicDiskSystem(args.n_r, args.n_phi, 2.0, 3.5, seed=args.seed,
                            device=device)
    dyn.advance(0.0, 0.0, recompute_stats=True)
    sync()
    t0 = time.time()
    tex_dyn = host(dyn.advance(args.t, 0.1))
    dyn_s = time.time() - t0

    report = [
        "# Disk-rotation experiment report",
        "",
        "Run of bhr_tpu_torch.tools.rotation_experiments — the condensed "
        "re-run of the reference's disk_rotation_experiments/ suite "
        "(experiments 1-3 + component visualizations) against the "
        f"PyTorch port's implementations, on {device}.",
        "",
        f"Scene: n_phi={args.n_phi} n_r={args.n_r} seed={args.seed} "
        f"t={args.t}",
        "",
        "## Timings",
        "",
        "| strategy | ms/frame |",
        "|---|---|",
    ]

    def emit(label, text):
        print(text)
        report.append(f"| {label} | {text.split(':', 1)[1].strip()} |")

    emit("state build (once)",
         f"state build:            {build_s * 1000:8.1f} ms (once)")
    emit("1) parametric roll",
         f"1) parametric roll:     {roll_s * 1000:8.1f} ms/frame")
    emit("2) full regeneration",
         f"2) full regeneration:   {regen_s * 1000:8.1f} ms/frame")
    emit("3) keyframe interp",
         f"3) keyframe interp:     {key_s * 1000:8.1f} ms (2 keys + lerp)")
    emit("4) lifecycle dynamic",
         f"4) lifecycle dynamic:   {dyn_s * 1000:8.1f} ms/frame")
    diff = np.abs(tex_keyframe - tex_roll)
    err_line = (f"keyframe-vs-roll error: mean {diff.mean():.4f} "
                f"max {diff.max():.3f}")
    print(err_line)
    report += [
        "",
        "## Interpolation error",
        "",
        err_line,
        "",
        "## Verdict",
        "",
        "Same ranking as the reference's COMPLETION_REPORT: the "
        "parametric per-row roll (one take_along_axis over the "
        "precomputed component state) is the per-frame winner; full "
        "regeneration pays the whole compose cost every frame for no "
        "visual gain; keyframe interpolation costs two composes plus a "
        "lerp and introduces measurable blending error at fractional "
        "t. The production lifecycle system builds on strategy 1 "
        "(models/disk_texture.py compose_from_state) with the "
        "background layer regenerated in rotating noise coordinates "
        "(ops/background.py) — see the A/B section below.",
    ]

    for name, tex in (("roll", tex_roll), ("keyframe", tex_keyframe),
                      ("dynamic", tex_dyn)):
        save_image(tex[..., :3] * tex[..., 3:4],
                   os.path.join(args.out, f"tex_{name}.png"))

    # --- per-component visualization ------------------------------------
    comp = host(state.comp)
    omega = host(state.omega_rows)
    for idx, name in enumerate(COMPONENT_NAMES):
        plane = comp[idx]
        peak = plane.max() + 1e-9
        save_image(np.repeat((plane / peak)[..., None], 3, -1),
                   os.path.join(args.out, f"comp_{idx:02d}_{name}.png"))

    # --- per-component ROTATION strips ----------------------------------
    # The reference's visualize_all_components.py: each component shown
    # at several t offsets, verifying every plane advects coherently
    # (same structure, differentially rotated — not regenerated noise).
    t_offsets = [0.0, args.t * 0.25, args.t * 0.5, args.t * 0.75]
    sep = np.ones((2, args.n_phi, 3), np.float32)
    for idx, name in enumerate(COMPONENT_NAMES):
        plane = comp[idx]
        peak = plane.max() + 1e-9
        rows = []
        for t in t_offsets:
            rolled = _roll_plane(plane, omega, t)
            rows += [np.repeat((rolled / peak)[..., None], 3, -1), sep]
        save_image(np.concatenate(rows[:-1], axis=0),
                   os.path.join(args.out, f"rot_{idx:02d}_{name}.png"))

    # --- A/B: per-row roll vs background rotating-coordinates -----------
    # The lifecycle background regenerates its 7 wide-r components in
    # rotating (cos phi_rot, sin phi_rot, r) noise coordinates instead
    # of rolling precomputed planes (ops/background.py, reference
    # render.py:3362-3451). Both advect at the SAME Keplerian rate, so
    # the macro structure must line up; the residual combines the roll
    # path's integer-pixel quantization with the background's genuine
    # temporal evolution (its noise also moves through a time axis —
    # high-frequency layers decorrelate fastest, visible as fine grain
    # in the diff panel). Strip per component:
    # [rotating-coords @ t | rolled-from-t0 | 5x |diff|].
    from ..ops.background import generate_background_components

    bg_names = ["temp_base", "spiral", "spiral_temp", "turbulence",
                "turb_temp", "az_hotspot", "disturb_mod"]
    bg_kw = dict(az_freq=dyn.az_freq, az_shear=dyn.az_shear)
    bg0 = host(generate_background_components(
        args.n_r, args.n_phi, bg_kw["az_freq"], bg_kw["az_shear"],
        2.0, 3.5, 0.0, device=device))
    bgt = host(generate_background_components(
        args.n_r, args.n_phi, bg_kw["az_freq"], bg_kw["az_shear"],
        2.0, 3.5, args.t, device=device))
    print("\nA/B rotating-coords vs roll (per component, t="
          f"{args.t:.2f}):")
    report += [
        "",
        f"## A/B: rotating-coords background vs rigid roll (t={args.t:.2f})",
        "",
        "Residual = |rotating-coords @ t - rolled-from-t0|, normalized "
        "by the plane peak; combines the roll's integer-pixel "
        "quantization with the background noise's genuine temporal "
        "evolution.",
        "",
        "| component | mean | max |",
        "|---|---|---|",
    ]
    ab_residuals = {}
    for i, name in enumerate(bg_names):
        if name.startswith("spiral"):
            continue  # forced to zero in the background path
        rolled = _roll_plane(bg0[i], omega, args.t)
        d = np.abs(bgt[i] - rolled)
        scale = max(np.abs(bg0[i]).max(), 1e-9)
        ab_residuals[name] = float(d.mean() / scale)
        print(f"  {name:12s} mean {d.mean() / scale:.4f} "
              f"max {d.max() / scale:.3f} (of plane peak)")
        report.append(f"| {name} | {d.mean() / scale:.4f} "
                      f"| {d.max() / scale:.3f} |")
        lo, hi = bg0[i].min(), bg0[i].max() + 1e-9
        norm = lambda p: np.repeat(
            (np.clip((p - lo) / (hi - lo), 0, 1))[..., None], 3, -1)
        strip = np.concatenate(
            [norm(bgt[i]), sep, norm(rolled), sep,
             np.repeat(np.clip(5.0 * d / scale, 0, 1)[..., None], 3, -1)],
            axis=0,
        )
        save_image(strip, os.path.join(args.out, f"ab_{name}.png"))

    report += [
        "",
        "## Artifacts",
        "",
        "tex_{roll,keyframe,dynamic}.png, comp_NN_<name>.png (13 "
        "component maps), rot_NN_<name>.png (13 rotation strips at 4 "
        "t-offsets), ab_<name>.png (A/B strips: rotating-coords | "
        "rolled | 5x diff).",
    ]
    if args.verify:
        print("\nVerification (reference analogue: "
              "disk_rotation_experiments/verify_fix.py):")
        # 1) Ranking: the per-frame roll must beat full regeneration.
        check(roll_s < regen_s,
              f"parametric roll ({roll_s * 1e3:.1f} ms) beats full "
              f"regeneration ({regen_s * 1e3:.1f} ms) per frame")
        # 2) Keyframe interpolation shows REAL blending error at
        #    fractional t (zero would mean the experiment degenerated),
        #    but bounded — it still resembles the rolled texture.
        check(1e-6 < diff.mean() < 0.2,
              f"keyframe blending error measurable and bounded "
              f"(mean {diff.mean():.4f})")
        # 3) Advection correctness (the bug class the reference's suite
        #    existed to catch: rotation sign/rate): for every component
        #    with azimuthal structure, the circular cross-correlation
        #    of a rolled row against the original must peak exactly at
        #    the predicted Keplerian pixel shift.
        shift = (args.t * omega / (2.0 * np.pi) * args.n_phi).astype(int)
        for idx, name in enumerate(COMPONENT_NAMES):
            plane = comp[idx]
            rolled = _roll_plane(plane, omega, args.t)
            row = args.n_r // 3
            x = plane[row] - plane[row].mean()
            # Skip planes without azimuthal structure at this row
            # (disabled spiral slices; the radial-only temp base) —
            # a near-constant row correlates everywhere.
            if float(np.std(x)) < 0.01 * (float(np.abs(plane).max()) + 1e-9):
                continue
            y = rolled[row] - rolled[row].mean()
            corr = np.fft.ifft(
                np.fft.fft(y) * np.conj(np.fft.fft(x))
            ).real
            want = int(np.mod(-shift[row], args.n_phi))
            # The predicted Keplerian lag must be A maximum of the
            # circular cross-correlation ('a', not 'the': periodic
            # planes like the az-hotspot wave have one equal peak per
            # period — any of them certifies the same shift).
            check(corr[want] >= 0.999 * float(corr.max()),
                  f"{name}: rolled row correlation peaks at the "
                  f"predicted Keplerian shift (lag {want})")
        # 4) The rotating-coords background tracks the rigid roll
        #    within the documented residual envelope (macro structure
        #    aligned; high-frequency noise layers genuinely evolve).
        for name, frac in ab_residuals.items():
            check(frac < 0.35,
                  f"background {name}: rotating-coords vs roll mean "
                  f"residual {frac:.3f} of peak < 0.35")
        report += [
            "",
            "## Verification",
            "",
            f"--verify run: {len(failures)} failures. Checks: ranking "
            "(roll beats regen), bounded keyframe blending error, "
            "phase-correlation advection test per component (rotation "
            "sign + Keplerian rate), background residual envelope.",
        ]

    with open(os.path.join(args.out, "REPORT.md"), "w") as f:
        f.write("\n".join(report) + "\n")

    print(f"\nWrote textures + 13 component maps + 13 rotation strips "
          f"+ A/B strips + REPORT.md to {args.out}/")
    if failures:
        print(f"VERIFY FAILED ({len(failures)}):")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    return 0


def _roll_plane(plane: np.ndarray, omega_rows: np.ndarray,
                t: float) -> np.ndarray:
    """Per-row Keplerian phi-roll of one (n_r, n_phi) plane — the same
    integer-pixel shift the compose path applies
    (models/disk_texture._compose_from_components)."""
    n_phi = plane.shape[1]
    shift = (t * omega_rows / (2.0 * np.pi) * n_phi).astype(np.int64)
    cols = np.arange(n_phi)[None, :]
    src = np.mod(cols + shift[:, None], n_phi)
    return np.take_along_axis(plane, src, axis=1)


if __name__ == "__main__":
    sys.exit(main())
