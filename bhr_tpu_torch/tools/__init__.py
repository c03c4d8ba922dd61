"""The tools that drive the package for its users, ported from ``tools/``.

Each runs as ``python -m bhr_tpu_torch.tools.<name>``, has
``main(argv=None)``, keeps the flags and output file names of the
``tools/<name>.py`` it ports and adds ``--device`` (default ``cuda``;
``cpu`` runs anywhere):

- ``check_texture``: the static or ``--dynamic`` disk texture as a polar
  map, a top view and a density map;
- ``preview_v2``: the V2 disk's top view and (r, z) cross-sections;
- ``compare_aa``: the same scene without and with ray-differential AA,
  side by side;
- ``rotation_experiments``: the disk-rotation strategies compared, with
  ``--verify`` asserting the conclusions;
- ``profile_pipeline``: per-stage ms of the FHD dynamic frame;

and the measurement tools built on ``bhr_tpu_torch.bench``'s helpers
(the same flags, plus size flags for small runs):

- ``bench_trace``: the ray-march kernel's Mray-steps/s and bound shares;
- ``bench_resolutions``: the bench frame at sd, hd, fhd and 4k;
- ``ablate_pipeline``: the bench frame with one stage knocked out;
- ``ablate_shade``, ``bench_shade_variants``: shade variants on one
  recorded trace of ``_diag_scene``'s FHD scene;
- ``cost_shade``: the shade's operations, bytes, launches and what
  bounds it.
"""
