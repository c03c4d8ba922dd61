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
- ``profile_pipeline``: per-stage ms of the FHD dynamic frame.
"""
