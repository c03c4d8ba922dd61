"""A frozen copy of the plain PyTorch and NumPy modules of
``bhr_tpu_torch`` that make a frame, taken when this benchmark was
defined: skybox, lifecycle disk, background noise, stats, compose, the
plain ray march, deferred shade, V2 volume shade, bloom: the functions
that the benchmark's cells reach, and no others (a cell that needs more,
such as a static texture, the AA mip path or the lens flare, brings its
copy with it). The copy keeps
the port's package layout so that its relative imports hold; it never
imports the port, and later changes to the port do not reach it.
"""
