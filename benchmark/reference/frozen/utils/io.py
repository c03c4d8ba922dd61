"""The one helper of the port's ``utils/io.py`` that a frame needs."""

import numpy as np


def compute_edge_alpha(height: int, inner_soft: float = 0.1, outer_soft: float = 0.3) -> np.ndarray:
    """Radial edge-softening alpha for an (n_r,) texture column.

    Cubic ramp over the inner `inner_soft` fraction, quadratic falloff over
    the outer `outer_soft` fraction.
    """
    v = np.linspace(0.0, 1.0, height).astype(np.float32)
    alpha = np.ones_like(v)
    inner = v < inner_soft
    outer = v > (1.0 - outer_soft)
    alpha[inner] = (v[inner] / inner_soft) ** 3.0
    alpha[outer] = ((1.0 - v[outer]) / outer_soft) ** 2.0
    return alpha
