"""Counter-based random numbers: a frozen copy of the port's
``ops/random.py`` (the ``jax.random`` draws of ``bhr_tpu``, bit for bit in
torch), which the static disk's generators draw from.

Threefry-2x32 (20 rounds; Salmon et al., SC 2011) in JAX's partitionable
layout (``jax_threefry_partitionable``, JAX's default since 0.5):

* a key is a (2,) int64 tensor holding two uint32 words; the key of a
  seed is ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)`` hashes the counters (0, i), i < n, and stacks the two
  output words as the n new keys; ``fold_in(key, d)`` hashes (0, d);
* the 32 random bits of a shape hash the counters (0, i) over the flat
  index i and XOR the two output words.

torch has no uint32 arithmetic, so words are int64 and every add, multiply
and rotate is masked to 32 bits: exact on the CPU and on CUDA, so a draw's
bits are the same on either device. Keys are small and live on the CPU,
hashed in host integers; a draw makes its counters and its values on the
``device`` it is asked for.

``uniform`` rounds ``f * (maxval - minval) + minval`` once, as XLA's fused
multiply-add does on the CPU (JAX's own draws), by evaluating it in
float64: the product is exact there and, for the ranges drawn here, so is
the sum. ``beta`` runs Marsaglia-Tsang's gamma sampler as JAX does (keys
split per element, the boost for alpha < 1, nested rejection loops,
``normal`` through XLA's float32 ``erfinv``), with all elements stepped
together on the host in float32; it returns its draws on ``device``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> torch.Tensor:
    """The key of an integer seed (``jax.random.PRNGKey``), on the CPU."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pairs (x0, x1) under the key (k0, k1):
    host ints, numpy int64 arrays or int64 tensors holding uint32 words,
    broadcast against each other. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(n: int, device) -> torch.Tensor:
    if n >= 2 ** 32:
        raise ValueError(f"{n} counters: more than 2**32 are not supported")
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys on the CPU, hashed in host
    integers (a few microseconds a counter, where tensor arithmetic would
    cost a launch an operation)."""
    k0, k1 = (int(w) for w in key.tolist())
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with one integer."""
    k0, k1 = (int(w) for w in key.tolist())
    return torch.tensor(threefry2x32(k0, k1, 0, int(data) & _MASK),
                        dtype=torch.int64)


def random_bits(key: torch.Tensor, shape: Sequence[int] = (), *,
                device) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), as int64 in
    [0, 2**32), made on ``device``."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = (int(w) for w in key.tolist())
    b0, b1 = threefry2x32(k0, k1, 0, _counters(math.prod(shape), device))
    return (b0 ^ b1).reshape(shape)


def random_bits_rows(keys: Sequence[torch.Tensor], n: int, device) -> torch.Tensor:
    """``random_bits(keys[b], (n,), device)`` for every key, as the rows of
    one (len(keys), n) tensor made in one hash. A draw's bits at counter i
    do not depend on its size, so the first m columns of a row are the key's
    draw of m (a draw of shape () is column 0)."""
    k = torch.stack(list(keys)).to(device)
    b0, b1 = threefry2x32(k[:, 0:1], k[:, 1:2], 0, _counters(n, device))
    return b0 ^ b1


def random_bits_many(keys: Sequence[torch.Tensor], shapes: Sequence[Sequence[int]],
                     device) -> List[torch.Tensor]:
    """``[random_bits(k, s, device) for k, s in zip(keys, shapes)]`` from one
    hash (:func:`random_bits_rows` to the largest size; each its prefix)."""
    sizes = [math.prod(int(d) for d in s) for s in shapes]
    bits = random_bits_rows(keys, max(sizes), device)
    return [bits[i, :n].reshape(tuple(s)) for i, (n, s) in enumerate(zip(sizes, shapes))]


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``'s float32 values from its 32-bit draw: 23
    mantissa bits over 1.0, less 1, scaled with one rounding."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    out = (f.to(torch.float64) * span + float(lo)).to(torch.float32)
    return torch.clamp(out, min=float(lo))


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0, *, device) -> torch.Tensor:
    """``jax.random.uniform`` in float32, bit for bit."""
    return uniform_from_bits(random_bits(key, shape, device=device), minval, maxval)


def randint_from_bits(hi_bits: torch.Tensor, lo_bits: torch.Tensor,
                      minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint``'s int32 values from its two bit draws,
    reduced modulo the span with uint32 wrap-around."""
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2 ** 16 % span) ** 2 % span
    offset = (((hi_bits % span) * multiplier) & _MASK) + lo_bits % span
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int, *,
            device) -> torch.Tensor:
    """``jax.random.randint`` (int32), bit for bit: two bit draws from the
    key's split."""
    k1, k2 = split(key)
    return randint_from_bits(random_bits(k1, shape, device=device),
                             random_bits(k2, shape, device=device), minval, maxval)


# ---------------------------------------------------------------------------
# beta through two log-gamma draws (jax.random.beta / loggamma), on the host.
# ---------------------------------------------------------------------------

_F32 = torch.float32
# XLA's float32 erf_inv (Giles, "Approximating the erfinv function", 2010):
# the polynomial coefficients for w < 5 and w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a float32 tensor evaluated in float64 and rounded once:
    the same float32 result whichever of torch's vector or scalar paths
    (they differ by an ulp, and which one an element takes depends on the
    threading) runs it."""
    return fn(x.to(torch.float64)).to(_F32)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``jax.scipy.special.erfinv``): Giles'
    single-precision polynomial, each Horner step one rounding (XLA fuses
    it into a multiply-add). ``torch.erfinv`` differs by ulps, which can
    move a gamma sampler's rejection decision."""
    x = x.to(_F32)
    w = -_f32(torch.log1p, -(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    coef = [torch.where(small, torch.tensor(a, dtype=_F32), torch.tensor(b, dtype=_F32))
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = (c.to(torch.float64) + p.to(torch.float64) * w).to(_F32)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _split_host(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``split`` of each of a batch of host keys (N, 2) -> (N, num, 2),
    hashed with numpy (an operation on a few hundred words costs about a
    microsecond there, several times less than a torch CPU launch)."""
    b0, b1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], 0, np.arange(num, dtype=np.int64))
    return np.stack([b0, b1], axis=-1)


def _uniform_scalar(keys: np.ndarray, minval=0.0, maxval=1.0) -> torch.Tensor:
    """A ``uniform`` draw of shape () under each of a batch of host keys."""
    b0, b1 = threefry2x32(keys[:, 0], keys[:, 1], 0, 0)
    return uniform_from_bits(torch.from_numpy(b0 ^ b1), minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
_THIRD = float(np.float32(1.0 / 3.0))


def _loggamma(keys: np.ndarray, alpha: torch.Tensor) -> torch.Tensor:
    """log of one Gamma(alpha) draw per host key (JAX's ``_gamma_one`` in
    log space), every element stepped together; finished elements keep
    their state, as under ``vmap`` of its ``while_loop``s."""
    boost = alpha >= 1.0
    alpha_b = torch.where(boost, alpha, alpha + 1.0)
    d = alpha_b - _THIRD
    c = _THIRD / torch.sqrt(d)
    ks = _split_host(keys)
    key, subkey = ks[:, 0], ks[:, 1]
    n = alpha.shape[0]
    X = torch.zeros(n, dtype=_F32)
    V = torch.ones(n, dtype=_F32)
    U = torch.full((n,), 2.0, dtype=_F32)

    def rejected(X, V, U):
        return ((U >= 1.0 - 0.0331 * (X * X))
                & (_f32(torch.log, U) >= X * 0.5 + d * ((1.0 - V) + _f32(torch.log, V))))

    active = rejected(X, V, U)
    while bool(active.any()):
        k3 = _split_host(key, 3)
        key_next, x_key, u_key = k3[:, 0], k3[:, 1], k3[:, 2]
        x = torch.zeros(n, dtype=_F32)
        v = torch.full((n,), -1.0, dtype=_F32)
        inner = v <= 0.0
        while bool(inner.any()):
            k2 = _split_host(x_key)
            u = _uniform_scalar(k2[:, 1], _NORMAL_LO, 1.0)
            x_new = _SQRT2 * erfinv(u)
            v_new = 1.0 + x_new * c
            x_key = np.where(inner.numpy()[:, None], k2[:, 0], x_key)
            x = torch.where(inner, x_new, x)
            v = torch.where(inner, v_new, v)
            inner = v <= 0.0
        key = np.where(active.numpy()[:, None], key_next, key)
        X = torch.where(active, x * x, X)
        V = torch.where(active, (v * v) * v, V)
        U = torch.where(active, _uniform_scalar(u_key), U)
        active = rejected(X, V, U)
    log_samples = _f32(torch.log1p, -_uniform_scalar(subkey))  # -exponential
    log_boost = torch.where(boost | (log_samples == 0.0), torch.zeros_like(alpha),
                            log_samples * (1.0 / alpha))
    return (_f32(torch.log, d) + _f32(torch.log, V)) + log_boost


def beta(key: torch.Tensor, a: float, b: float, shape: Sequence[int], *,
         device) -> torch.Tensor:
    """``jax.random.beta`` (float32): Gamma(a) / (Gamma(a) + Gamma(b)) from
    two log-gamma draws, combined in log space. Sampled on the host (at
    most a few hundred draws, each a data-dependent rejection loop); the
    result moves to ``device`` once."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    key_ab = _split_host(key.numpy()[None])[0]
    keys_a, keys_b = (_split_host(k[None], n)[0] for k in key_ab)
    log_a = _loggamma(keys_a, torch.full((n,), float(a), dtype=_F32))
    log_b = _loggamma(keys_b, torch.full((n,), float(b), dtype=_F32))
    log_max = torch.maximum(log_a, log_b)
    ga = _f32(torch.exp, log_a - log_max)
    gb = _f32(torch.exp, log_b - log_max)
    return (ga / (ga + gb)).reshape(shape).to(device)
