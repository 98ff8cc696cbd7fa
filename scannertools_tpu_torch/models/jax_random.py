"""JAX's default PRNG (threefry2x32) and flax's parameter initializers, in
torch, so that the port draws the JAX package's default weights with no
JAX.

The semantics copied are those of jax 0.9.0 and flax 0.12.3:

  * A key is a pair of 32-bit words, ``uint32[2]`` in JAX; here an int64
    tensor ``[2]`` whose entries lie in [0, 2**32), on the device the
    draw is for. The hash runs on int64 tensors masked with 0xFFFFFFFF
    (torch's uint32 lacks shifts on CUDA), or on Python ints for a
    single count.
  * ``threefry2x32``: 20 rounds of Threefry-2x32 (Salmon et al., "Parallel
    random numbers: as easy as 1, 2, 3", SC 2011), rotations (13, 15, 26,
    6) and (17, 29, 16, 24), key schedule ``k1 ^ k2 ^ 0x1BD11BDA``, a key
    injection after every 4 rounds with the injection count added to the
    second word (jax/_src/prng.py ``_threefry2x32_lowering``).
  * ``jax_threefry_partitionable`` True (the default from jax 0.5): the
    bits of element i of a draw are ``threefry2x32(key, (hi, lo))`` of
    the 64-bit flat index i, the two outputs xor-ed; ``split(key, n)``
    gives key i as both outputs of ``threefry2x32(key, (0, i))``;
    ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``.
  * ``uniform``: the 23 high bits as a mantissa with exponent 0
    (``bits >> 9 | 0x3F800000`` viewed as float32), minus 1, scaled to
    [lo, hi) by a multiply-add rounded once to float32 (as XLA fuses it)
    and held at ``lo`` from below.
  * ``truncated_normal(-2, 2)``: ``sqrt(2) * erfinv(u)`` with u uniform in
    [erf(-sqrt 2), erf(sqrt 2)), clamped inside the bounds by one ulp.
    XLA evaluates ``erf_inv`` in float32 by a polynomial; here it is
    evaluated in float64 and rounded to float32, so a value may differ
    from JAX's in its last bits (at most 3e-8 on draws of unit scale);
    the keys and bits are exact.
  * flax's ``_fold_in_static`` (flax/core/scope.py): a parameter's key is
    its module's root key folded once with the first 4 bytes (big-endian)
    of the SHA-1 of its scope path's names and its ``make_rng("params")``
    counter within the scope, encoded with no separator
    (``flax_fix_rng_separator`` False).
  * flax's initializers: ``lecun_normal`` for every ``Dense``/``Conv``/
    ``ConvTranspose`` kernel (variance 1 / fan in, a normal truncated to
    +-2 over its standard deviation 0.87962566103423978), zeros for
    biases, ones for BatchNorm scales; ``he_normal`` is the same with
    variance 2 / fan in. The fans are JAX's: the last axis is the output,
    the one before it the input, the others the receptive field.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterable, Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


# On the CPU a draw works in pieces small enough that torch runs each
# operation on the calling thread: its elementwise kernels go parallel
# from 32768 elements (the grain size), its vectorized float64 math
# (erfinv) from 2048. A parallel region a small operation stalls when
# processes share the cores (scripts/default_draw_cpu_timing.py: six
# FaceNet draws at once on 8 cores took 65-67 s each with erfinv a call a
# chunk, 6.6-8.9 s in these pieces, 4.5-5.1 s alone). On a card one chunk
# amortizes the launches.
_CPU_CHUNK, _CPU_MATH_PIECE, _CARD_CHUNK = 1 << 14, 1 << 11, 1 << 22


def _chunk(device: torch.device) -> int:
    """Elements a draw hashes at a time on ``device``."""
    return _CPU_CHUNK if device.type == "cpu" else _CARD_CHUNK


def _erfinv(u: torch.Tensor) -> torch.Tensor:
    """``torch.special.erfinv``; on the CPU a piece of _CPU_MATH_PIECE at
    a time."""
    if u.device.type != "cpu":
        return torch.special.erfinv(u)
    return torch.cat([torch.special.erfinv(p)
                      for p in u.split(_CPU_MATH_PIECE)])


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the count pairs (x0, x1) under the key
    (k1, k2) -> its two output words. The words are Python ints or int64
    tensors in [0, 2**32), broadcast together."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & MASK)
    a = (x0 + ks[0]) & MASK
    b = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) & MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off, on ``device``:
    the seed as a 32-bit integer in the low word, the high word 0."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = key.tolist()
    return k1, k2


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` -> keys [n, 2] on the key's device."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return torch.stack(threefry2x32(*_words(key), torch.zeros_like(lo), lo),
                       -1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    a, b = threefry2x32(*_words(key), 0, int(data) & MASK)
    return torch.tensor([a, b], dtype=torch.int64, device=key.device)


def _hash_chunks(key: torch.Tensor, n: int, finish) -> torch.Tensor:
    """``finish(bits)`` of each chunk of the n elements' bits (int64
    words), written in order into one flat tensor."""
    k1, k2 = _words(key)
    chunk = _chunk(key.device)
    out = None
    for start in range(0, max(n, 1), chunk):
        stop = min(n, start + chunk)
        idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
        a, b = threefry2x32(k1, k2, idx >> 32, idx & MASK)
        part = finish(a ^ b)
        if out is None:
            out = part.new_empty(n)
        out[start:stop] = part
    return out


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 words."""
    shape = tuple(int(s) for s in shape)
    return _hash_chunks(key, math.prod(shape), lambda w: w).reshape(shape)


def _uniform_finish(lo: float, hi: float):
    """A chunk's bits -> its uniform float32 draws in [lo, hi): the 23
    high bits as a mantissa in [1, 2), minus 1, times ``hi - lo`` plus
    ``lo`` in one rounding (XLA fuses the two into a multiply-add; the
    float64 product of two float32 values is exact), held at ``lo`` from
    below."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span, low = float(hi32 - lo32), float(lo32)

    def finish(w):
        f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
            - 1.0
        return (f.double() * span + low).float().clamp_(min=low)

    return finish


def uniform(key: torch.Tensor, shape: Sequence[int], lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``."""
    shape = tuple(int(s) for s in shape)
    return _hash_chunks(key, math.prod(shape), _uniform_finish(
        lo, hi)).reshape(shape)


def _trunc_bounds(lower: float, upper: float) -> Tuple[float, float]:
    """erf(lower / sqrt 2) and erf(upper / sqrt 2) as float32, the bounds
    of the uniform draw."""
    sqrt2 = np.float32(np.sqrt(2))
    return tuple(float(np.float32(math.erf(float(np.float32(v) / sqrt2))))
                 for v in (lower, upper))


def _trunc_flat(key: torch.Tensor, n: int, lower: float, upper: float,
                scale=np.float32(1)) -> torch.Tensor:
    """n truncated normal draws times ``scale``, float32, each chunk
    finished where it was hashed."""
    uniform = _uniform_finish(*_trunc_bounds(lower, upper))
    sqrt2 = float(np.float32(np.sqrt(2)))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    scale = float(np.float32(scale))

    def finish(w):
        out = sqrt2 * _erfinv(uniform(w).double()).float()
        return out.clamp_(lo, hi) * scale

    return _hash_chunks(key, n, finish)


def truncated_normal(key: torch.Tensor, shape: Sequence[int],
                     lower: float = -2.0, upper: float = 2.0
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)``, float32:
    the inverse error function in float64, rounded to float32."""
    shape = tuple(int(s) for s in shape)
    return _trunc_flat(key, math.prod(shape), lower, upper).reshape(shape)


def fold_in_static(key: torch.Tensor, suffix: Iterable[Union[str, int]]
                   ) -> torch.Tensor:
    """flax's ``_fold_in_static``: ``key`` folded with the SHA-1 of the
    suffix's names and counters (no separator); no suffix, no fold."""
    suffix = tuple(suffix)
    if not suffix:
        return key
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected int or string, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


# ---------------------------------------------------------- initializers

def fans(shape: Sequence[int]) -> Tuple[float, float]:
    """JAX's ``_compute_fans`` with in_axis -2, out_axis -1: (fan in, fan
    out), each times the receptive field (the other axes' product)."""
    if len(shape) < 2:
        raise ValueError(f"no fans for a {len(shape)}-d weight")
    rf = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * rf, shape[-1] * rf


def variance_scaling(key: torch.Tensor, shape: Sequence[int],
                     scale: float) -> torch.Tensor:
    """``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    shape = tuple(int(s) for s in shape)
    variance = np.float32(scale / max(1.0, fans(shape)[0]))
    std = np.sqrt(variance) / np.float32(_TRUNC_STD)
    return _trunc_flat(key, math.prod(shape), -2.0, 2.0, std).reshape(
        shape)


def lecun_normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return variance_scaling(key, shape, 1.0)


def he_normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return variance_scaling(key, shape, 2.0)


def zeros(key, shape: Sequence[int], device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def ones(key, shape: Sequence[int], device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


def constant(key, shape: Sequence[int], value: float,
             device) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=torch.float32,
                      device=device)
