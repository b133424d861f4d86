"""``jax.random``'s threefry draws, bitwise, in PyTorch.

The reference draws its shuffles, its pair samples and its baselines'
noise and initial values from ``jax.random`` (threefry2x32).  These
functions give the same bits from the same keys, on any device, without
JAX.  A key is raw key data, as ``jax.random.key_data`` gives it: a
(..., 2) array of uint32 words, numpy or torch (torch keys are int64
tensors holding the words, the form every function here returns).
Typed JAX keys are not taken.

Every function has a batched form: keys (R, 2) give R results stacked on a
leading axis, each bitwise the call on its own key, from one kernel launch
per hash (``repro_torch.kernels.threefry``).  ``partitionable`` selects
the counter layout of ``jax_threefry_partitionable``:

* ``True`` (the default) — jax 0.9.0's default, the installed
  reference's: ``_threefry_random_bits_partitionable`` and
  ``_threefry_split_foldlike`` over ``iota_2x32_shape``;
* ``False`` — the original layout, the default of the pinned
  ``jax<0.5``: ``_threefry_random_bits_original`` and
  ``_threefry_split_original`` (draws of fewer than 2**32 - 1 words).

``device`` is where the draw runs: a torch key's own device by default,
CUDA for a numpy key (and an error without one, as every entry point of
the port), unless the caller names another.  ``prng_key`` returns numpy
data, on no device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.threefry import (
    FOLD,
    MASK,
    ORIGINAL,
    PAIRS,
    XOR,
    permutation_rounds,
    threefry_bits,
    threefry_given,
    threefry_round,
    threefry_round_op,
    words,
)

_F32 = torch.float32


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data with x64 off: ``[0, seed mod
    2**32]`` (jax truncates the seed to 32 bits, so ``prng_key(-1)`` is
    ``[0, 0xFFFFFFFF]`` and ``prng_key(2**40 + 3)`` is ``[0, 3]``)."""
    return np.array([0, int(seed) & MASK], np.uint32)


def _device(key, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(key, torch.Tensor):
        return key.device
    from repro_torch.core.shufflesoftsort import resolve_device
    return resolve_device(None)


def as_keys(key, device=None) -> torch.Tensor:
    """Key data as an int64 tensor (..., 2) of uint32 words on
    ``device``."""
    dev = _device(key, device)
    if isinstance(key, torch.Tensor):
        t = key.to(dev)
        t = t.to(torch.int64) if t.dtype != torch.uint32 else \
            t.view(torch.int32).to(torch.int64)
    else:
        t = torch.as_tensor(np.asarray(key).astype(np.int64), device=dev)
    if t.dim() < 1 or t.shape[-1] != 2:
        raise ValueError(f"key data must be (..., 2), got {tuple(t.shape)}")
    return t & MASK


def key_data(keys) -> np.ndarray:
    """Keys as numpy uint32 data (..., 2), the reference's form."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    return np.asarray(keys).astype(np.int64).astype(np.uint32)


def _flat(key, device):
    k = as_keys(key, device)
    return k.reshape(-1, 2), tuple(k.shape[:-1])


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s)
                                                          for s in shape)


def threefry_2x32(key, count, *, device=None) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32(key, count)``: the hash of the words
    of ``count``, paired as its flat halves (padded with one 0 when odd),
    with one key (2,).  int64 words of ``count``'s shape, from one
    ``threefry_given`` launch on CUDA, which reads the count's words where
    they lie (no host read); the twin on the CPU."""
    k = as_keys(key, device).reshape(2)
    c = torch.as_tensor(np.asarray(count).astype(np.int64) if not
                        isinstance(count, torch.Tensor) else count,
                        device=k.device).to(torch.int64) & MASK
    flat = c.reshape(-1)
    out = threefry_given(k[None], flat)
    return words(out)[0].reshape(c.shape)


def _sort_words(key, shape, partitionable: bool, device) -> torch.Tensor:
    """``random_bits`` as the kernel writes them: int32 ``word -
    2**31``, in the words' unsigned order (``threefry_bits``)."""
    k, lead = _flat(key, device)
    shape = _shape(shape)
    out = threefry_bits(k, math.prod(shape), XOR if partitionable
                        else ORIGINAL)
    return out.reshape(*lead, *shape)


def random_bits(key, shape, *, partitionable: bool = True,
                device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 words, (*keys,
    *shape)."""
    return words(_sort_words(key, shape, partitionable, device))


def split(key, num: int = 2, *, partitionable: bool = True,
          device=None) -> torch.Tensor:
    """``jax.random.split(key, num)``: (*keys, num, 2) key data."""
    k, lead = _flat(key, device)
    out = threefry_bits(k, 2 * int(num), PAIRS if partitionable
                        else ORIGINAL)
    return words(out).reshape(*lead, int(num), 2)


def fold_in(key, data: int, *, device=None) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: each key's hash of the counter
    words ``(0, data mod 2**32)``, the seed words of a uint32 ``data``, in
    one launch of the kernel's ``FOLD`` layout.  One layout: jax folds in
    alike with ``jax_threefry_partitionable`` on or off.  (..., 2) key
    data in, the same shape out."""
    k, lead = _flat(key, device)
    return words(threefry_bits(k, 2, FOLD, int(data) & MASK)).reshape(
        *lead, 2)


def uniform(key, shape=(), minval=0.0, maxval=1.0, *,
            partitionable: bool = True, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    ``f * (maxval - minval) + minval`` rounded once, as the fused
    multiply-add XLA emits on the CPU (in float64, where the product is
    exact), and clipped below at ``minval``; float32 otherwise."""
    s = _sort_words(key, shape, partitionable, device)
    # word >> 9 from the sort word: its bits 31..9, the top one flipped back
    mant = ((s >> 9) & 0x7FFFFF) ^ 0x400000
    f = (mant | 0x3F800000).view(_F32) - 1.0
    lo = torch.tensor(minval, dtype=_F32, device=f.device)
    hi = torch.tensor(maxval, dtype=_F32, device=f.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's float32 erf_inv (Giles' single-precision approximation, as the
# CHLO decomposition of ``chlo.erf_inv`` writes it): a degree-8 polynomial
# in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv in XLA's polynomial; +-inf at +-1.  Each Horner
    step ``c + p * w`` is rounded once, as the fused multiply-add XLA emits
    on the CPU (evaluated in float64: the product is exact there)."""
    w = -torch.log1p((-x * x).double()).float()     # rounded from float64:
    lt = w < 5.0                                    # one value on any path
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    c_lt = torch.tensor(_ERFINV_LT5, dtype=_F32, device=x.device).double()
    c_ge = torch.tensor(_ERFINV_GE5, dtype=_F32, device=x.device).double()
    p = torch.where(lt, c_lt[0], c_ge[0])
    for i in range(1, 9):
        p = (torch.where(lt, c_lt[i], c_ge[i]) + p * w).float().double()
    return torch.where(x.abs() == 1.0, x * float("inf"), p.float() * x)


def normal(key, shape=(), *, partitionable: bool = True,
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform on (nextafter(-1, 0), 1).  Within 4
    ulp of the reference, not bitwise: XLA's ``log1p`` is not torch's
    (``tests/test_torch_threefry.py`` holds the gap)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, partitionable=partitionable,
                device=device)
    return torch.tensor(np.sqrt(2), dtype=_F32, device=u.device) * erf_inv(u)


def _mul32(a, b):
    """(a * b) mod 2**32 of int64 words, without int64 overflow."""
    lo = (a * (b & 0xFFFF)) & MASK
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key, shape, minval: int, maxval: int, *,
            partitionable: bool = True, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    words per value from ``split(key)``, reduced modulo the span with
    jax's uint32 wrap-around arithmetic."""
    lo_v, hi_v = int(minval), int(maxval)
    i32 = np.iinfo(np.int32)
    if not (i32.min <= lo_v <= i32.max and i32.min <= hi_v <= i32.max + 1):
        raise ValueError(f"randint range [{lo_v}, {hi_v}) leaves int32")
    k, lead = _flat(key, device)
    pair = split(k, partitionable=partitionable)
    shape = _shape(shape)
    higher = random_bits(pair[:, 0], shape, partitionable=partitionable)
    lower = random_bits(pair[:, 1], shape, partitionable=partitionable)
    out_of_range = hi_v > i32.max
    hi_c = min(hi_v, i32.max)
    span = (hi_c - lo_v) & MASK
    if hi_c <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:
        raise ValueError("randint over all of int32 is not supported")
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span     # uint32 wrap, as in jax
    offset = (_mul32(higher % span, torch.full_like(higher, mult))
              + lower % span) & MASK
    offset = offset % span
    val = (offset + lo_v) & MASK
    val = torch.where(val >= 2 ** 31, val - 2 ** 32, val)
    return val.to(torch.int32).reshape(*lead, *shape)


def _shuffle(words_, r: int, n: int, device) -> torch.Tensor:
    """``arange(n)`` per row through each round's stable sort (ties keep
    the earlier index first, as ``lax.sort_key_val(..., is_stable=True)``).
    int64 (r, n)."""
    x = torch.arange(n, dtype=torch.int64, device=device).repeat(r, 1)
    for sort_keys in words_:
        x = torch.gather(x, 1, torch.argsort(sort_keys, dim=1, stable=True))
    return x


def permutation(key, n: int, *, partitionable: bool = True,
                device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``_shuffle`` of ``arange(n)``,
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds of ``key, sub = split(key)``,
    32-bit sort keys from ``sub`` and a stable sort.  int64 (*keys, n).
    The sort words come from one ``repro_torch::threefry_round`` op (one
    kernel launch on CUDA), so ``meta`` keys give a ``meta`` shuffle."""
    k, lead = _flat(key, device)
    n = int(n)
    sort_words = threefry_round_op(k, n, permutation_rounds(n),
                                   bool(partitionable))
    return _shuffle(sort_words, k.shape[0], n, k.device).reshape(*lead, n)


def shuffle_round(keys, n: int, *, partitionable: bool = True):
    """One round of ``ThreefryShuffleSource``: ``keys, sub = split(keys)``
    and ``permutation(sub, n)``.  keys (R, 2) int64 -> (the kept keys (R,
    2), the (R, n) int64 shuffles); on CUDA one kernel launch."""
    n = int(n)
    kept, sort_words = threefry_round(keys, n, permutation_rounds(n),
                                      partitionable, True)
    return kept, _shuffle(sort_words, keys.shape[0], n, keys.device)
