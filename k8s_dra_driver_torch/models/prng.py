"""The part of ``jax.random`` the port uses, as integer tensor ops: the
threefry2x32 hash, ``PRNGKey``, ``fold_in``, ``split``, random bits in the
partitionable layout (``jax_threefry_partitionable=True``, the installed
jax's default), ``uniform`` in float32, the "low" Gumbel mode and
``categorical`` (``jax/_src/prng.py``, ``jax/_src/random.py``).

Bits and uniforms equal the reference's bit for bit; ``log`` is the
device's own, so Gumbel noise agrees with XLA's within a few float32 ulps.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  Every
value lives in int64 and is masked to 32 bits after each add and left
shift (torch has no uint32 add or shifts on the CPU, and signed 32-bit
overflow is not relied on).  Nothing here reads the device from the host
or makes a host scalar per call, so the functions run inside a captured
CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # float32 1.0
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))  # maxval - minval in float32
_iotas: dict = {}

# On the CPU, the first float32 ``log`` of a process that several threads
# run can come out less accurate (torch 2.13 with MKL: 4e-5 absolute on
# uniforms in about half of fresh processes, every later call right); one
# single-threaded call first makes every call right.
torch.log(torch.ones(1))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 hash of the counter pair ``(x0, x1)`` under ``key``
    (``[..., 2]``; its words broadcast against the counters as ``key[...,
    0]`` does): 20 rounds, a key injection after every 4.  Returns the two
    output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: ``(0, seed mod 2^32)``, an
    int64 ``[2]`` on the CPU (the engines copy it into their buffers)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(keys, data):
    """``vmap(jax.random.fold_in)(keys [B, 2], data [B])``: the hash of the
    counter pair ``(0, data mod 2^32)``.  Returns int64 ``[B, 2]``."""
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(keys, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _iota(shape, device):
    """The row-major index of each element of ``shape`` as its high and low
    32-bit words (``iota_2x32_shape``), built on ``device`` once per shape."""
    ent = _iotas.get((tuple(shape), str(device)))
    if ent is None:
        n = 1
        for d in shape:
            n *= d
        idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
        ent = _iotas[(tuple(shape), str(device))] = (idx >> 32, idx & MASK)
    return ent


def split(key, n: int):
    """``jax.random.split(key, n)`` in the partitionable layout: the hash
    of each index's high and low words.  Returns int64 ``[n, 2]``."""
    hi, lo = _iota((n,), key.device)
    y0, y1 = threefry2x32(key, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys, shape):
    """``jax.random.bits(key, shape, uint32)`` for each key of ``keys
    [..., 2]`` in the partitionable layout: the hash of each element's
    index, high word XOR low word.  Returns int64 ``[..., *shape]``."""
    hi, lo = _iota(shape, keys.device)
    batch = keys.shape[:-1]
    keys = keys.reshape(*batch, *([1] * len(shape)), 2)
    y0, y1 = threefry2x32(keys, hi, lo)
    return y0 ^ y1


def uniform(keys, shape):
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``,
    as the Gumbel draw asks for it: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into ``[tiny, 1)``."""
    bits = (random_bits(keys, shape) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * _SPAN + _TINY, _TINY)


def gumbel(keys, shape):
    """``jax.random.gumbel(key, shape, float32)`` in the "low" mode:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape)))


def categorical(keys, logits):
    """``vmap(jax.random.categorical)(keys [B, 2], logits [B, V])``: the
    argmax of the logits plus Gumbel noise, the first maximum on ties.
    Returns int64 ``[B]``."""
    return (gumbel(keys, logits.shape[-1:]) + logits).argmax(dim=-1)
