"""On-device token sampling, drawing the JAX reference's own random bits.

Counterpart of ``repro.serving.engine._sample_tokens`` and of the parts
of ``jax.random`` it uses: the threefry2x32 hash, ``PRNGKey``,
``fold_in``, the partitionable ``random_bits`` (JAX's default:
``jax_threefry_partitionable``), ``uniform``, ``gumbel`` (mode "low")
and ``categorical``. Row ``i`` of a batch draws from the per-request key
``fold_in(fold_in(PRNGKey(seed), rid_i), pos_i)``, so a request's
sampled stream depends on (seed, rid, positions, logits) alone, never
on the batch around it.

Torch has no 32-bit unsigned shifts, so every 32-bit word is held in an
int64 tensor (or a Python int) and masked to 32 bits after each add and
rotate. Everything runs as tensor ops on the logits' device with no
host synchronisation. Keys are ``(k1, k2)`` pairs of such words.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v, r: int):
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash, 20 rounds, with the key schedule and
    rotation constants of ``jax._src.prng._threefry2x32_lowering``.

    Every argument is a 32-bit word: a Python int or an int64 tensor
    holding values in [0, 2^32); tensors broadcast. Returns the pair of
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an integer seed: JAX takes the
    seed as a 32-bit integer, so the key is ``(0, seed mod 2^32)``."""
    return 0, int(seed) & _M32


def threefry_seed(data):
    """The key a 32-bit word seeds (``prng.threefry_seed``): ``(data
    >> 32, data & mask)``, i.e. ``(0, data)`` for 32-bit data."""
    return data >> 32, data & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: hash the key over the count pair that
    ``threefry_seed(data)`` makes. ``data`` is a 32-bit word or an int64
    tensor of them (a batch of keys)."""
    hi, lo = threefry_seed(data)
    return threefry2x32(key[0], key[1], hi, lo)


def random_bits(key, n: int, device) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of shape (..., n) under the
    partitionable scheme: element ``j``'s counter is its flat index as a
    (hi, lo) pair and its bits are the two hash words XORed. ``key``
    words may be batched tensors of shape (...,); they gain a trailing
    axis here."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    k1, k2 = (k[..., None] if isinstance(k, torch.Tensor) else k
              for k in key)
    b1, b2 = threefry2x32(k1, k2, lo >> 32, lo & _M32)
    return b1 ^ b2


def uniform(key, n: int, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """fp32 ``jax.random.uniform`` of shape (..., n) in [minval, maxval):
    the top 23 random bits as the mantissa of a float in [1, 2), minus 1,
    scaled and clamped below at ``minval``."""
    bits = random_bits(key, n, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * scale + minval, minval)


def gumbel(key, n: int, device) -> torch.Tensor:
    """fp32 ``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` of a
    uniform draw on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, device, _TINY, 1.0)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` along the last axis: the Gumbel-max
    draw ``argmax(logits + gumbel)`` (first index on ties), int64."""
    g = gumbel(key, logits.shape[-1], logits.device)
    return torch.argmax(g + logits, dim=-1)


def sample_tokens(logits: torch.Tensor, seed: int, rids: torch.Tensor,
                  positions: torch.Tensor, temperature: float,
                  top_k: int) -> torch.Tensor:
    """The engine's sampler: (B, V) logits -> (B,) int32 tokens.

    ``temperature == 0`` is the greedy argmax (decided here, on the
    host, from the engine's static configuration). Otherwise the fp32
    logits are scaled by the temperature, masked below the ``top_k``-th
    largest value (ties kept; 0 keeps the full softmax), and row ``i``
    draws from ``fold_in(fold_in(PRNGKey(seed), rids[i]),
    positions[i])``: ``rids`` and ``positions`` are (B,) integer tensors
    on the logits' device (request ids and the sampled token's absolute
    position).

    The reference divides by the temperature inside a jit, where XLA
    turns the division by a constant into a product with its fp32
    reciprocal; the product is taken here too."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    inv_t = float(np.float32(1.0) / np.float32(temperature))
    lg = logits.float() * inv_t
    if 0 < top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    key = fold_in(fold_in(prng_key(seed), rids.long() & _M32),
                  positions.long() & _M32)
    return categorical(key, lg).to(torch.int32)
