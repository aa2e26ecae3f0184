"""MSB-first bit/byte packing + repetition coding (modem.js:460-495).

Two implementations of each op:

* numpy — host path for protocol byte work (fast, vectorized).
* jnp   — device path used inside jitted decode pipelines so the bits never
  leave the device between demap and majority vote.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_BIT_SHIFTS = np.arange(7, -1, -1, dtype=np.uint8)  # MSB first


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """MSB-first unpack: bytes -> int8 bit array (modem.js:460-466)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8)
    return np.unpackbits(arr).astype(np.int8)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """MSB-first pack; trailing partial byte dropped (modem.js:468-476)."""
    bits = np.asarray(bits).astype(np.uint8)
    n = (bits.size // 8) * 8
    if n == 0:
        return b""
    return np.packbits(bits[:n]).tobytes()


def repeat_bits(bits: np.ndarray, n: int) -> np.ndarray:
    """Repetition code: each bit n times (modem.js:479-485)."""
    return np.repeat(np.asarray(bits), n)


def majority_vote(bits: np.ndarray, n: int) -> np.ndarray:
    """Majority decode with the reference's tie rule sum >= n/2 -> 1
    (modem.js:487-495). Trailing partial group dropped."""
    bits = np.asarray(bits)
    m = bits.size // n
    groups = bits[: m * n].reshape(m, n)
    return (groups.sum(axis=1) * 2 >= n).astype(np.int8)


def soft_combine(soft: np.ndarray, n: int) -> np.ndarray:
    """Soft repetition decode: sum each transmitted bit's n soft metrics,
    decide by sign (BPSK convention: metric < 0 -> bit 1, so a hard single
    copy reduces to the plain demap). The maximum-ratio analog of
    majority_vote — a low-confidence flipped copy can no longer outvote a
    high-confidence one; ~2 dB better than hard voting at n = 3.
    Trailing partial group dropped."""
    soft = np.asarray(soft, np.float64)
    m = soft.size // n
    groups = soft[: m * n].reshape(m, n)
    return (groups.sum(axis=1) < 0).astype(np.int8)


# --- device (jnp) versions ---


def jnp_bits_to_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 8k] bits -> [..., k] uint8 bytes, MSB-first, on device."""
    *lead, nb = bits.shape
    k = nb // 8
    b = bits[..., : k * 8].reshape(*lead, k, 8).astype(jnp.uint8)
    weights = (2 ** jnp.arange(7, -1, -1, dtype=jnp.uint8)).astype(jnp.uint8)
    return (b * weights).sum(axis=-1).astype(jnp.uint8)


def jnp_majority_vote(bits: jnp.ndarray, n: int) -> jnp.ndarray:
    """Majority vote on device, tie -> 1, matching modem.js:487-495."""
    *lead, nb = bits.shape
    m = nb // n
    groups = bits[..., : m * n].reshape(*lead, m, n)
    return (groups.sum(axis=-1) * 2 >= n).astype(jnp.int8)
