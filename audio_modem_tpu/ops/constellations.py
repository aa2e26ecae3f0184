"""Constellation tables + batched map/demap (modem.js:101-150).

TX map: MSB-first bit groups -> point index -> (re, im).
RX demap: hard-decision nearest-Euclidean point. Re-designed as a matmul:
argmin_i |y - p_i|^2 == argmin_i (|p_i|^2/2 - Re(y conj(p_i))) — the score for
every point is one small matmul [..., 2] @ [2, n_points], so a whole batch of
symbols demaps as a single contraction instead of the reference's scalar
loop over points (modem.js:140-150). First-minimum tie order matches the
reference's strict `<` scan.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Constellation:
    name: str
    bps: int
    # points as [n, 2] float64 (re, im), index = MSB-first packed bits
    points: tuple[tuple[float, float], ...]

    @property
    def n_points(self) -> int:
        return 1 << self.bps

    def points_np(self) -> np.ndarray:
        return np.asarray(self.points, dtype=np.float64)


def _square_qam_points(bits_per_axis: int) -> tuple[tuple[float, float], ...]:
    """Gray-coded square QAM, unit average power.

    For 16-QAM this reproduces modem.js:117-129 exactly: idx -> (row, col),
    Gray map each axis, levels 2g-(2^b-1), scaled by 1/sqrt(avg power).
    64-QAM extends the same construction (the reference SPECIFIES 64-QAM at
    ~7.7 KB/s in docs/protocol_spec.md:27 but never implements it — here it
    is a real mode)."""
    m = 1 << bits_per_axis  # levels per axis
    top = m - 1
    levels = [2 * g - top for g in range(m)]
    avg = 2 * sum(l * l for l in levels) / m
    s = 1.0 / math.sqrt(avg)
    pts = []
    for i in range(m * m):
        row, col = i >> bits_per_axis, i & top
        gr, gc = row ^ (row >> 1), col ^ (col >> 1)
        pts.append(((2 * gc - top) * s, (2 * gr - top) * s))
    return tuple(pts)


def _qam16_points() -> tuple[tuple[float, float], ...]:
    return _square_qam_points(2)


_SQ = 1.0 / math.sqrt(2.0)

CONSTELLATIONS: dict[str, Constellation] = {
    "BPSK": Constellation("BPSK", 1, ((1.0, 0.0), (-1.0, 0.0))),
    "QPSK": Constellation("QPSK", 2, ((_SQ, _SQ), (-_SQ, _SQ), (-_SQ, -_SQ), (_SQ, -_SQ))),
    "QAM16": Constellation("QAM16", 4, _qam16_points()),
    # Extension beyond the reference implementation (spec-only there):
    "QAM64": Constellation("QAM64", 6, _square_qam_points(3)),
}


@lru_cache(maxsize=None)
def _tables(name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant tables: points [n,2] f32, half|p|^2 [n], idx->bits [n,bps]."""
    c = CONSTELLATIONS[name]
    pts = c.points_np().astype(np.float32)
    half_pow = 0.5 * (pts**2).sum(axis=1)
    idx = np.arange(c.n_points, dtype=np.uint8)
    shifts = np.arange(c.bps - 1, -1, -1, dtype=np.uint8)
    bits = ((idx[:, None] >> shifts[None, :]) & 1).astype(np.int8)
    return pts, half_pow.astype(np.float32), bits


def map_bits(name: str, bits: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Map MSB-first bits [..., n_sym*bps] -> (re, im) each [..., n_sym].

    Matches constellationMap (modem.js:133-138) — bit-exactly the same f32
    values as the point table, but computed in CLOSED FORM (the inverse of
    demap's per-axis Gray slicing) instead of a [..., n_points]-indexed
    table gather: the elementwise form fuses with its neighbours.
    Level values come from a tiny where-chain over the <=8 per-axis levels,
    so each emitted float is the SAME f64-rounded-to-f32 constant the table
    holds.
    """
    c = CONSTELLATIONS[name]
    *lead, nb = bits.shape
    groups = bits.reshape(*lead, nb // c.bps, c.bps).astype(jnp.int32)
    if name == "BPSK":
        re = (1 - 2 * groups[..., 0]).astype(jnp.float32)
        return re, jnp.zeros_like(re)
    if name == "QPSK":
        b0, b1 = groups[..., 0], groups[..., 1]
        im = (1 - 2 * b0).astype(jnp.float32) * jnp.float32(_SQ)
        re = (1 - 2 * (b0 ^ b1)).astype(jnp.float32) * jnp.float32(_SQ)
        return re, im
    # square QAM: idx = [row bits | col bits]; axis level = (2*gray(v) - top)*s
    # (the exact _square_qam_points construction, run in reverse)
    bpa = c.bps // 2
    m = 1 << bpa
    top = m - 1
    pts = c.points_np()
    s = pts[:, 0].max() / top  # float64 level spacing / 2

    def axis_value(v: jnp.ndarray) -> jnp.ndarray:
        g = v ^ (v >> 1)
        out = jnp.zeros(v.shape, jnp.float32)
        for lvl in range(m):
            out = jnp.where(g == lvl, np.float32((2 * lvl - top) * s), out)
        return out

    def bits_to_int(sl: jnp.ndarray) -> jnp.ndarray:
        v = sl[..., 0]
        for j in range(1, bpa):
            v = (v << 1) | sl[..., j]
        return v

    row = bits_to_int(groups[..., :bpa])
    col = bits_to_int(groups[..., bpa:])
    return axis_value(col), axis_value(row)


def _inverse_gray(g: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """Invert b -> b ^ (b >> 1) for nbits-wide values."""
    b = g
    shift = 1
    while shift < nbits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def demap(name: str, re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Nearest-point hard demap -> MSB-first bits [..., n_sym*bps].

    Exact nearest-Euclidean decisions (constellationDemap, modem.js:140-150)
    in closed form — no loop over constellation points at all:

      BPSK   bit = (re < 0)
      QPSK   b0 = (im < 0), b1 = (re < 0) XOR (im < 0)  (quadrant Gray map)
      square QAM  the reference's construction places level (2*g - top) *
      scale on each axis with g = gray(axis_bits), so slicing each axis to
      its nearest level index gives g directly; inverse-Gray recovers the
      bits. Axes are independent under Euclidean distance, so per-axis
      slicing IS the nearest-point rule.

    Decision-boundary ties (measure zero; the reference resolves them by
    first-minimum scan order) may differ. Everything is fused elementwise
    math in the input's layout: no [..., n_points] tensors, no gathers — a
    fully unrolled 64-point compare chain exploded CPU compile times.
    """
    c = CONSTELLATIONS[name]
    re = re.astype(jnp.float32)
    im = im.astype(jnp.float32)
    if name == "BPSK":
        bits = (re < 0).astype(jnp.int8)
        return bits
    if name == "QPSK":
        b0 = (im < 0).astype(jnp.int8)
        b1 = b0 ^ (re < 0).astype(jnp.int8)
        bits = jnp.stack([b0, b1], axis=-1)
        return bits.reshape(*bits.shape[:-2], bits.shape[-2] * 2)
    # square QAM (16/64): per-axis Gray slicing
    bpa = c.bps // 2
    m = 1 << bpa
    top = m - 1
    pts = c.points_np()
    scale = float(pts[:, 0].max() / top)  # level spacing / 2

    def axis_bits(x):
        g = jnp.clip(jnp.round((x / scale + top) * 0.5), 0, top).astype(jnp.int32)
        return _inverse_gray(g, bpa)

    col = axis_bits(re)  # low bits of the index
    row = axis_bits(im)  # high bits
    idx = (row << bpa) | col
    shifts = np.arange(c.bps - 1, -1, -1)
    bits = ((idx[..., None] >> shifts) & 1).astype(jnp.int8)
    return bits.reshape(*bits.shape[:-2], bits.shape[-2] * c.bps)
