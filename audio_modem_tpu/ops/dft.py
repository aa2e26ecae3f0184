"""Active-bin DFT as matmuls — the batched replacement for the reference's
scalar radix-2 FFT (modem.js:6-66).

Only bins [sub_start, sub_end] carry information (modem.js:69-85), so instead
of a full 512-point FFT we contract against precomputed DFT matrices
restricted to the active bins:

  TX (IFFT + Hermitian symmetry, modem.js:351-356):
      x[n] = (2/N) * sum_k  Re(X_k) cos(2*pi*k*n/N) - Im(X_k) sin(2*pi*k*n/N)
      -> one [batch, 2*n_active] @ [2*n_active, N] matmul.
  RX (FFT at active bins, modem.js:381):
      Re(Y_k) = x . cos_k, Im(Y_k) = -(x . sin_k)
      -> one [batch, N] @ [N, 2*n_active] matmul.

This is exact (it IS the DFT), keeps every symbol in one contraction, and
batches over (streams x frames x symbols) for free. Precision: the TX
direction runs at HIGHEST (full float32 on every backend, ~1e-6, the
waveform contract); the RX direction (time_to_spec / time_to_spec_bins)
runs the 3-pass bf16 split dot_bf16x3 (see there) — RX decisions are
thresholded with margins far above its error.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu.configs import OfdmProfile

_PRECISION = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _tx_matrix(profile: OfdmProfile) -> np.ndarray:
    """[2*n_active, fft_size] f32: rows = stacked (cos_k, -sin_k) * 2/N."""
    n = profile.fft_size
    k = profile.active_bins[:, None].astype(np.float64)
    t = np.arange(n)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    cos = (2.0 / n) * np.cos(ang)
    msin = -(2.0 / n) * np.sin(ang)
    return np.concatenate([cos, msin], axis=0).astype(np.float32)


@lru_cache(maxsize=None)
def _rx_matrix(profile: OfdmProfile) -> np.ndarray:
    """[fft_size, 2*n_active] f32: columns = stacked (cos_k, -sin_k)."""
    return _rx_matrix_for_bins(profile, tuple(profile.active_bins.tolist()))


@lru_cache(maxsize=None)
def _rx_matrix_for_bins(profile: OfdmProfile, bins: tuple[int, ...]) -> np.ndarray:
    """[fft_size, 2*len(bins)] f32 RX DFT restricted to arbitrary bins.

    Splitting the RX transform per bin-group (data vs pilot) folds the
    subcarrier selection into the contraction itself — no per-symbol gathers
    downstream."""
    n = profile.fft_size
    k = np.asarray(bins)[None, :].astype(np.float64)
    t = np.arange(n)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    cos = np.cos(ang)
    msin = -np.sin(ang)
    return np.concatenate([cos, msin], axis=1).astype(np.float32)


@lru_cache(maxsize=None)
def tx_data_tables(profile: OfdmProfile) -> tuple[np.ndarray, np.ndarray]:
    """Fully-fused TX synthesis tables: (data_matrix, pilot_row).

    Folds three steps of modulateOFDM (modem.js:322-362) into ONE matmul
    plus a broadcast add:
      * the scatter of mapped data points into the active-bin spectrum
        becomes row selection of the TX DFT matrix, precomputed on host;
      * the pilot bins (always 1+0j, modem.js:338-341) become a constant
        time-domain row, precomputed in float64;
      * the cyclic prefix (modem.js:202-208) becomes cyclic column
        extension of the matrix — the matmul emits the full symbol.

    data_matrix: [2*n_data, symbol_len] f32 — stacked (cos_k, -sin_k)*2/N
    rows for DATA bins only, columns cyclically extended so column t holds
    sample ((t - cp) mod fft). pilot_row: [symbol_len] f32.

      symbol = [data_re | data_im] @ data_matrix + pilot_row
    """
    n = profile.fft_size
    cp = profile.cp_len
    k = profile.active_bins[:, None].astype(np.float64)
    t = np.arange(n)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    cos = (2.0 / n) * np.cos(ang)
    msin = -(2.0 / n) * np.sin(ang)

    pilot_mask = profile.pilot_mask_active
    data_rows = ~pilot_mask
    # pilots are 1+0j: only the cos rows contribute; sum in float64
    pilot_body = cos[pilot_mask].sum(axis=0)

    def extend(m: np.ndarray) -> np.ndarray:
        return np.concatenate([m[..., n - cp :], m], axis=-1)

    data_matrix = np.concatenate([cos[data_rows], msin[data_rows]], axis=0)
    return extend(data_matrix).astype(np.float32), extend(pilot_body).astype(np.float32)


def synthesize_data_symbols(
    data_re: jnp.ndarray, data_im: jnp.ndarray, profile: OfdmProfile
) -> jnp.ndarray:
    """Mapped data points [..., n_data] -> CP-prefixed symbol [..., symbol_len]
    in one matmul contraction (see tx_data_tables)."""
    mat, pilot_row = tx_data_tables(profile)
    stacked = jnp.concatenate([data_re, data_im], axis=-1).astype(jnp.float32)
    return jnp.matmul(stacked, mat, precision=_PRECISION) + pilot_row


def spec_to_time(spec_re: jnp.ndarray, spec_im: jnp.ndarray, profile: OfdmProfile) -> jnp.ndarray:
    """Active-bin spectrum [..., n_active] -> real time domain [..., fft_size]."""
    stacked = jnp.concatenate([spec_re, spec_im], axis=-1).astype(jnp.float32)
    return jnp.matmul(stacked, _tx_matrix(profile), precision=_PRECISION)


def dot_bf16x3(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """~f32-accurate matmul as three products of bf16-split operands
    (x_hi@y_hi + x_hi@y_lo + x_lo@y_hi, dropping x_lo@y_lo).

    The receive-direction DFT; payload decisions are pinned to this op
    sequence. All three products run at default precision: on a GPU that
    is TF32 for float32 inputs, in which the hi x hi product is still exact
    (bf16-representable operands, f32 accumulation) and the two lo-term
    products carry TF32's ~2^-11 relative error on terms that are
    themselves ~2^-8 of the result — ~2^-19 of a row in all. The demap
    decisions it feeds have >= 0.1 margins. The transmit direction stays at
    HIGHEST: TX waveforms carry a 3e-5 oracle tolerance with no decision
    margin."""
    x_hi = x.astype(jnp.bfloat16).astype(jnp.float32)
    x_lo = x - x_hi
    y_hi = y.astype(jnp.bfloat16).astype(jnp.float32)
    y_lo = y - y_hi
    return (
        jnp.matmul(x_hi, y_hi, preferred_element_type=jnp.float32)
        + (
            jnp.matmul(x_hi, y_lo, preferred_element_type=jnp.float32)
            + jnp.matmul(x_lo, y_hi, preferred_element_type=jnp.float32)
        )
    )


def time_to_spec(body: jnp.ndarray, profile: OfdmProfile) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Real time domain [..., fft_size] -> active-bin spectrum (re, im)."""
    out = dot_bf16x3(body.astype(jnp.float32), _rx_matrix(profile))
    n_act = profile.num_active_subs
    return out[..., :n_act], out[..., n_act:]


def time_to_spec_bins(
    body: jnp.ndarray, profile: OfdmProfile, bins: tuple[int, ...]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Real time domain [..., fft_size] -> spectrum at the given bins only."""
    out = dot_bf16x3(body.astype(jnp.float32), _rx_matrix_for_bins(profile, bins))
    n = len(bins)
    return out[..., :n], out[..., n:]
