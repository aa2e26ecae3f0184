"""L2 OFDM PHY: batched modulate / demodulate / channel estimation.

Re-design of modem.js:322-440 for an accelerator: every function is pure,
shape-static, batched over a leading symbol (and optionally frame/stream)
axis, and built from matmul contractions (active-bin DFT, constellation
demap-as-matmul). No
per-subcarrier Python loops anywhere.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu.configs import ModemMode, OfdmProfile
from audio_modem_tpu.ops import constellations as con
from audio_modem_tpu.ops.dft import (
    synthesize_data_symbols,
    time_to_spec,
    time_to_spec_bins,
)


@lru_cache(maxsize=None)
def _bin_tables(profile: OfdmProfile) -> dict:
    """Index tables over the active-bin axis (numpy: jit lifts per-trace)."""
    pilot_mask = profile.pilot_mask_active
    return {
        "pilot_mask": pilot_mask,
        "data_pos": np.nonzero(~pilot_mask)[0],
        "pilot_pos": np.nonzero(pilot_mask)[0],
        "ce_known": profile.ce_known_signs.astype(np.float32),
    }


def add_cp(body: jnp.ndarray, profile: OfdmProfile) -> jnp.ndarray:
    """[..., fft_size] -> [..., symbol_len] (modem.js:202-208)."""
    return jnp.concatenate([body[..., -profile.cp_len :], body], axis=-1)


def strip_cp(symbols: jnp.ndarray, profile: OfdmProfile) -> jnp.ndarray:
    """[..., symbol_len] -> [..., fft_size] (modem.js:374-378)."""
    return symbols[..., profile.cp_len : profile.cp_len + profile.fft_size]


def modulate(bits: jnp.ndarray, mode: ModemMode) -> jnp.ndarray:
    """Bits [..., n_sym * bits_per_symbol] -> samples [..., n_sym, symbol_len].

    Matches modulateOFDM (modem.js:322-362): pilots = 1+0j, data bins mapped
    MSB-first onto the constellation, Hermitian IFFT, cyclic prefix. Bits must
    be pre-padded to a symbol multiple (jit needs static shapes; the host
    framing layer pads, mirroring modem.js:329).
    """
    p = mode.profile
    *lead, nb = bits.shape
    n_sym = nb // mode.bits_per_symbol
    grouped = bits.reshape(*lead, n_sym, mode.bits_per_symbol)
    data_re, data_im = con.map_bits(mode.constellation, grouped)  # [..., n_sym, n_data]
    # One fused matmul contraction: data scatter + pilot insertion + Hermitian
    # IFFT + cyclic prefix all folded into a precomputed [2*n_data,
    # symbol_len] matrix (ops/dft.tx_data_tables).
    return synthesize_data_symbols(data_re, data_im, p)


def estimate_channel(ce_samples: jnp.ndarray, profile: OfdmProfile) -> tuple[jnp.ndarray, jnp.ndarray]:
    """CE symbol [..., symbol_len] -> channel (re, im) on active bins.

    modem.js:421-440 with known X = ±1 real: H = Y * conj(X)/|X|^2 = Y * X.
    """
    body = strip_cp(ce_samples, profile)
    y_re, y_im = time_to_spec(body, profile)
    known = _bin_tables(profile)["ce_known"]
    return y_re * known, y_im * known


def equalize(
    spec_re: jnp.ndarray,
    spec_im: jnp.ndarray,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One-tap ZF EQ with tiny-|H| passthrough (modem.js:384-394)."""
    h_mag = ch_re * ch_re + ch_im * ch_im
    ok = h_mag > 1e-10
    denom = jnp.where(ok, h_mag, 1.0)
    eq_re = jnp.where(ok, (spec_re * ch_re + spec_im * ch_im) / denom, spec_re)
    eq_im = jnp.where(ok, (spec_im * ch_re - spec_re * ch_im) / denom, spec_im)
    return eq_re, eq_im


def pilot_phase(eq_re: jnp.ndarray, eq_im: jnp.ndarray, profile: OfdmProfile) -> jnp.ndarray:
    """Small-angle common-phase estimate from pilots (modem.js:397-405).

    phase = mean over usable pilots of Im/Re, usable = |Re| > 1e-6.
    Returns [...] (one scalar per symbol in the batch).
    """
    pos = _bin_tables(profile)["pilot_pos"]
    pr, pi = eq_re[..., pos], eq_im[..., pos]
    usable = jnp.abs(pr) > 1e-6
    ratio = jnp.where(usable, pi / jnp.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(axis=-1)
    return jnp.where(cnt > 0, ratio.sum(axis=-1) / jnp.maximum(cnt, 1), 0.0)


def demodulate(
    symbols: jnp.ndarray,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
    mode: ModemMode,
) -> jnp.ndarray:
    """Symbols [..., n_sym, symbol_len] -> hard bits [..., n_sym*bits_per_symbol].

    Matches demodulateOFDM (modem.js:365-418): strip CP, per-bin DFT,
    one-tap EQ, pilot common-phase rotation (cr, ci) = (re + im*phi, im - re*phi),
    nearest-point demap. ch_* are active-bin channel arrays broadcast over
    the symbol axis.

    The DFT is computed separately for data and pilot bins (the subcarrier
    selection is folded into the contraction matrices), so the per-symbol
    path is pure matmul + elementwise — no gathers.
    """
    p = mode.profile
    tabs = _bin_tables(p)
    body = strip_cp(symbols, p)
    data_bins = tuple(int(b) for b in p.data_bins)
    pilot_bins = tuple(int(b) for b in p.pilot_bins)
    d_re, d_im = time_to_spec_bins(body, p, data_bins)
    p_re, p_im = time_to_spec_bins(body, p, pilot_bins)

    # channel gathered once per stream (tiny), broadcast over symbols
    dpos, ppos = tabs["data_pos"], tabs["pilot_pos"]
    chd_re, chd_im = ch_re[..., dpos][..., None, :], ch_im[..., dpos][..., None, :]
    chp_re, chp_im = ch_re[..., ppos][..., None, :], ch_im[..., ppos][..., None, :]

    dr, di = equalize(d_re, d_im, chd_re, chd_im)
    pr, pi = equalize(p_re, p_im, chp_re, chp_im)

    # pilot common-phase: mean of Im/Re over usable pilots (modem.js:397-405)
    usable = jnp.abs(pr) > 1e-6
    ratio = jnp.where(usable, pi / jnp.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(axis=-1)
    phi = jnp.where(cnt > 0, ratio.sum(axis=-1) / jnp.maximum(cnt, 1), 0.0)[..., None]

    cr = dr + di * phi
    ci = di - dr * phi
    bits = con.demap(mode.constellation, cr, ci)  # [..., n_sym, n_data*bps]
    *lead, n_sym, per = bits.shape
    return bits.reshape(*lead, n_sym * per)


def demodulate_soft_bpsk(
    symbols: jnp.ndarray,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
    mode: ModemMode,
) -> jnp.ndarray:
    """BPSK soft bit metrics: the MATCHED-FILTER (Y * conj(H)), pilot-phase-
    corrected real component of each data bin, flattened in demodulate's bit
    order (hard bit = metric < 0 — the sign equals the ZF demap's, since
    matched filter and ZF differ by the positive factor |H|^2).

    Exists for soft repetition combining: summing each transmitted bit's
    repeated soft metrics BEFORE the sign decision is worth ~1-2 dB of
    sensitivity over the reference's hard-bit majority vote
    (modem.js:479-495) on the x3-repetition modes — a vote is blind to how
    confident each copy was. The matched-filter scaling is what makes the
    sum a true maximum-ratio combiner: each copy carries weight |H|^2
    (its SNR). Summing the ZF-equalized values instead would do the
    opposite — ZF noise grows as 1/|H|^2, so the noisiest copies would
    dominate and the combiner measures WORSE than the vote. Only the BPSK
    constellation needs a soft path (it is the only one the mode registry
    pairs with repetition); used by the decoders' soft retry when the hard
    decision fails CRC/FEC."""
    assert mode.constellation == "BPSK", "soft combining is a BPSK-repetition feature"
    p = mode.profile
    tabs = _bin_tables(p)
    body = strip_cp(symbols, p)
    data_bins = tuple(int(b) for b in p.data_bins)
    pilot_bins = tuple(int(b) for b in p.pilot_bins)
    d_re, d_im = time_to_spec_bins(body, p, data_bins)
    p_re, p_im = time_to_spec_bins(body, p, pilot_bins)
    dpos, ppos = tabs["data_pos"], tabs["pilot_pos"]
    chd_re, chd_im = ch_re[..., dpos][..., None, :], ch_im[..., dpos][..., None, :]
    chp_re, chp_im = ch_re[..., ppos][..., None, :], ch_im[..., ppos][..., None, :]
    # matched filter on data bins (passthrough where the hard path's EQ
    # passes through, so the signs keep matching demodulate exactly)
    mag = chd_re * chd_re + chd_im * chd_im
    ok = mag > 1e-10
    mr = jnp.where(ok, d_re * chd_re + d_im * chd_im, d_re)
    mi = jnp.where(ok, d_im * chd_re - d_re * chd_im, d_im)
    # pilot common phase measured on the EQ'd pilots — identical to the
    # hard path (phase is scale-invariant)
    pr, pi = equalize(p_re, p_im, chp_re, chp_im)
    usable = jnp.abs(pr) > 1e-6
    ratio = jnp.where(usable, pi / jnp.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(axis=-1)
    phi = jnp.where(cnt > 0, ratio.sum(axis=-1) / jnp.maximum(cnt, 1), 0.0)[..., None]
    cr = mr + mi * phi
    *lead, n_sym, nd = cr.shape
    return cr.reshape(*lead, n_sym * nd)


def demodulate_tracked(
    sig_ext: jnp.ndarray,
    data_start: jnp.ndarray,
    n_sym: int,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
    mode: ModemMode,
    block_syms: int = 64,
    n_valid_sym: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate ``n_sym`` symbols with SAMPLE-TIMING TRACKING — the
    capability that lets multi-minute frames survive TX/RX clock offset.

    The reference corrects only the pilots' common phase per symbol
    (modem.js:397-405); a 50 ppm clock offset accumulates ~1 sample of
    timing drift every ~700 ms, so its symbol windows walk off the cyclic
    prefix within seconds on long frames. Here a second-order timing loop
    runs over symbol blocks (lax.scan over blocks; everything inside a
    block is batched):

      * each symbol's window start gets the predicted offset tau + rate*j,
        rounded to samples (per-symbol dynamic slices);
      * the sub-sample remainder is corrected in frequency: a timing error
        d shifts bin k's phase by 2*pi*k*d/N, so the spectrum is de-rotated
        by the predicted fraction;
      * the residual timing error is measured from the pilots' PHASE SLOPE
        ACROSS FREQUENCY (least squares over pilot bins, small-angle
        phases) and fed back: tau -= g1*err, rate -= g2*err/B.

    The channel estimate from the frame-head CE symbol stays valid: timing
    normalization removes the drift-induced phase walk, and the common-phase
    rotation (same as the reference's) absorbs the rest.

    ``n_valid_sym`` (traced, optional) marks how many leading symbols carry
    real payload: symbols past it are excluded from the timing MEASUREMENT
    (their bits still come out, as junk). Without it, a caller whose buffer
    tail runs past the frame's true end — e.g. a bucket-padded slice that
    reaches into the NEXT frame's preamble — feeds garbage pilot phases to
    the feedback loop and the acquisition/LS fit drags the real symbols'
    timing off with it.

    Returns (bits [n_sym * bits_per_symbol], final tau). Opt-in (not the
    default demod) because on drift-free signals the extra float work
    changes junk-bit patterns the bit-exactness tests pin down.
    """
    p = mode.profile
    tabs = _bin_tables(p)
    sym = p.symbol_len
    fft = p.fft_size
    cp = p.cp_len
    data_bins = tuple(int(b) for b in p.data_bins)
    pilot_bins = tuple(int(b) for b in p.pilot_bins)
    kd = jnp.asarray(p.data_bins, jnp.float32)
    kp = jnp.asarray(p.pilot_bins, jnp.float32)
    dpos, ppos = tabs["data_pos"], tabs["pilot_pos"]
    chd_re, chd_im = ch_re[dpos][None, :], ch_im[dpos][None, :]
    chp_re, chp_im = ch_re[ppos][None, :], ch_im[ppos][None, :]

    n_blocks = -(-n_sym // block_syms)
    jloc = jnp.arange(block_syms, dtype=jnp.float32)
    two_pi = 2.0 * np.pi

    def make_step(g1, g2):
        return lambda carry, b: _step(carry, b, g1, g2)

    def _step(carry, b, g1, g2):
        tau, rate = carry
        off = tau + rate * jloc  # predicted timing offset per symbol
        shift = jnp.round(off)
        frac = off - shift  # sub-sample part, corrected in frequency
        base = data_start + (b * block_syms + jnp.arange(block_syms)) * sym + cp
        starts = base + shift.astype(jnp.int32)
        bodies = jax.vmap(lambda s0: jax.lax.dynamic_slice(sig_ext, (s0,), (fft,)))(starts)
        d_re, d_im = time_to_spec_bins(bodies, p, data_bins)
        p_re, p_im = time_to_spec_bins(bodies, p, pilot_bins)

        # predicted-fraction de-rotation: the rounded window starts ``frac``
        # samples EARLY relative to the ideal timing, so bin k picks up
        # e^{-j 2 pi k frac / N}; undo it by multiplying e^{+j ...}.
        def derot(re, im, k):
            ang = two_pi * k[None, :] * frac[:, None] / fft
            c, s = jnp.cos(ang), jnp.sin(ang)
            return re * c - im * s, im * c + re * s

        d_re, d_im = derot(d_re, d_im, kd)
        p_re, p_im = derot(p_re, p_im, kp)

        dr, di = equalize(d_re, d_im, chd_re, chd_im)
        pr, pi = equalize(p_re, p_im, chp_re, chp_im)

        # residual timing from DIFFERENTIAL pilot phase: the phase step
        # between adjacent pilots (spacing dk bins) is 2*pi*dk*delta/N —
        # unambiguous for |delta| < N/(2*max dk) (~18-25 samples), unlike a
        # direct per-bin phase slope, which wraps past ~1 sample. atan2 of
        # the adjacent-pilot complex products reads it over the full range.
        u_re = pr[:, 1:] * pr[:, :-1] + pi[:, 1:] * pi[:, :-1]
        u_im = pi[:, 1:] * pr[:, :-1] - pr[:, 1:] * pi[:, :-1]
        mag_ok = (pr[:, 1:] ** 2 + pi[:, 1:] ** 2 > 1e-12) & (
            pr[:, :-1] ** 2 + pi[:, :-1] ** 2 > 1e-12
        )
        if n_valid_sym is not None:
            sym_idx = b * block_syms + jnp.arange(block_syms)
            mag_ok = mag_ok & (sym_idx < n_valid_sym)[:, None]
        ang = jnp.where(mag_ok, jnp.arctan2(u_im, u_re), 0.0)  # [B, np-1]
        dks = kp[1:] - kp[:-1]  # pilot spacings, bins
        coef = jnp.where(mag_ok, (two_pi / fft) * dks[None, :], 0.0)
        delta = ang.sum(-1) / jnp.maximum(coef.sum(-1), 1e-6)  # samples
        n_ok = mag_ok.sum(-1)
        delta = jnp.where(n_ok >= 1, delta, 0.0)
        delta_blk = jnp.clip(
            delta.sum() / jnp.maximum((n_ok >= 1).sum(), 1), -8.0, 8.0
        )

        # common phase (reference small-angle semantics) + demap
        usable = jnp.abs(pr) > 1e-6
        phi = jnp.where(usable, pi / jnp.where(usable, pr, 1.0), 0.0)
        cnt = usable.sum(axis=-1)
        mean_phi = jnp.where(cnt > 0, phi.sum(-1) / jnp.maximum(cnt, 1), 0.0)[:, None]
        cr = dr + di * mean_phi
        ci = di - dr * mean_phi
        bits = con.demap(mode.constellation, cr, ci)  # [B, n_data*bps]

        w_blk = (n_ok >= 1).sum()
        new_rate = rate - g2 * delta_blk / block_syms
        new_tau = tau + rate * block_syms - g1 * delta_blk
        return (new_tau, new_rate), (bits, delta_blk, w_blk)

    step = make_step(0.5, 0.25)
    frozen = make_step(0.0, 0.0)  # pure prediction: measures, never corrects
    blocks_idx = jnp.arange(n_blocks)
    zero = jnp.float32(0.0)

    # Acquire -> measure -> demod. (1) A closed-loop pass from zero state
    # ACQUIRES an approximate rate (symbols demodulated during acquisition
    # would be lost, so this pass is measurement-only). (2) A FROZEN-gain
    # pass replays the frame with predicted(j) = rate_acq * j and collects
    # the per-block residuals: since ``delta`` is (predicted - actual),
    # delta_i = (rate_acq - rate_true) * x_i - tau_true is LINEAR in the
    # block midpoint x_i, so a weighted least-squares line (weights = blocks
    # that actually measured pilots; zero-padded junk blocks weigh 0) reads
    # off BOTH the true rate and the frame-head sub-sample offset far more
    # accurately than the sequential loop can on a short frame. (3) The
    # final closed-loop pass demods from symbol 0 with the fitted (tau0,
    # rate) pre-loaded; feedback stays on to absorb curvature/noise.
    (_t, rate_acq), _ = jax.lax.scan(step, (zero, zero), blocks_idx)
    _, (_b, deltas_m, ws) = jax.lax.scan(frozen, (zero, rate_acq), blocks_idx)
    x = jnp.arange(n_blocks, dtype=jnp.float32) * block_syms + (block_syms - 1) / 2.0
    w = ws.astype(jnp.float32)
    wsum = jnp.maximum(w.sum(), 1e-6)
    xm = (w * x).sum() / wsum
    dm = (w * deltas_m).sum() / wsum
    den = (w * (x - xm) ** 2).sum()
    slope = jnp.where(den > 1e-6, (w * (x - xm) * (deltas_m - dm)).sum() / jnp.maximum(den, 1e-6), 0.0)
    intercept = dm - slope * xm
    (tau_f, _), (bits, deltas, _w) = jax.lax.scan(
        step, (-intercept, rate_acq - slope), blocks_idx
    )
    bits = bits.reshape(n_blocks * block_syms, -1)[:n_sym]
    return bits.reshape(-1), tau_f


def channel_magnitude(ch_re: jnp.ndarray, ch_im: jnp.ndarray) -> jnp.ndarray:
    """|H| per active bin (diagnostics; modem.js:1025-1029)."""
    return jnp.sqrt(ch_re * ch_re + ch_im * ch_im)


def symbol_evm(
    symbols: jnp.ndarray,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
    mode: ModemMode,
) -> jnp.ndarray:
    """Per-symbol error-vector magnitude [..., n_sym] of the equalized data
    constellation, normalized to unit reference power. Same pipeline as
    demodulate() up to the decision, then RMS distance from the decided
    (re-mapped) points. A symbol hit by a dropout/burst reads ~1.0 where
    clean symbols read the channel's noise level — the confidence signal
    that drives erasure-aware RS decoding (decoder._erasure_flags)."""
    bits = demodulate(symbols, ch_re, ch_im, mode)
    dec_re, dec_im = con.map_bits(mode.constellation, bits.reshape(*symbols.shape[:-1], -1))

    p = mode.profile
    body = strip_cp(symbols, p)
    data_bins = tuple(int(b) for b in p.data_bins)
    pilot_bins = tuple(int(b) for b in p.pilot_bins)
    d_re, d_im = time_to_spec_bins(body, p, data_bins)
    p_re, p_im = time_to_spec_bins(body, p, pilot_bins)
    tabs = _bin_tables(p)
    dpos, ppos = tabs["data_pos"], tabs["pilot_pos"]
    dr, di = equalize(d_re, d_im, ch_re[..., dpos][..., None, :], ch_im[..., dpos][..., None, :])
    pr, pi = equalize(p_re, p_im, ch_re[..., ppos][..., None, :], ch_im[..., ppos][..., None, :])
    usable = jnp.abs(pr) > 1e-6
    ratio = jnp.where(usable, pi / jnp.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(axis=-1)
    phi = jnp.where(cnt > 0, ratio.sum(axis=-1) / jnp.maximum(cnt, 1), 0.0)[..., None]
    cr = dr + di * phi
    ci = di - dr * phi
    err = (cr - dec_re) ** 2 + (ci - dec_im) ** 2
    return jnp.sqrt(err.mean(axis=-1))


def error_vector_magnitude(
    symbols: jnp.ndarray,
    ch_re: jnp.ndarray,
    ch_im: jnp.ndarray,
    mode: ModemMode,
) -> jnp.ndarray:
    """RMS error-vector magnitude over all data symbols (SURVEY §5 metrics
    gap-fill; the reference never measures EVM)."""
    per_sym = symbol_evm(symbols, ch_re, ch_im, mode)
    return jnp.sqrt((per_sym * per_sym).mean(axis=-1))
