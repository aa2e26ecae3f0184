"""Full-signal and frame decoders: the receive pipeline as one jitted graph.

Re-design of decodeReceivedSignal (modem.js:557-654) and decodeChunkFrame
(modem.js:770-803). Everything numeric — preprocessing, coarse Schmidl-Cox
scan, fine cross-correlation, channel estimation, per-symbol demodulation —
runs on device in a single compiled executable; only the byte-level payload
parse stays on host. Signals are zero-padded into static length buckets so a
handful of executables serve all inputs; the demodulator always processes the
maximum symbol count for the bucket and the host truncates to the reference's
floor((n_valid - data_start)/symbol_len) symbol count afterwards, exactly
reproducing the reference's junk-tail-tolerant behavior.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu import phy, sync
from audio_modem_tpu.configs import ModemMode
from audio_modem_tpu.configs import FRAME_DATA, FRAME_FEC, FRAME_META
from audio_modem_tpu.framing import (
    FrameError,
    ParseResult,
    num_symbols_for_payload,
    parse_payload_bytes,
)
from audio_modem_tpu.ops.bits import bits_to_bytes, majority_vote, soft_combine

PAD_BUCKET = 16384


@dataclasses.dataclass
class DecodeInfo:
    """Sync/diagnostic metadata attached to every decode."""

    preamble_idx: int
    coarse_idx: int
    fine_metric: float
    channel_mag: np.ndarray | None = None


def _bucket_len(n: int) -> int:
    return -(-max(n, 2 * PAD_BUCKET) // PAD_BUCKET) * PAD_BUCKET


def _max_symbols(pad_len: int, mode: ModemMode) -> int:
    # Upper bound on demodulatable symbols for this bucket (start can be 0).
    return max((pad_len - 3 * mode.profile.symbol_len) // mode.profile.symbol_len, 1)


@partial(jax.jit, static_argnames=("mode", "max_syms"))
def _decode_core(
    signal: jnp.ndarray,
    n_valid: jnp.ndarray,
    min_pos: jnp.ndarray,
    mode: ModemMode,
    max_syms: int,
):
    """Device pipeline for one padded signal.

    Returns (coarse_idx, start_idx, fine_metric, bits[max_syms*bps_sym],
    ch_re, ch_im).
    """
    p = mode.profile
    sym = p.symbol_len
    sig = sync.preprocess(signal, n_valid)

    coarse, _ = sync.detect_preamble(sig, p, n_valid, min_pos=min_pos, stride=sync.COARSE_STRIDE)
    safe_coarse = jnp.maximum(coarse, 0)
    start, fine_metric = sync.refine_xcorr(sig, safe_coarse, p, n_valid)

    # Extend so CE/data slices are always in bounds regardless of start.
    ext = jnp.pad(sig, (0, (3 + max_syms) * sym))
    ce = jax.lax.dynamic_slice(ext, (start + 2 * sym,), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)

    data = jax.lax.dynamic_slice(ext, (start + 3 * sym,), (max_syms * sym,))
    bits = phy.demodulate(data.reshape(max_syms, sym), ch_re, ch_im, mode)
    return coarse, start, fine_metric, bits, ch_re, ch_im


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _evm_core(signal: jnp.ndarray, n_valid: jnp.ndarray, start: jnp.ndarray, mode: ModemMode, n_sym: int):
    """Per-symbol EVM of the data region — the confidence signal for
    erasure-aware FEC retry (runs only after an errors-only decode fails)."""
    p = mode.profile
    sym = p.symbol_len
    sig = sync.preprocess(signal, n_valid)
    ext = jnp.pad(sig, (0, (3 + n_sym) * sym))
    ce = jax.lax.dynamic_slice(ext, (start + 2 * sym,), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)
    data = jax.lax.dynamic_slice(ext, (start + 3 * sym,), (n_sym * sym,))
    return phy.symbol_evm(data.reshape(n_sym, sym), ch_re, ch_im, mode)


@partial(jax.jit, static_argnames=("mode",))
def _xcorr_core(signal: jnp.ndarray, n_valid: jnp.ndarray, mode: ModemMode):
    """Dense normalized-xcorr preamble search on the preprocessed signal —
    the sync re-acquisition stage of decode_signal's CRC-failure retry."""
    sig = sync.preprocess(signal, n_valid)
    return sync.detect_preamble_xcorr(sig, mode.profile, n_valid)


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _soft_core(signal: jnp.ndarray, n_valid: jnp.ndarray, start: jnp.ndarray, mode: ModemMode, n_sym: int):
    """BPSK soft metrics of the data region (phy.demodulate_soft_bpsk) —
    the input to the soft repetition-combining retry."""
    p = mode.profile
    sym = p.symbol_len
    sig = sync.preprocess(signal, n_valid)
    ext = jnp.pad(sig, (0, (3 + n_sym) * sym))
    ce = jax.lax.dynamic_slice(ext, (start + 2 * sym,), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)
    data = jax.lax.dynamic_slice(ext, (start + 3 * sym,), (n_sym * sym,))
    return phy.demodulate_soft_bpsk(data.reshape(n_sym, sym), ch_re, ch_im, mode)


def _soft_retry_applicable(mode: ModemMode) -> bool:
    return mode.repetition > 1 and mode.constellation == "BPSK"


def _parse_failed(result) -> bool:
    return isinstance(result, FrameError) or not getattr(result, "crc_valid", True)


def _byte_erasures(evm: np.ndarray, mode: ModemMode, n_bytes: int) -> np.ndarray | None:
    """Per-symbol EVM -> per-payload-byte erasure flags (or None).

    A symbol is flagged when its EVM stands out against the frame's median
    (dropouts/bursts read ~1.0 where clean symbols read the noise level);
    the flag propagates to every byte the symbol carries, through the
    repetition code when present (a majority-decoded bit is unreliable when
    at least half its copies come from flagged symbols).

    ``n_bytes`` bounds the payload region of interest: the demodulator also
    emits junk-tail symbols (trailing silence, modem.js:368 semantics) whose
    EVM reads ~1.0, so statistics run only over the symbols that carry the
    first ``n_bytes`` decoded bytes."""
    n_used_sym = min(len(evm), -(-n_bytes * 8 * mode.repetition // mode.bits_per_symbol))
    if n_used_sym <= 0:
        return None
    evm = np.asarray(evm[:n_used_sym])
    med = float(np.median(evm))
    bad_sym = evm > max(2.0 * med, 0.5)
    if not bad_sym.any() or bad_sym.all():
        return None
    wire_bad = np.repeat(bad_sym, mode.bits_per_symbol)
    rep = mode.repetition
    if rep > 1:
        n_dec = len(wire_bad) // rep
        dec_bad = wire_bad[: n_dec * rep].reshape(n_dec, rep).sum(axis=1) * 2 >= rep
    else:
        dec_bad = wire_bad
    n_fit = min(n_bytes, len(dec_bad) // 8)
    flags = np.zeros(n_bytes, bool)
    flags[:n_fit] = dec_bad[: n_fit * 8].reshape(n_fit, 8).any(axis=1)
    return flags if flags.any() else None


def _is_fec_failure(raw: bytes, result) -> bool:
    """Did an FEC-wrapped payload fail to yield a valid frame?

    Any failed parse of FEC-magic raw bytes qualifies — not just an explicit
    RS decode error: a Reed-Solomon MIS-correction (noise within distance 16
    of a wrong codeword) "succeeds" into garbage that then fails the inner
    CRC or inner structural parse. All of these are worth the
    errors-and-erasures retry, which doubles the correction radius."""
    return len(raw) > 0 and raw[0] == FRAME_FEC and _parse_failed(result)


def _fec_region_bytes(by: bytes) -> int:
    """Byte count of the FEC header + coded region within a decoded payload
    (the part whose erasure flags matter; everything after is junk tail)."""
    if len(by) < 5:
        return len(by)
    return min(len(by), 5 + int.from_bytes(by[1:5], "big"))


TRACK_EARLY_BIAS = 2


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _tracked_core(signal: jnp.ndarray, n_valid: jnp.ndarray, start: jnp.ndarray, mode: ModemMode, n_sym: int):
    """Re-demodulate the data region with the timing-tracking loop
    (phy.demodulate_tracked) — used for long frames under clock drift.

    CE window and data timing are both biased TRACK_EARLY_BIAS samples early
    (into the cyclic prefix): a window that starts at-or-after the true
    symbol boundary leaks the next symbol's CP into the DFT (ISI), and the
    xcorr-refined start is only exact to ±1 sample, so the unbiased
    placement sat right on that cliff — under drift, frames whose refined
    start landed 'late' failed even with tracking. Starting 2 samples into
    the CP is always ISI-free (CP >= 64 everywhere) and the constant offset
    cancels between CE and data (both shifted the same amount)."""
    p = mode.profile
    sym = p.symbol_len
    sig = sync.preprocess(signal, n_valid)
    ext = jnp.pad(sig, (0, 8192))
    eb = TRACK_EARLY_BIAS
    ce = jax.lax.dynamic_slice(ext, (jnp.maximum(start + 2 * sym - eb, 0),), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)
    return phy.demodulate_tracked(
        ext, jnp.maximum(start + 3 * sym - eb, 0), n_sym, ch_re, ch_im, mode
    )


def decode_raw(
    signal: np.ndarray, mode: ModemMode, track_timing: bool = False
) -> tuple[bytes | FrameError, DecodeInfo | None]:
    """Full-signal sync + demod -> raw payload BYTES (repetition undone,
    packed), before any frame-type parse. The public path for every
    full-signal consumer — decode_signal and the ARQ request decoder — so
    all of them get the false-positive retry loop (the one-shot analog of
    the streaming receiver's IDLE-state resume, app.js:879-884).
    """
    p = mode.profile
    sym = p.symbol_len
    n_valid = len(signal)
    pad_len = _bucket_len(n_valid)
    max_syms = _max_symbols(pad_len, mode)

    sig = np.zeros(pad_len, np.float32)
    sig[:n_valid] = signal
    sig_dev = jnp.asarray(sig)

    min_pos, coarse, start, fine_metric = 0, -1, -1, -np.inf
    bits = ch_re = ch_im = None
    for _ in range(4):
        coarse_t, start_t, metric_t, bits, ch_re, ch_im = _decode_core(
            sig_dev, jnp.int32(n_valid), jnp.int32(min_pos), mode, max_syms
        )
        coarse = int(coarse_t)
        if coarse < 0:
            if fine_metric == -np.inf:
                return FrameError("Preamble not detected"), None
            break
        start, fine_metric = int(start_t), float(metric_t)
        if fine_metric >= sync.XCORR_THRESHOLD:
            break
        min_pos = coarse + p.fft_size  # skip past the false peak
    if coarse < 0 or fine_metric < sync.XCORR_THRESHOLD:
        return FrameError("Preamble not detected (low correlation)"), None

    info = DecodeInfo(
        preamble_idx=start,
        coarse_idx=coarse,
        fine_metric=fine_metric,
        channel_mag=np.asarray(phy.channel_magnitude(ch_re, ch_im)),
    )

    ce_start = start + 2 * sym
    if ce_start + sym > n_valid:
        return FrameError("Signal too short for CE"), info
    data_start = ce_start + sym
    if data_start >= n_valid:
        return FrameError("No data after CE"), info

    # Reference demodulates floor((len - dataStart)/symbol_len) symbols
    # (modem.js:368); truncate the fixed-size device output to match.
    n_sym = (n_valid - data_start) // sym
    if track_timing and n_sym > 0:
        bits, _tau = _tracked_core(sig_dev, jnp.int32(n_valid), jnp.int32(start), mode, int(n_sym))
        b = np.asarray(bits)
    else:
        b = np.asarray(bits)[: n_sym * mode.bits_per_symbol]
    if mode.repetition > 1:
        b = majority_vote(b, mode.repetition)
    return bytes(bits_to_bytes(b)), info


def decode_signal(
    signal: np.ndarray, mode: ModemMode, track_timing: bool = False
) -> tuple[ParseResult, DecodeInfo | None]:
    """Decode a full recorded signal (modem.js:557-654).

    Returns (parse result | FrameError, DecodeInfo | None). Error strings
    mirror the reference so callers/tests can match on them.
    ``track_timing`` enables the sample-timing tracking loop for long
    frames under TX/RX clock offset (phy.demodulate_tracked) — a capability
    the reference does not have.

    Sync re-acquisition retry (beats the reference's one-shot decoder):
    when the Schmidl-Cox scan finds nothing (the autocorr metric of a weak
    frame sits below the 0.5 threshold well before the bit error rate is
    hopeless) or its committed candidate fails CRC, the signal is
    re-acquired with the dense cross-correlation detector — which the
    reference uses only as the loopback analyzer's fallback
    (modem.js:980-984), never in decodeReceivedSignal — and the frame is
    decoded aligned at the xcorr winner (no autocorr gate), with the
    chunk decoder's own soft/FEC retry ladder behind it.
    """
    result, info = _decode_signal_once(signal, mode, track_timing)
    if not _parse_failed(result):
        return result, info
    p = mode.profile
    n_valid = len(signal)
    pad_len = _bucket_len(n_valid)
    sig = np.zeros(pad_len, np.float32)
    sig[:n_valid] = signal
    xi, xm = _xcorr_core(jnp.asarray(sig), jnp.int32(n_valid), mode)
    xstart = int(xi)
    if (
        float(xm) >= sync.XCORR_THRESHOLD
        and xstart >= 0
        and (info is None or abs(xstart - info.preamble_idx) > p.symbol_len // 2)
    ):
        retry = decode_chunk_frame(np.asarray(signal[xstart:], np.float32), mode)
        if not _parse_failed(retry):
            rinfo = DecodeInfo(preamble_idx=xstart, coarse_idx=-1, fine_metric=float(xm))
            return retry, rinfo
    return result, info


def _decode_signal_once(
    signal: np.ndarray, mode: ModemMode, track_timing: bool
) -> tuple[ParseResult, DecodeInfo | None]:
    raw, info = decode_raw(signal, mode, track_timing=track_timing)
    if isinstance(raw, FrameError):
        return raw, info
    result = parse_payload_bytes(raw, min_len=10)
    if _parse_failed(result) and _soft_retry_applicable(mode) and info is not None:
        # soft repetition-combining retry (beats the reference: hard
        # majority voting throws away each copy's confidence; summing the
        # BPSK soft metrics before the sign decision recovers ~2 dB)
        p = mode.profile
        sym = p.symbol_len
        n_valid = len(signal)
        n_sym = (n_valid - (info.preamble_idx + 3 * sym)) // sym
        if n_sym > 0:
            pad_len = _bucket_len(n_valid)
            sig = np.zeros(pad_len, np.float32)
            sig[:n_valid] = signal
            soft = np.asarray(
                _soft_core(jnp.asarray(sig), jnp.int32(n_valid), jnp.int32(info.preamble_idx), mode, int(n_sym))
            )
            soft_raw = bytes(bits_to_bytes(soft_combine(soft, mode.repetition)))
            soft_result = parse_payload_bytes(soft_raw, min_len=10)
            if not _parse_failed(soft_result):
                return soft_result, info
            if _is_fec_failure(soft_raw, soft_result):
                raw, result = soft_raw, soft_result  # give FEC the better bits
    if _is_fec_failure(raw, result) and info is not None:
        # errors-and-erasures retry: re-read the data region's per-symbol
        # EVM, flag burst-hit bytes, decode again with known positions
        # (2e + f <= 32 per codeword instead of e <= 16)
        p = mode.profile
        sym = p.symbol_len
        n_valid = len(signal)
        n_sym = (n_valid - (info.preamble_idx + 3 * sym)) // sym
        if n_sym > 0:
            pad_len = _bucket_len(n_valid)
            sig = np.zeros(pad_len, np.float32)
            sig[:n_valid] = signal
            evm = np.asarray(
                _evm_core(jnp.asarray(sig), jnp.int32(n_valid), jnp.int32(info.preamble_idx), mode, int(n_sym))
            )
            flags = _byte_erasures(evm, mode, _fec_region_bytes(raw))
            if flags is not None:
                retry = parse_payload_bytes(raw, min_len=10, erasures=flags)
                if not _parse_failed(retry):
                    return retry, info
    return result, info


SYM_BUCKET = 16


def pad_aligned_frame(
    frame: np.ndarray, mode: ModemMode
) -> "tuple[jnp.ndarray, int, int] | FrameError":
    """Zero-pad a sync-aligned frame onto the symbol-count bucket grid.

    Returns (frame_dev [3*sym + n_bucket*sym], n_sym, n_bucket). The jitted
    demod cores take the symbol count as a static shape; retry and
    re-acquisition paths slice frames at arbitrary positions, so without
    bucketing every distinct tail length is a fresh executable, each paying
    a compile. Rounding the symbol count up to SYM_BUCKET caps the
    executables per mode at a handful; per-symbol demod is independent, so
    the extra zero-padded symbols change nothing (the callers truncate to
    n_sym, mirroring the reference's junk-tail tolerance, modem.js:368)."""
    p = mode.profile
    sym = p.symbol_len
    if 3 * sym > len(frame):
        return FrameError("Frame too short for CE")
    n_sym = (len(frame) - 3 * sym) // sym
    if n_sym <= 0:
        return FrameError("No data after CE")
    n_bucket = -(-n_sym // SYM_BUCKET) * SYM_BUCKET
    usable = 3 * sym + n_bucket * sym
    buf = np.zeros(usable, np.float32)
    keep = min(len(frame), usable)
    buf[:keep] = frame[:keep]
    return jnp.asarray(buf), n_sym, n_bucket


def decode_chunk_frame(frame: np.ndarray, mode: ModemMode) -> ParseResult:
    """Decode a frame whose sample 0 is the preamble1 start
    (modem.js:770-803). Used by the streaming receiver after sync."""
    padded = pad_aligned_frame(frame, mode)
    if isinstance(padded, FrameError):
        return padded
    frame_dev, n_sym, n_bucket = padded
    bits = _chunk_core(frame_dev, mode, n_bucket)
    result = _bits_to_parse(np.asarray(bits), n_sym, mode, min_len=6)
    if _parse_failed(result) and _soft_retry_applicable(mode):
        # soft repetition-combining retry (see decode_signal)
        soft = np.asarray(_chunk_soft_core(frame_dev, mode, n_bucket))
        soft = soft[: n_sym * mode.bits_per_symbol]
        soft_raw = bytes(bits_to_bytes(soft_combine(soft, mode.repetition)))
        soft_result = parse_payload_bytes(soft_raw, min_len=6)
        if not _parse_failed(soft_result):
            return soft_result
    if _parse_failed(result):
        b = np.asarray(bits)[: n_sym * mode.bits_per_symbol]
        if mode.repetition > 1:
            b = majority_vote(b, mode.repetition)
        raw_by = bytes(bits_to_bytes(b))
        if _is_fec_failure(raw_by, result):
            evm = np.asarray(_chunk_evm_core(frame_dev, mode, n_bucket))[:n_sym]
            flags = _byte_erasures(evm, mode, _fec_region_bytes(raw_by))
            if flags is not None:
                retry = _bits_to_parse(np.asarray(bits), n_sym, mode, min_len=6, erasures=flags)
                if not _parse_failed(retry):
                    return retry
    if _parse_failed(result):
        # timing-tracked retry: within-frame clock drift (reference
        # incapacity, modem.js:397-405) — last rung of the chunk ladder.
        # The true payload symbol count (read from the decoded header —
        # drift barely touches the first symbols, so the header survives
        # even when the CRC fails) bounds the loop's timing measurement:
        # bucket tails can reach the NEXT frame's preamble, whose pilots
        # would otherwise poison the tracking fit.
        b = np.asarray(bits)[: n_sym * mode.bits_per_symbol]
        if mode.repetition > 1:
            b = majority_vote(b, mode.repetition)
        wire = _wire_payload_len(bytes(bits_to_bytes(b)))
        nv = (
            jnp.int32(min(max(num_symbols_for_payload(wire, mode), 1), n_bucket))
            if wire is not None
            else jnp.int32(n_sym)
        )
        tbits = np.asarray(_chunk_tracked_core(frame_dev, mode, n_bucket, nv))
        tresult = _bits_to_parse(tbits, n_sym, mode, min_len=6)
        if not _parse_failed(tresult):
            return tresult
    return result


def _wire_payload_len(by: bytes) -> int | None:
    """Wire payload length (bytes) read from a decoded frame header,
    CRC-agnostic — None when the type/length fields are unreadable.
    Field layout per parse_metadata / parse_data_chunk / parse_fec."""
    if len(by) < 12:
        return None
    if by[0] == FRAME_DATA:
        return 11 + int.from_bytes(by[5:7], "big")
    if by[0] == FRAME_META:
        return 16 + by[11]
    if by[0] == FRAME_FEC:
        return 5 + int.from_bytes(by[1:5], "big")
    return None


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _chunk_core(frame: jnp.ndarray, mode: ModemMode, n_sym: int) -> jnp.ndarray:
    p = mode.profile
    sym = p.symbol_len
    ch_re, ch_im = phy.estimate_channel(frame[2 * sym : 3 * sym], p)
    data = frame[3 * sym :].reshape(n_sym, sym)
    return phy.demodulate(data, ch_re, ch_im, mode)


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _chunk_soft_core(frame: jnp.ndarray, mode: ModemMode, n_sym: int) -> jnp.ndarray:
    """BPSK soft metrics for a sync-aligned frame (soft-combining retry)."""
    p = mode.profile
    sym = p.symbol_len
    ch_re, ch_im = phy.estimate_channel(frame[2 * sym : 3 * sym], p)
    data = frame[3 * sym :].reshape(n_sym, sym)
    return phy.demodulate_soft_bpsk(data, ch_re, ch_im, mode)


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _chunk_evm_core(frame: jnp.ndarray, mode: ModemMode, n_sym: int) -> jnp.ndarray:
    """Per-symbol EVM for a sync-aligned frame (erasure-retry confidence)."""
    p = mode.profile
    sym = p.symbol_len
    ch_re, ch_im = phy.estimate_channel(frame[2 * sym : 3 * sym], p)
    data = frame[3 * sym :].reshape(n_sym, sym)
    return phy.symbol_evm(data, ch_re, ch_im, mode)


TRACK_BLOCK_SYMS = 8


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def _chunk_tracked_core(
    frame: jnp.ndarray,
    mode: ModemMode,
    n_sym: int,
    n_valid_sym: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Timing-tracked demod of a sync-aligned frame — the chunk-path analog
    of _tracked_core. Recovers frames whose WITHIN-frame clock drift walks
    the fixed symbol windows off the CP (e.g. an 11 s narrowband chunk at
    100 ppm drifts ~50 samples head-to-tail; the reference's phase-only
    pilot correction, modem.js:397-405, cannot follow that). Small tracking
    blocks (8 symbols) let the second-order loop acquire within even a
    ~46-symbol QPSK chunk frame.

    CE + data timing biased TRACK_EARLY_BIAS samples into the CP (see
    _tracked_core: the refined start is exact only to ±1 sample and a late
    window start leaks next-symbol ISI). ``n_valid_sym`` keeps symbols past
    the frame's true payload out of the timing measurement — a bucket-padded
    slice can reach the NEXT frame's preamble, whose pilot-bin phases would
    otherwise corrupt the loop for the real symbols."""
    p = mode.profile
    sym = p.symbol_len
    eb = TRACK_EARLY_BIAS
    ch_re, ch_im = phy.estimate_channel(frame[2 * sym - eb : 3 * sym - eb], p)
    ext = jnp.pad(frame, (0, TRACK_BLOCK_SYMS * sym + 8192))
    bits, _tau = phy.demodulate_tracked(
        ext,
        jnp.int32(3 * sym - eb),
        n_sym,
        ch_re,
        ch_im,
        mode,
        block_syms=TRACK_BLOCK_SYMS,
        n_valid_sym=n_valid_sym,
    )
    return bits


def _bits_to_parse(
    bits: np.ndarray,
    n_sym: int,
    mode: ModemMode,
    min_len: int,
    erasures: np.ndarray | None = None,
) -> ParseResult:
    """Truncate to the valid symbol count, undo repetition, pack, parse."""
    bits = bits[: n_sym * mode.bits_per_symbol]
    if mode.repetition > 1:
        bits = majority_vote(bits, mode.repetition)
    by = bits_to_bytes(bits)
    return parse_payload_bytes(by, min_len=min_len, erasures=erasures)
