"""Float64 NumPy oracle of the reference JS modem (test fixture generator).

No JS runtime exists in this image, so golden vectors are produced by this
oracle: an algorithmically faithful float64 model of /root/reference/modem.js.
JS numbers are IEEE-754 doubles, so all arithmetic here matches the reference
bit-for-bit except FFT internals (numpy's FFT and the reference's radix-2
differ only in rounding, ~1e-13 relative); the bit-exactness contract is at
the decoded-PAYLOAD level, where thresholded decisions give wide margin.

This module is TEST-ONLY. The framework under test (audio_modem_tpu) never
imports it. Structure citations are given per function.
"""

from __future__ import annotations

import numpy as np

from audio_modem_tpu.configs import OFDM_PROFILES, MODES, OfdmProfile, ModemMode
from audio_modem_tpu.ops.crc32 import crc32
from audio_modem_tpu.ops.lcg import js_lcg_signs


# ---------- L1/L2: symbol synthesis (modem.js:158-208, 322-362) ----------


def _hermitian_ifft(spec_active: np.ndarray, bins: np.ndarray, p: OfdmProfile) -> np.ndarray:
    """Place complex values on bins, Hermitian-extend, IFFT -> real f64."""
    half = np.zeros(p.fft_size // 2 + 1, dtype=np.complex128)
    half[bins] = spec_active
    return np.fft.irfft(half, n=p.fft_size)


def _add_cp(td: np.ndarray, p: OfdmProfile) -> np.ndarray:
    """modem.js:202-208 — prepend CP, cast to float32."""
    return np.concatenate([td[-p.cp_len :], td]).astype(np.float32)


def preamble1(p: OfdmProfile) -> np.ndarray:
    bins = np.arange(p.sub_start, p.sub_end + 1, 2)
    return _add_cp(_hermitian_ifft(js_lcg_signs(42, len(bins)), bins, p), p)


def preamble2(p: OfdmProfile) -> np.ndarray:
    bins = np.arange(p.sub_start, p.sub_end + 1)
    return _add_cp(_hermitian_ifft(js_lcg_signs(43, len(bins)), bins, p), p)


def ce_symbol(p: OfdmProfile) -> tuple[np.ndarray, np.ndarray]:
    """Returns (samples_f32, known_signs_on_active_bins_f64)."""
    bins = np.arange(p.sub_start, p.sub_end + 1)
    signs = js_lcg_signs(44, len(bins))
    return _add_cp(_hermitian_ifft(signs, bins, p), p), signs


def _constellation_points(name: str) -> np.ndarray:
    from audio_modem_tpu.ops.constellations import CONSTELLATIONS

    return CONSTELLATIONS[name].points_np()


def modulate_ofdm(bits: np.ndarray, mod_name: str, p: OfdmProfile) -> np.ndarray:
    """modem.js:322-362 — bits -> [num_symbols, symbol_len] float32."""
    pts = _constellation_points(mod_name)
    bps = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}[mod_name]
    n_data = p.num_data_subs
    bits_per_symbol = n_data * bps
    bits = np.asarray(bits, dtype=np.int64)
    pad = (-len(bits)) % bits_per_symbol
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.int64)])
    n_sym = len(bits) // bits_per_symbol
    groups = bits.reshape(n_sym, n_data, bps)
    weights = 2 ** np.arange(bps - 1, -1, -1)
    idx = (groups * weights).sum(axis=2)
    data_vals = pts[idx, 0] + 1j * pts[idx, 1]  # [n_sym, n_data]

    active = np.arange(p.sub_start, p.sub_end + 1)
    pilot_mask = np.isin(active, np.asarray(p.pilots))
    out = np.empty((n_sym, p.symbol_len), dtype=np.float32)
    for s in range(n_sym):
        spec = np.zeros(len(active), dtype=np.complex128)
        spec[pilot_mask] = 1.0
        spec[~pilot_mask] = data_vals[s]
        out[s] = _add_cp(_hermitian_ifft(spec, active, p), p)
    return out


# ---------- L3: byte/bit, repetition, framing (modem.js:460-766) ----------


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8)).astype(np.int64)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    n = (len(bits) // 8) * 8
    return np.packbits(np.asarray(bits[:n], dtype=np.uint8)).tobytes()


def repeat_bits(bits: np.ndarray, n: int) -> np.ndarray:
    return np.repeat(bits, n)


def majority_vote(bits: np.ndarray, n: int) -> np.ndarray:
    m = len(bits) // n
    return (bits[: m * n].reshape(m, n).sum(axis=1) * 2 >= n).astype(np.int64)


def _be32(v: int) -> bytes:
    return bytes([(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])


def build_legacy_payload(file_data: bytes, file_name: str) -> bytes:
    """modem.js:498-522 — [nameLen:1][name][dataLen:4][data][CRC:4]."""
    name = (file_name or "file").encode("utf-8")[:255]
    body = bytes([len(name)]) + name + _be32(len(file_data)) + file_data
    return body + _be32(crc32(body))


def build_metadata_payload(total_chunks: int, total_size: int, chunk_size: int, file_name: str) -> bytes:
    """modem.js:666-692."""
    name = (file_name or "file").encode("utf-8")[:255]
    body = (
        bytes([0xFE])
        + _be32(total_chunks)
        + _be32(total_size)
        + bytes([(chunk_size >> 8) & 0xFF, chunk_size & 0xFF])
        + bytes([len(name)])
        + name
    )
    return body + _be32(crc32(body))


def build_data_chunk_payload(chunk: bytes, seq: int) -> bytes:
    """modem.js:694-714."""
    body = bytes([0xFF]) + _be32(seq) + bytes([(len(chunk) >> 8) & 0xFF, len(chunk) & 0xFF]) + chunk
    return body + _be32(crc32(body))


def _assemble_frame(
    payload: bytes, mode: ModemMode, silence_pre: int, silence_post: int
) -> np.ndarray:
    """Common frame synthesis: silence|pre1|pre2|CE|data|silence, 0.8 norm."""
    p = mode.profile
    bits = bytes_to_bits(payload)
    if mode.repetition > 1:
        bits = repeat_bits(bits, mode.repetition)
    syms = modulate_ofdm(bits, mode.constellation, p)
    ce, _ = ce_symbol(p)
    parts = [
        np.zeros(silence_pre, dtype=np.float32),
        preamble1(p),
        preamble2(p),
        ce,
        syms.reshape(-1),
        np.zeros(silence_post, dtype=np.float32),
    ]
    sig = np.concatenate(parts)
    mx = np.abs(sig).max()
    if mx > 0:
        sig = (sig.astype(np.float64) * (0.8 / mx)).astype(np.float32)
    return sig


def build_transmit_signal(file_data: bytes, mode_name: str, file_name: str) -> np.ndarray:
    """modem.js:498-555 — legacy single-frame signal."""
    mode = MODES[mode_name]
    p = mode.profile
    payload = build_legacy_payload(file_data, file_name)
    return _assemble_frame(payload, mode, p.silence_pre_legacy(), p.silence_post_legacy())


def build_metadata_frame(total_chunks: int, total_size: int, chunk_size: int, file_name: str, mode_name: str) -> np.ndarray:
    """modem.js:758-761."""
    mode = MODES[mode_name]
    p = mode.profile
    payload = build_metadata_payload(total_chunks, total_size, chunk_size, file_name)
    return _assemble_frame(payload, mode, p.silence_pre_chunk(True), p.silence_post_chunk())


def build_data_chunk_frame(chunk: bytes, seq: int, mode_name: str) -> np.ndarray:
    """modem.js:763-766."""
    mode = MODES[mode_name]
    p = mode.profile
    payload = build_data_chunk_payload(chunk, seq)
    return _assemble_frame(payload, mode, p.silence_pre_chunk(False), p.silence_post_chunk())


# ---------- L2/L3: receive path (modem.js:213-440, 557-654, 770-849) ----------


def preprocess_signal(signal: np.ndarray) -> np.ndarray:
    """modem.js:213-232 — DC removal + unit-peak normalization."""
    s = signal.astype(np.float64)
    out = s - s.mean()
    mx = np.abs(out).max()
    if mx > 1e-6:
        out = out / mx
    return out.astype(np.float32)


def detect_preamble(signal: np.ndarray, p: OfdmProfile, first_peak: bool = True) -> int:
    """Sliding Schmidl-Cox autocorrelation (modem.js:286-319).

    ``first_peak=True`` (default) applies the streaming receiver's
    first-peak-with-hysteresis commit (app.js:829-839): stop at the first
    position where the metric drops below 0.7x the running max after the
    threshold was cleared. ``first_peak=False`` reproduces the manual path's
    global argmax (modem.js:304-318), which mis-syncs on payloads whose
    zero-bit runs produce identical consecutive OFDM symbols (metric exactly
    1.0 inside the data region) — kept to document that reference bug.
    """
    half = p.fft_size // 2
    s = signal.astype(np.float64)
    n = len(s)
    if n < 2 * half:
        return -1
    prod = s[: n - half] * s[half:]
    sq = s * s
    cp = np.concatenate([[0.0], np.cumsum(prod)])
    cs = np.concatenate([[0.0], np.cumsum(sq)])
    n_pos = n - 2 * half + 1
    d = np.arange(n_pos)
    P = cp[d + half] - cp[d]
    Ra = cs[d + half] - cs[d]
    Rb = cs[d + 2 * half] - cs[d + half]
    valid = (Ra > 0.01) & (Rb > 0.01)
    metric = np.where(valid, (P * P) / np.where(valid, Ra * Rb, 1.0), 0.0)
    if n_pos == 0:
        return -1
    if first_peak:
        runmax = np.maximum.accumulate(metric)
        drop = (runmax > 0.5) & (metric < 0.7 * runmax)
        end = int(np.argmax(drop)) if drop.any() else n_pos - 1
        metric = metric[: end + 1]
    best = metric.max()
    if best <= 0.5:
        return -1
    return int(metric.argmax())


def _xcorr_refine(signal: np.ndarray, template: np.ndarray, lo: int, hi: int) -> tuple[int, float]:
    """Fine normalized cross-correlation scan over d in [lo, hi]
    (modem.js:567-588)."""
    s = signal.astype(np.float64)
    t = template.astype(np.float64)
    t_energy = (t * t).sum()
    best_metric, best_pos = -np.inf, lo
    sq = np.concatenate([[0.0], np.cumsum(s * s)])
    for d in range(lo, hi + 1):
        seg = s[d : d + len(t)]
        corr = seg @ t
        s_energy = sq[d + len(t)] - sq[d]
        denom = np.sqrt(s_energy * t_energy)
        if denom > 0.001:
            m = corr / denom
            if m > best_metric:
                best_metric, best_pos = m, d
    return best_pos, best_metric


def estimate_channel(ce_samples: np.ndarray, p: OfdmProfile) -> np.ndarray:
    """modem.js:421-440 — complex channel on active bins (known X = ±1)."""
    _, known = ce_symbol(p)
    td = ce_samples[p.cp_len : p.cp_len + p.fft_size].astype(np.float64)
    if len(td) < p.fft_size:
        td = np.pad(td, (0, p.fft_size - len(td)))
    spec = np.fft.fft(td)
    active = np.arange(p.sub_start, p.sub_end + 1)
    y = spec[active]
    # H = Y * conj(X) / |X|^2 with X real ±1 -> H = Y * X
    return y * known


def demodulate_ofdm(signal: np.ndarray, mod_name: str, ch: np.ndarray, p: OfdmProfile) -> np.ndarray:
    """modem.js:365-418 — per-symbol FFT, ZF EQ, pilot phase fix, demap."""
    pts = _constellation_points(mod_name)
    bps = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}[mod_name]
    active = np.arange(p.sub_start, p.sub_end + 1)
    pilot_mask = np.isin(active, np.asarray(p.pilots))
    n_sym = len(signal) // p.symbol_len
    all_bits = []
    h_mag = np.abs(ch) ** 2
    for s_i in range(n_sym):
        off = s_i * p.symbol_len
        td = signal[off + p.cp_len : off + p.cp_len + p.fft_size].astype(np.float64)
        if len(td) < p.fft_size:
            td = np.pad(td, (0, p.fft_size - len(td)))
        spec = np.fft.fft(td)[active]
        eq = np.where(h_mag > 1e-10, spec * np.conj(ch) / np.where(h_mag > 1e-10, h_mag, 1.0), spec)
        # Pilot common-phase (small-angle) correction (modem.js:397-405)
        pr = eq[pilot_mask]
        usable = np.abs(pr.real) > 1e-6
        phase = (pr.imag[usable] / pr.real[usable]).mean() if usable.any() else 0.0
        data = eq[~pilot_mask]
        cr = data.real + data.imag * phase
        ci = data.imag - data.real * phase
        d2 = (cr[:, None] - pts[None, :, 0]) ** 2 + (ci[:, None] - pts[None, :, 1]) ** 2
        idx = d2.argmin(axis=1)
        shifts = np.arange(bps - 1, -1, -1)
        bits = (idx[:, None] >> shifts[None, :]) & 1
        all_bits.append(bits.reshape(-1))
    if not all_bits:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(all_bits)


def parse_metadata(by: bytes) -> dict:
    """modem.js:805-828."""
    if len(by) < 16:
        return {"error": "Metadata frame too short"}
    total_chunks = int.from_bytes(by[1:5], "big")
    total_size = int.from_bytes(by[5:9], "big")
    chunk_size = int.from_bytes(by[9:11], "big")
    name_len = by[11]
    off = 12 + name_len
    if off + 4 > len(by):
        return {"error": "Metadata frame truncated"}
    file_name = by[12:off].decode("utf-8", errors="replace")
    expected = int.from_bytes(by[off : off + 4], "big")
    return {
        "frame_type": 0xFE,
        "total_chunks": total_chunks,
        "total_size": total_size,
        "chunk_size": chunk_size,
        "file_name": file_name,
        "crc_valid": expected == crc32(by[:off]),
    }


def parse_data_chunk(by: bytes) -> dict:
    """modem.js:830-849."""
    if len(by) < 11:
        return {"error": "Data chunk frame too short"}
    seq = int.from_bytes(by[1:5], "big")
    dlen = int.from_bytes(by[5:7], "big")
    off = 7 + dlen
    if off + 4 > len(by):
        return {"error": "Data chunk truncated"}
    data = by[7:off]
    expected = int.from_bytes(by[off : off + 4], "big")
    return {"frame_type": 0xFF, "seq": seq, "data": data, "crc_valid": expected == crc32(by[:off])}


def parse_legacy(by: bytes) -> dict:
    """modem.js:622-653."""
    if len(by) < 10:
        return {"error": "Decoded data too short"}
    name_len = by[0]
    off = 1 + name_len
    if off + 8 > len(by):
        return {"error": "too short for header"}
    file_name = by[1:off].decode("utf-8", errors="replace")
    dlen = int.from_bytes(by[off : off + 4], "big")
    off += 4
    if dlen <= 0 or off + dlen + 4 > len(by):
        return {"error": f"Invalid data length: {dlen}"}
    data = by[off : off + dlen]
    off += dlen
    expected = int.from_bytes(by[off : off + 4], "big")
    return {
        "frame_type": "legacy",
        "file_name": file_name,
        "data": data,
        "crc_valid": expected == crc32(by[:off]),
    }


def decode_received_signal(signal: np.ndarray, mode_name: str) -> dict:
    """modem.js:557-654 — full-signal decode."""
    mode = MODES[mode_name]
    p = mode.profile
    sig = preprocess_signal(signal)
    coarse = detect_preamble(sig, p)
    if coarse < 0:
        return {"error": "Preamble not detected"}
    pre1 = preamble1(p)
    radius = p.cp_len * 3
    lo = max(0, coarse - radius)
    hi = min(len(sig) - len(pre1), coarse + radius)
    start, best = _xcorr_refine(sig, pre1, lo, hi)
    if best < 0.1:
        return {"error": "Preamble not detected (low correlation)"}
    ce_start = start + 2 * p.symbol_len
    if ce_start + p.symbol_len > len(sig):
        return {"error": "Signal too short for CE"}
    ch = estimate_channel(sig[ce_start : ce_start + p.symbol_len], p)
    data_start = ce_start + p.symbol_len
    bits = demodulate_ofdm(sig[data_start:], mode.constellation, ch, p)
    if mode.repetition > 1:
        bits = majority_vote(bits, mode.repetition)
    by = bits_to_bytes(bits)
    if len(by) < 10:
        return {"error": "Decoded data too short"}
    if by[0] == 0xFE:
        return parse_metadata(by) | {"preamble_idx": start}
    if by[0] == 0xFF:
        return parse_data_chunk(by) | {"preamble_idx": start}
    return parse_legacy(by) | {"preamble_idx": start}


def decode_chunk_frame(frame: np.ndarray, mode_name: str) -> dict:
    """modem.js:770-803 — frame starting at preamble1 sample 0."""
    mode = MODES[mode_name]
    p = mode.profile
    ce_start = 2 * p.symbol_len
    if ce_start + p.symbol_len > len(frame):
        return {"error": "Frame too short for CE"}
    ch = estimate_channel(frame[ce_start : ce_start + p.symbol_len], p)
    bits = demodulate_ofdm(frame[ce_start + p.symbol_len :], mode.constellation, ch, p)
    if mode.repetition > 1:
        bits = majority_vote(bits, mode.repetition)
    by = bits_to_bytes(bits)
    if len(by) < 6:
        return {"error": "Decoded data too short"}
    if by[0] == 0xFE:
        return parse_metadata(by)
    if by[0] == 0xFF:
        return parse_data_chunk(by)
    return {"error": f"Unknown frame type: {by[0]:#x}"}
