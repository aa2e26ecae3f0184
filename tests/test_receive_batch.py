"""The batched receive programs (parallel.batch) against their source data:
every mode decodes payload-exact through both the full-pipeline decode
(detect + refine + CE + demod) and the frame-aligned decode, and the
receive-direction DFT matches a float64 DFT."""

import jax.numpy as jnp
import numpy as np
import pytest

from audio_modem_tpu import framing
from audio_modem_tpu.configs import MODES, OFDM_PROFILES
from audio_modem_tpu.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu.ops.dft import time_to_spec
from audio_modem_tpu.parallel.batch import (
    batch_decode_chunk_frames,
    batch_decode_signals,
    pad_signals,
)

ALL_MODES = sorted(MODES)


def _chunks(mode, n: int, seed: int, size: int | None = None) -> list[bytes]:
    rng = np.random.default_rng(seed)
    size = size or (128 if mode.constellation == "BPSK" else min(mode.chunk_size, 1024))
    return [rng.bytes(size) for _ in range(n)]


def _parse(bits: np.ndarray, n_sym: int, mode) -> framing.ParseResult:
    b = bits[: n_sym * mode.bits_per_symbol]
    if mode.repetition > 1:
        b = majority_vote(b, mode.repetition)
    return framing.parse_payload_bytes(bits_to_bytes(b), min_len=6)


def _assert_chunk(result, data: bytes, seq: int) -> None:
    assert isinstance(result, framing.DataFrame), getattr(result, "error", result)
    assert result.crc_valid and result.seq_num == seq and result.data == data


@pytest.mark.parametrize("mode_name", ALL_MODES)
def test_batch_decode_signals_payload_exact(mode_name):
    mode = MODES[mode_name]
    sym = mode.profile.symbol_len
    chunks = _chunks(mode, 3, seed=7)
    rng = np.random.default_rng(8)
    frames = [
        f + 0.001 * rng.standard_normal(len(f)).astype(np.float32)
        for f in framing.build_data_chunk_frames(chunks, 5, mode)
    ]
    signals, n_valid = pad_signals(frames, pad_len=len(frames[0]) + 2 * sym)
    max_syms = (signals.shape[1] - 3 * sym) // sym
    out = batch_decode_signals(jnp.asarray(signals), jnp.asarray(n_valid), mode, max_syms)
    assert np.asarray(out["detected"]).all()
    starts, bits = np.asarray(out["start"]), np.asarray(out["bits"])
    for i, data in enumerate(chunks):
        n_sym = (int(n_valid[i]) - (int(starts[i]) + 3 * sym)) // sym
        _assert_chunk(_parse(bits[i], n_sym, mode), data, 5 + i)


@pytest.mark.parametrize("mode_name", ALL_MODES)
def test_batch_decode_chunk_frames_payload_exact(mode_name):
    mode = MODES[mode_name]
    p = mode.profile
    chunks = _chunks(mode, 3, seed=11)
    n_sym = framing.num_symbols_for_payload(len(chunks[0]) + 11, mode)
    rng = np.random.default_rng(12)
    frames = np.stack([
        f[p.silence_pre_chunk(False):][: (3 + n_sym) * p.symbol_len]
        for f in framing.build_data_chunk_frames(chunks, 0, mode)
    ])
    frames += 0.001 * rng.standard_normal(frames.shape).astype(np.float32)
    bits = np.asarray(batch_decode_chunk_frames(jnp.asarray(frames), mode, n_sym))
    for i, data in enumerate(chunks):
        _assert_chunk(_parse(bits[i], n_sym, mode), data, i)


def test_no_preamble_not_detected():
    """Pure noise, full and partial valid lengths: nothing is detected."""
    rng = np.random.default_rng(3)
    signals = jnp.asarray(rng.standard_normal((2, 16384)).astype(np.float32) * 0.05)
    n_valid = jnp.asarray([16384, 9000], jnp.int32)
    out = batch_decode_signals(signals, n_valid, MODES["QPSK"], 8)
    assert not np.asarray(out["detected"]).any()


def test_long_narrowband_chunk_frame_over_500k():
    """A 600 B x3-repetition narrowband chunk frame is longer than 500 k
    samples; the frame-aligned decode takes it as one more row shape."""
    mode = MODES["BPSK-NARROW"]
    p = mode.profile
    chunks = _chunks(mode, 2, seed=17, size=600)
    n_sym = framing.num_symbols_for_payload(600 + 11, mode)
    frames = np.stack([
        f[p.silence_pre_chunk(False):][: (3 + n_sym) * p.symbol_len]
        for f in framing.build_data_chunk_frames(chunks, 3, mode)
    ])
    assert frames.shape[1] > 500_000
    bits = np.asarray(batch_decode_chunk_frames(jnp.asarray(frames), mode, n_sym))
    for i, data in enumerate(chunks):
        _assert_chunk(_parse(bits[i], n_sym, mode), data, 3 + i)


@pytest.mark.parametrize("profile_name", sorted(OFDM_PROFILES))
def test_time_to_spec_matches_float64_dft(profile_name):
    """dot_bf16x3's active-bin DFT against numpy's float64 rfft: within
    1e-4 of each row's peak (decisions downstream have >= 0.1 margins)."""
    prof = OFDM_PROFILES[profile_name]
    body = np.random.default_rng(5).standard_normal((8, 46, prof.fft_size)).astype(np.float32)
    re, im = time_to_spec(jnp.asarray(body), prof)
    ref = np.fft.rfft(body.astype(np.float64), axis=-1)[..., prof.active_bins]
    for got, want in ((re, ref.real), (im, ref.imag)):
        peak = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(np.asarray(got, np.float64) - want) / peak).max() < 1e-4
