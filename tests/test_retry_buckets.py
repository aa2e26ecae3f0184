"""Retry/re-acquisition shape bucketing (decoder.pad_aligned_frame): no
input length may trigger an unbounded fresh jit compile — otherwise one
noisy decode could pay a fresh compile for every distinct tail length."""

import numpy as np

from audio_modem_tpu import decoder, framing
from audio_modem_tpu.configs import MODES


def _aligned_frame(mode, payload=256, seed=0):
    rng = np.random.default_rng(seed)
    f = framing.build_data_chunk_frame(rng.bytes(payload), 0, mode)
    return f[mode.profile.silence_pre_chunk(False) :], rng


def test_decode_chunk_frame_caches_per_bucket():
    """10 random tail lengths -> at most as many _chunk_core executables as
    distinct SYM_BUCKET buckets (each decode still parses its payload)."""
    mode = MODES["QPSK"]
    sym = mode.profile.symbol_len
    f0, rng = _aligned_frame(mode)
    base = decoder._chunk_core._cache_size()
    buckets = set()
    for tail in rng.integers(0, 8 * sym, 10):
        frame = np.concatenate(
            [f0, 0.01 * rng.standard_normal(int(tail)).astype(np.float32)]
        )
        n_sym = (len(frame) - 3 * sym) // sym
        buckets.add(-(-n_sym // decoder.SYM_BUCKET))
        result = decoder.decode_chunk_frame(frame, mode)
        assert isinstance(result, framing.DataFrame) and result.crc_valid
    grown = decoder._chunk_core._cache_size() - base
    assert grown <= len(buckets)


def test_bucketed_demod_bits_match_exact():
    """Bucketed zero-padding must not change the decode: per-symbol demod is
    independent, so the first n_sym symbols' bits are identical whether the
    core runs at the exact symbol count or the padded bucket count."""
    import jax.numpy as jnp

    for name in ("QPSK", "BPSK-NARROW"):
        mode = MODES[name]
        sym = mode.profile.symbol_len
        f0, rng = _aligned_frame(mode, payload=64, seed=3)
        noisy = f0 + 0.01 * rng.standard_normal(len(f0)).astype(np.float32)
        n_sym = (len(noisy) - 3 * sym) // sym
        exact = np.asarray(
            decoder._chunk_core(jnp.asarray(noisy[: (3 + n_sym) * sym]), mode, n_sym)
        )
        fdev, n_sym_b, n_bucket = decoder.pad_aligned_frame(noisy, mode)
        assert n_sym_b == n_sym and n_bucket >= n_sym
        bucketed = np.asarray(decoder._chunk_core(fdev, mode, n_bucket))
        nb = n_sym * mode.bits_per_symbol
        assert np.array_equal(exact[:nb], bucketed[:nb]), name


def test_pad_aligned_frame_short_inputs():
    mode = MODES["QPSK"]
    sym = mode.profile.symbol_len
    assert isinstance(
        decoder.pad_aligned_frame(np.zeros(2 * sym, np.float32), mode), framing.FrameError
    )
    assert isinstance(
        decoder.pad_aligned_frame(np.zeros(3 * sym + 1, np.float32), mode),
        framing.FrameError,
    )
