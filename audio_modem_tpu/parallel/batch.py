"""Batched multi-stream decode: one compiled program for N streams.

This is the scale path of BASELINE config 5 ('streaming receiver at scale:
64 parallel batched streams'): instead of N host FSMs making N small device
calls, whole batches of stream windows / frames run through one jitted,
mesh-sharded executable. Detection, refinement, channel estimation and
demodulation are all batched over the leading stream axis; XLA partitions
them across devices along that axis with zero cross-device traffic until
the final (tiny) result gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu import phy, sync
from audio_modem_tpu.configs import ModemMode
from audio_modem_tpu.channel import awgn


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def batch_decode_chunk_frames(frames: jnp.ndarray, mode: ModemMode, n_sym: int) -> jnp.ndarray:
    """Frame-aligned batch decode: [B, 3*sym + n_sym*sym] -> bits [B, n_bits].

    Batched decodeChunkFrame (modem.js:770-803): per-frame peak
    normalization (app.js:918-925), CE, demod. The whole batch is one
    program; shard the leading axis to span devices. Frame length is
    unbounded (a ~500 k-sample narrowband frame is one more row shape)."""
    p = mode.profile
    sym = p.symbol_len
    mx = jnp.abs(frames).max(axis=-1, keepdims=True)
    frames = jnp.where(mx > 1e-6, frames / jnp.where(mx > 1e-6, mx, 1.0), frames)
    ch_re, ch_im = phy.estimate_channel(frames[:, 2 * sym : 3 * sym], p)
    data = frames[:, 3 * sym : (3 + n_sym) * sym].reshape(-1, n_sym, sym)
    return phy.demodulate(data, ch_re, ch_im, mode)


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def batch_decode_chunk_frames_packed(
    frames: jnp.ndarray, mode: ModemMode, n_sym: int
) -> jnp.ndarray:
    """Frame-aligned batch decode to PACKED BYTES: [B, frame] -> [B, n_bytes]
    uint8, with repetition majority-vote and MSB-first bit packing fused
    onto the device program as an epilogue.

    This is the BatchReceiver's demod call: moving vote+pack on-device
    shrinks the D2H transfer 8x (32x for x3-repetition modes) and removes
    the per-frame host numpy bit work (reference equivalent: majorityVote +
    bitsToBytes per frame on the JS main thread, modem.js:487-495,
    468-476), so demod+vote+pack is ONE device dispatch per frame group."""
    from audio_modem_tpu.ops.bits import jnp_bits_to_bytes, jnp_majority_vote

    bits = batch_decode_chunk_frames(frames, mode, n_sym)
    b = bits[:, : n_sym * mode.bits_per_symbol]
    if mode.repetition > 1:
        b = jnp_majority_vote(b, mode.repetition)
    return jnp_bits_to_bytes(b)


def _single_signal_decode(sig_ext, n_valid, min_pos, mode: ModemMode, max_syms: int):
    """vmappable pipeline body. ``sig_ext`` is preprocessed AND already
    zero-extended by (3 + max_syms) * symbol_len past its nominal length
    (done once for the whole batch — padding inside vmap materializes a
    second batch-sized buffer per stream)."""
    p = mode.profile
    sym = p.symbol_len
    coarse, coarse_metric = sync.detect_preamble(
        sig_ext, p, n_valid, min_pos=min_pos, stride=sync.COARSE_STRIDE
    )
    start, fine_metric = sync.refine_xcorr(sig_ext, jnp.maximum(coarse, 0), p, n_valid)
    ce = jax.lax.dynamic_slice(sig_ext, (start + 2 * sym,), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)
    data = jax.lax.dynamic_slice(sig_ext, (start + 3 * sym,), (max_syms * sym,))
    bits = phy.demodulate(data.reshape(max_syms, sym), ch_re, ch_im, mode)
    ok = (coarse >= 0) & (fine_metric >= sync.XCORR_THRESHOLD)
    return {
        "start": start,
        "coarse": coarse,
        "coarse_metric": coarse_metric,
        "fine_metric": fine_metric,
        "detected": ok,
        "bits": bits,
    }


def _predicted_signal_decode(sig_ext, coarse, n_valid, mode: ModemMode, max_syms: int):
    """Refine + CE + demod at a PREDICTED coarse position — no detection
    scan. The steady-state chunked sender emits frames on an exact sample
    cadence (frame body + inter-frame silences are synthesized digitally,
    modem.js:718-766 / framing.build_data_chunk_frame), so frame k+1 starts
    at start_k + cadence up to clock drift (~6 samples/frame at 200 ppm) —
    well inside refine_xcorr's ±3·CP search radius. Detection confidence
    comes from the xcorr metric threshold alone; a failed prediction returns
    detected=False and the host re-runs a full scan from its last consumed
    position, so a sender pause or restart can never lose a frame."""
    p = mode.profile
    sym = p.symbol_len
    start, fine_metric = sync.refine_xcorr(sig_ext, coarse, p, n_valid)
    ce = jax.lax.dynamic_slice(sig_ext, (start + 2 * sym,), (sym,))
    ch_re, ch_im = phy.estimate_channel(ce, p)
    data = jax.lax.dynamic_slice(sig_ext, (start + 3 * sym,), (max_syms * sym,))
    bits = phy.demodulate(data.reshape(max_syms, sym), ch_re, ch_im, mode)
    return {
        "start": start,
        "detected": fine_metric >= sync.XCORR_THRESHOLD,
        "bits": bits,
    }


def preprocess_extend(signals: jnp.ndarray, n_valid: jnp.ndarray, mode: ModemMode, max_syms: int):
    """preprocess + zero-extend, shared by the predicted-slot decode so the
    window is normalized ONCE per round, not once per slot."""
    sym = mode.profile.symbol_len
    sig = sync.preprocess(signals, n_valid)
    return jnp.pad(sig, ((0, 0), (0, (3 + max_syms) * sym)))


def batch_decode_predicted(
    ext: jnp.ndarray,
    coarse: jnp.ndarray,
    n_valid: jnp.ndarray,
    mode: ModemMode,
    max_syms: int,
):
    """[B]-batched _predicted_signal_decode over a preprocess_extend'ed
    window batch."""
    return jax.vmap(
        lambda e, c, nv: _predicted_signal_decode(e, c, nv, mode, max_syms)
    )(ext, coarse, n_valid)


@partial(jax.jit, static_argnames=("mode", "max_syms"))
def batch_decode_signals(
    signals: jnp.ndarray,
    n_valid: jnp.ndarray,
    mode: ModemMode,
    max_syms: int,
    min_pos: jnp.ndarray | None = None,
):
    """Full-pipeline batch decode: [B, T] padded signals + [B] valid lengths.

    Returns dict of [B]-leading arrays (bits [B, max_syms*bits_per_symbol]).
    Shard ``signals``/``n_valid`` over the stream axis for multi-device.
    ``min_pos`` (per-stream, optional) ignores detections before that
    position — the streaming runtime's resume semantics.
    """
    if min_pos is None:
        min_pos = jnp.zeros(signals.shape[0], jnp.int32)
    sym = mode.profile.symbol_len
    sig = sync.preprocess(signals, n_valid)
    ext = jnp.pad(sig, ((0, 0), (0, (3 + max_syms) * sym)))
    return jax.vmap(lambda s, nv, mp: _single_signal_decode(s, nv, mp, mode, max_syms))(
        ext, n_valid, min_pos
    )


@partial(jax.jit, static_argnames=("mode", "n_sym"))
def batch_loopback_step(bits: jnp.ndarray, key: jax.Array, mode: ModemMode, n_sym: int, snr_db: float = 20.0):
    """Full TX -> channel -> RX loopback over a sharded stream batch,
    reduced to a scalar BER — the framework's 'training step' analog: the
    per-stream pipeline is embarrassingly parallel and the final mean is the
    one cross-device collective (all-reduce over the batch axis).

    bits: [B, n_sym * bits_per_symbol] in {0,1}.
    """
    p = mode.profile
    syms = phy.modulate(bits, mode)  # [B, n_sym, sym_len]
    sig = syms.reshape(syms.shape[0], -1)
    ce = jnp.broadcast_to(jnp.asarray(p.ce_symbol), (sig.shape[0], p.symbol_len))
    tx = jnp.concatenate([ce, sig], axis=-1)
    rx = awgn(tx, snr_db, key)
    ch_re, ch_im = phy.estimate_channel(rx[:, : p.symbol_len], p)
    out_bits = phy.demodulate(
        rx[:, p.symbol_len :].reshape(-1, n_sym, p.symbol_len), ch_re, ch_im, mode
    )
    ber = jnp.mean(jnp.abs(out_bits.astype(jnp.float32) - bits.astype(jnp.float32)))
    return ber, out_bits


def pad_signals(signals: list[np.ndarray], pad_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: ragged signal list -> ([B, pad_len] f32, [B] int32).

    The padded length is rounded up to a multiple of 128: a multiple of 64
    so the windowed-sum fast path applies (sync.windowed_sum), and one
    compiled shape for every length within a 128-sample bucket.
    """
    n_valid = np.asarray([len(s) for s in signals], dtype=np.int32)
    t = int(pad_len or int(n_valid.max()))
    t = -(-t // 128) * 128
    out = np.zeros((len(signals), t), dtype=np.float32)
    for i, s in enumerate(signals):
        out[i, : len(s)] = s[:t]
    return out, n_valid


def shardmap_loopback_ber(bits: jnp.ndarray, key: jax.Array, mode: ModemMode, n_sym: int, snr_db: float, mesh) -> jnp.ndarray:
    """Explicit-collective variant of the loopback step: shard_map over the
    stream axis with a hand-placed psum-mean across devices.

    batch_loopback_step relies on GSPMD to partition the same computation;
    this version states the communication explicitly — each device runs its
    stream shard fully locally (TX -> AWGN -> RX -> local BER) and the ONLY
    cross-device traffic is the final scalar jax.lax.pmean, which is the
    true communication profile of this domain (independent streams, metric
    reduction at the end).
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from audio_modem_tpu.parallel.mesh import STREAM_AXIS

    def local_step(bits_shard, key):
        ber, _ = batch_loopback_step(bits_shard, key, mode, n_sym, snr_db)
        return jax.lax.pmean(ber, STREAM_AXIS)

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(STREAM_AXIS), P()),
        out_specs=P(),
    )
    return fn(bits, key)
