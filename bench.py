"""Benchmark: batched streaming-demod throughput on one device.

Prints ONE JSON line (stdout):
  metric       demod Msamples/s on the full receive pipeline (preprocess +
               Schmidl-Cox detect + xcorr refine + CE + EQ + demap) over
               64 QPSK streams, 32 frames per stream per dispatch
  vs_baseline  value / 44.1 — multiples of the BASELINE.json target of
               1000x real-time demodulation at 44.1 kHz
               (the reference JS processes ~1x real time per core)

Extra context (512/4096-stream scale points, frame demod-only throughput,
encode throughput, per-mode matrix, frames/s, detect p50 latency, the
BatchReceiver runtime) goes in "details", logged to stderr and written to
the file AMT_BENCH_DETAILS names, if set. Each stage is optional and
budget-gated so the headline ALWAYS prints. Budget via AMT_BENCH_BUDGET_S
(default 1500 s). Progress goes to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

T0 = time.time()
BUDGET = float(os.environ.get("AMT_BENCH_BUDGET_S", "1500"))


def log(msg: str) -> None:
    print(f"[bench +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def left() -> float:
    return BUDGET - (time.time() - T0)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from audio_modem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from audio_modem_tpu import framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.ops.bits import bits_to_bytes
    from audio_modem_tpu.framing import parse_payload_bytes, DataFrame
    from audio_modem_tpu.parallel.batch import (
        batch_decode_chunk_frames,
        batch_decode_signals,
        pad_signals,
    )

    mode = MODES["QPSK"]
    p = mode.profile
    sym = p.symbol_len
    chunk_size = mode.chunk_size  # 2048
    n_streams = 64
    iters = 10
    details: dict = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    skipped: list[str] = []

    log(f"building {n_streams} QPSK frames")
    rng = np.random.default_rng(0)
    # ONE batched synthesis call for all frames
    frames = list(
        framing.build_data_chunk_frames([rng.bytes(chunk_size) for _ in range(8)], 0, mode)
    )
    frames = frames * (n_streams // len(frames))
    signals, n_valid = pad_signals(frames)
    pad_len = signals.shape[1]
    n_payload_sym = framing.num_symbols_for_payload(chunk_size + 11, mode)
    max_syms = max((pad_len - 3 * sym) // sym, 1)

    sig_dev = jax.device_put(jnp.asarray(signals))
    nv_dev = jax.device_put(jnp.asarray(n_valid))

    # ---- headline: full pipeline (detect + refine + demod), 64 streams ----
    log("compiling full pipeline (64 streams)")
    full = jax.jit(lambda s, nv: batch_decode_signals(s, nv, mode, max_syms))
    out = jax.block_until_ready(full(sig_dev, nv_dev))  # compile + warm
    assert bool(np.asarray(out["detected"]).all()), "bench decode failed detection"

    # correctness spot-check: stream 0 payload must parse with valid CRC
    start0 = int(np.asarray(out["start"])[0])
    n_sym0 = (int(n_valid[0]) - (start0 + 3 * sym)) // sym
    bits0 = np.asarray(out["bits"][0])[: n_sym0 * mode.bits_per_symbol]
    parsed = parse_payload_bytes(bits_to_bytes(bits0))
    assert isinstance(parsed, DataFrame) and parsed.crc_valid, "bench payload corrupt"

    log("timing single-frame full pipeline (detail)")
    dt_1f = 1e9
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = full(sig_dev, nv_dev)
        jax.block_until_ready(out)
        dt_1f = min(dt_1f, time.perf_counter() - t0)
    msps_1f = int(n_valid.sum()) * iters / dt_1f / 1e6
    details["headline_1frame_msps"] = round(msps_1f, 2)
    log(f"single-frame-per-dispatch: {msps_1f:.1f} Msamples/s")

    # ---- HEADLINE: steady-state K-frame turbo round ----
    # One dispatch decodes K frames per stream (scan slot 0 + K-1 cadence-
    # predicted refine+demods) — the runtime's sustained program
    # (parallel/multi_receiver._batch_window_decode_multi, what BatchReceiver
    # dispatches every steady-state round); K=32 moves ~56 Msamples/call.
    from audio_modem_tpu.parallel.multi_receiver import (
        _batch_window_decode_multi,
        _classify_round,
    )

    K = 32
    est_len = framing.estimate_frame_samples(chunk_size + 11, mode)
    cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
    margin = 4 * sym + p.fft_size + 2048  # _multi_params margin (2*half = fft)
    w_turbo = -(-(K * cadence + margin) // 128) * 128
    log(f"building {n_streams}x{K}-frame turbo windows (w={w_turbo})")
    pls_turbo = np.frombuffer(
        b"".join(
            framing.build_data_chunk_payload(rng.bytes(chunk_size), s % K)
            for s in range(n_streams * K)
        ),
        np.uint8,
    ).reshape(n_streams * K, -1)
    frames_turbo = framing._synth_frames_core(
        jnp.asarray(pls_turbo), mode, n_payload_sym,
        p.silence_pre_chunk(False), p.silence_post_chunk(),
    ).reshape(n_streams, K * cadence)
    win_turbo = jax.block_until_ready(
        jnp.pad(frames_turbo, ((0, 0), (0, w_turbo - K * cadence)))
    )
    minp = jax.device_put(jnp.zeros(n_streams, jnp.int32))
    nv_turbo = jax.device_put(jnp.full(n_streams, K * cadence, jnp.int32))
    log("compiling K-frame turbo round")
    packed = jax.block_until_ready(
        _batch_window_decode_multi(
            win_turbo, minp, nv_turbo, mode, n_payload_sym, K, cadence
        )
    )
    cls = _classify_round(np.asarray(packed), chunk_size)
    assert cls is not None, "turbo packed rows too narrow"
    det_t, _, full_t, seq_t = cls
    assert bool(det_t.all()), "turbo round: not all slots detected"
    assert bool(full_t.all()), "turbo round: not all slots CRC-valid"
    assert bool((seq_t == np.arange(K)[None, :]).all()), "turbo seq mismatch"

    log("timing K-frame turbo rounds")
    dt_full = 1e9
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out_t = _batch_window_decode_multi(
                win_turbo, minp, nv_turbo, mode, n_payload_sym, K, cadence
            )
        jax.block_until_ready(out_t)
        dt_full = min(dt_full, time.perf_counter() - t0)
    # samples consumed per dispatch = K frame cadences per stream (the same
    # accounting the runtime's pred_dispatch stage uses)
    total_samples = K * cadence * n_streams * iters
    msps_full = total_samples / dt_full / 1e6
    details["headline_frames_per_dispatch"] = K
    details["headline_samples_per_dispatch"] = K * cadence * n_streams
    details["headline_percall_ms"] = round(dt_full / iters * 1e3, 3)
    details["frames_per_sec"] = round(n_streams * K * iters / dt_full, 1)
    log(f"headline: {msps_full:.1f} Msamples/s")

    def emit() -> None:
        realtime_x = msps_full * 1e6 / 44100.0
        details["realtime_streams"] = round(realtime_x, 0)
        if skipped:
            details["skipped_stages"] = skipped
        headline = {
            "metric": "streaming demod Msamples/s (64-stream QPSK, 32-frame turbo rounds, full pipeline)",
            "value": round(msps_full, 2),
            "unit": "Msamples/s",
            "vs_baseline": round(msps_full / 44.1, 3),
        }
        # the headline is the FINAL stdout line, kept compact; details go
        # to stderr and, if AMT_BENCH_DETAILS is set, to that file
        log(f"details: {json.dumps(details)}")
        details_path = os.environ.get("AMT_BENCH_DETAILS")
        if details_path:
            with open(details_path, "w") as f:
                json.dump({**headline, "details": details}, f, indent=2)
            log(f"details written to {details_path}")
        print(json.dumps(headline), flush=True)

    def stage(name: str, min_left_s: float):
        """Budget gate: run the stage if time remains, else record a skip."""

        def deco(fn):
            if left() < min_left_s:
                log(f"SKIP {name} (budget: {left():.0f}s left)")
                skipped.append(name)
                return
            log(f"stage {name} (budget: {left():.0f}s left)")
            try:
                fn()
            except Exception as e:  # a failed detail must not kill the headline
                log(f"stage {name} FAILED: {e}")
                skipped.append(name)

        return deco

    # ---- 512-stream scale point ----
    @stage("batch512", 150.0)
    def _():
        sig512 = jax.device_put(jnp.tile(jnp.asarray(signals), (8, 1)))
        nv512 = jax.device_put(jnp.tile(jnp.asarray(n_valid), (8,)))
        full512 = jax.jit(lambda s, nv: batch_decode_signals(s, nv, mode, max_syms))
        jax.block_until_ready(full512(sig512, nv512))
        dt = 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                out512 = full512(sig512, nv512)
            jax.block_until_ready(out512)
            dt = min(dt, time.perf_counter() - t0)
        msps_512 = sig512.size * iters / dt / 1e6
        details["batch512_full_pipeline_msps"] = round(msps_512, 2)
        details["batch512_realtime_streams"] = round(msps_512 * 1e6 / 44100.0, 0)

    # ---- 4096-stream scale point (dispatch overhead amortized) ----
    @stage("batch4096", 220.0)
    def _():
        sig4k = jax.device_put(jnp.tile(jnp.asarray(signals), (64, 1)))
        nv4k = jax.device_put(jnp.tile(jnp.asarray(n_valid), (64,)))
        full4k = jax.jit(lambda s, nv: batch_decode_signals(s, nv, mode, max_syms))
        jax.block_until_ready(full4k(sig4k, nv4k))
        dt = 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                out4k = full4k(sig4k, nv4k)
            jax.block_until_ready(out4k)
            dt = min(dt, time.perf_counter() - t0)
        msps_4k = sig4k.size * iters / dt / 1e6
        details["batch4096_full_pipeline_msps"] = round(msps_4k, 2)
        details["batch4096_realtime_streams"] = round(msps_4k * 1e6 / 44100.0, 0)

    # ---- detect-only p50 latency (one stream window; pipelined per-call
    # time at depth 10) ----
    @stage("detect_latency", 90.0)
    def _():
        from audio_modem_tpu import sync

        one = jax.jit(lambda s, nv: sync.detect_preamble(s, p, nv))
        s1, nv1 = sig_dev[0], nv_dev[0]
        jax.block_until_ready(one(s1, nv1))
        lats = []
        for _ in range(5):
            t0 = time.perf_counter()
            outs = [one(s1, nv1) for _ in range(10)]
            jax.block_until_ready(outs)
            lats.append((time.perf_counter() - t0) / 10)
        p50 = float(np.median(lats) * 1e3)
        details["p50_detect_latency_ms"] = round(p50, 3)

    # ---- frame-aligned demod only (post-sync path) ----
    @stage("frame_demod", 120.0)
    def _():
        aligned = np.stack(
            [f[p.silence_pre_chunk(False) :][: (3 + n_payload_sym) * sym] for f in frames]
        )
        aligned_dev = jax.device_put(jnp.asarray(aligned))
        demod = jax.jit(lambda f: batch_decode_chunk_frames(f, mode, n_payload_sym))
        jax.block_until_ready(demod(aligned_dev))
        t0 = time.perf_counter()
        for _ in range(iters):
            bits = demod(aligned_dev)
        jax.block_until_ready(bits)
        details["frame_demod_only_msps"] = round(
            aligned.size * iters / (time.perf_counter() - t0) / 1e6, 2
        )

    # ---- encode-side throughput (fused TX contraction, modulate only) ----
    @stage("encode", 120.0)
    def _():
        from audio_modem_tpu import phy
        from audio_modem_tpu.framing import payload_to_bits, build_data_chunk_payload

        bits_one = payload_to_bits(build_data_chunk_payload(rng.bytes(chunk_size), 0), mode)
        bits_batch = jax.device_put(jnp.asarray(np.tile(bits_one, (n_streams, 1))))
        enc = jax.jit(lambda b: phy.modulate(b, mode))
        jax.block_until_ready(enc(bits_batch))
        dt = 1e9
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                enc_out = enc(bits_batch)
            jax.block_until_ready(enc_out)
            dt = min(dt, time.perf_counter() - t0)
        details["encode_modulate_msps"] = round(
            n_streams * n_payload_sym * sym * iters / dt / 1e6, 2
        )

    # ---- FULL frame synthesis (bytes -> frames, the TX peer of the RX
    # pipeline: unpack + repetition + map + fused contraction + header
    # assembly + per-frame norm, one device program; framing._synth_frames_core)
    # at 64 / 512 / 4096 frames per launch ----
    def _encode_frames(nb: int, reps: int, depth: int):
        from audio_modem_tpu.framing import _synth_frames_core, build_data_chunk_payload

        pls = [build_data_chunk_payload(rng.bytes(chunk_size), s) for s in range(nb)]
        u8 = jax.device_put(
            jnp.asarray(np.frombuffer(b"".join(pls), np.uint8).reshape(nb, -1))
        )
        pre = p.silence_pre_chunk(False)
        post = p.silence_post_chunk()
        enc = jax.jit(lambda u: _synth_frames_core(u, mode, n_payload_sym, pre, post))
        out = jax.block_until_ready(enc(u8))
        total = out.shape[0] * out.shape[1]
        dt = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(depth):
                out = enc(u8)
            jax.block_until_ready(out)
            dt = min(dt, time.perf_counter() - t0)
        return round(total * depth / dt / 1e6, 2)

    @stage("encode_frames64", 150.0)
    def _():
        details["encode_frame_synth_msps"] = _encode_frames(64, 5, iters)

    @stage("encode_frames512", 150.0)
    def _():
        details["encode_frames512_msps"] = _encode_frames(512, 3, iters)

    @stage("encode_frames4096", 200.0)
    def _():
        # depth 4: each launch holds a [4096, ~28k] f32 output (~0.5 GB)
        details["encode_frames4096_msps"] = _encode_frames(4096, 3, 4)

    # ---- WHOLE streaming runtime at scale: 64 live streams through
    # BatchReceiver (host FSM + batched scan/refine/demod dispatches),
    # BASELINE config 5's sustained form ----
    @stage("batch_receiver", 250.0)
    def _():
        from audio_modem_tpu import api
        from audio_modem_tpu.parallel.multi_receiver import BatchReceiver

        n, block = 64, 65536
        # host-fed variants: 4 chunks/stream
        data = rng.bytes(chunk_size * 4)
        sig = np.concatenate(list(api.encode_chunked(data, mode, "b.bin", batch=4)))
        blocks_list = []
        for off in range(0, len(sig), block):
            buf = np.zeros((n, block), np.float32)
            seg = sig[off : off + block]
            buf[:, : len(seg)] = seg[None, :]
            blocks_list.append(buf)

        # warm + 1 timed rep
        for label, kw in (
            ("batch_receiver_msps", {}),
            ("batch_receiver_turbo_msps", {"window_decode": True}),
        ):
            def feed_h(rx):
                for b in blocks_list:
                    rx.process_blocks(b)
                rx.flush()

            warm = BatchReceiver(mode, n, scan_bucket=block, **kw)
            feed_h(warm)  # compiles every stage executable
            assert warm.results()[0]["complete"], f"batch_receiver bench decode failed ({label})"
            rx = BatchReceiver(mode, n, scan_bucket=block, **kw)
            t0 = time.perf_counter()
            feed_h(rx)
            details[label] = round(n * len(sig) / (time.perf_counter() - t0) / 1e6, 2)

        # device-resident ingest at STEADY STATE: 128 chunks/stream so the
        # scan-free cadence-predicted rounds (and the speculative fetch
        # pipeline riding them) dominate — a short transfer is mostly
        # startup scans + tail. Blocks are built ON DEVICE as broadcast
        # slices of the uploaded signal — no host ingest in the loop.
        data2 = rng.bytes(chunk_size * 128)
        sig2 = np.concatenate(list(api.encode_chunked(data2, mode, "b2.bin", batch=16)))
        n_blocks = -(-len(sig2) // block)
        sig2_dev = jax.device_put(
            jnp.asarray(np.pad(sig2, (0, n_blocks * block - len(sig2))))
        )
        slice_block = jax.jit(
            lambda s, o: jnp.broadcast_to(
                jax.lax.dynamic_slice(s, (o,), (block,))[None, :], (n, block)
            )
        )
        dev_blocks = [slice_block(sig2_dev, jnp.int32(i * block)) for i in range(n_blocks)]
        jax.block_until_ready(dev_blocks)

        def feed_dev(rx):
            for b in dev_blocks:
                rx.process_blocks(b)
            rx.flush()

        warm = BatchReceiver(mode, n, scan_bucket=block, device_ingest=True)
        feed_dev(warm)
        res0 = warm.results()[0]
        assert res0["complete"] and res0["data"] == data2, "batch_receiver bench decode failed (device)"
        dt = 1e9
        for _ in range(3):
            rx = BatchReceiver(mode, n, scan_bucket=block, device_ingest=True)
            t0 = time.perf_counter()
            feed_dev(rx)
            dt = min(dt, time.perf_counter() - t0)
        details["batch_receiver_device_msps"] = round(n * len(sig2) / dt / 1e6, 2)
        details["batch_receiver_realtime_streams"] = round(
            details["batch_receiver_device_msps"] * 1e6 / 44100.0, 0
        )
        details["batch_receiver_stage_breakdown"] = rx.timer.report()

    # ---- per-mode full-pipeline Msamples/s (all profiles x constellations) ----
    # Catches regressions in acoustic/narrowband matmul shapes (CP 128/256)
    # and the 16/64-QAM demap cost that the QPSK headline can't see. Each
    # mode is its own budget-gated stage. Batch 512 (8 uploaded frames
    # device-tiled x64). BPSK-REPEAT's payload is sized so its x3-repetition frame matches
    # BPSK-ACOUSTIC's sample count — the delta IS the repetition epilogue.
    per_mode: dict = {}
    for mode_name in (
        "QPSK", "16-QAM", "64-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "BPSK-REPEAT"
    ):

        @stage(f"mode:{mode_name}", 200.0)
        def _(mode_name=mode_name):
            m = MODES[mode_name]
            msym = m.profile.symbol_len
            # narrowband at x3 repetition: 128 B (~170k samples, like
            # acoustic at 512 B) instead of 512 B (~500k samples) keeps
            # the stage's batch and compile bounded
            payload = (
                128 if mode_name == "BPSK-NARROW"
                else 512 // m.repetition if "BPSK" in mode_name
                else m.chunk_size
            )
            mframes = list(
                framing.build_data_chunk_frames([rng.bytes(payload) for _ in range(8)], 0, m)
            ) * 8
            msignals, mnv = pad_signals(mframes)
            mmax_syms = max((msignals.shape[1] - 3 * msym) // msym, 1)
            ms_dev = jnp.tile(jax.device_put(jnp.asarray(msignals)), (8, 1))
            mnv_dev = jnp.tile(jax.device_put(jnp.asarray(mnv)), (8,))
            mfull = jax.jit(lambda s, nv, m=m, k=mmax_syms: batch_decode_signals(s, nv, m, k))
            mout = jax.block_until_ready(mfull(ms_dev, mnv_dev)["detected"])
            assert bool(np.asarray(mout).all()), f"{mode_name} bench decode failed detection"
            dt = 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                for _ in range(iters):
                    mo = mfull(ms_dev, mnv_dev)
                jax.block_until_ready(mo["bits"])
                dt = min(dt, time.perf_counter() - t0)
            per_mode[mode_name] = round(8 * int(mnv.sum()) * iters / dt / 1e6, 1)

    if per_mode:
        details["per_mode_msps"] = per_mode
    emit()
    log("done")


if __name__ == "__main__":
    main()
