"""Lossy-channel ARQ soak at scale: >=50 MB aggregate across 64 streams
with injected AWGN + per-stream dropouts, completed to 100% via
selective-repeat ARQ rounds over the batched runtime.

This is the scale variant of arq.run_batch_arq_session (which is host-fed:
fine for its 3-chunk tests, but at 50 MB of PCM it would measure
host-to-device ingest). Round 1 — the bulk — is
device-resident: frames synthesize on device (tools/soak.py's layout) and
the CHANNEL is applied on device per ingest block (channel.awgn + a
per-stream dropout-span mask). Resend rounds are small (the missing tail)
and reuse the arq module's host path: build_request_frame back links,
_decode_request with its full retry ladder, _synthesize_mixed resends.

Two 32-stream sessions: plain QPSK and FEC-wrapped (RS(255,223)) QPSK —
"FEC on half the streams"; a single BatchReceiver is (deliberately) all-FEC
or none, since the flag sets the steady-state frame geometry.

Logs injected-loss counts and ARQ round counts (AMT_SOAK_OUT names a JSON
file to write the record to); zero incomplete streams required for PASS.
Spec completed at scale: the reference's docs/protocol_spec.md:43-63.

Usage: PYTHONPATH=. python tools/soak_lossy.py [per_stream_MB=0.79] [streams_per_session=32]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

T0 = time.time()


def log(m: str) -> None:
    print(f"[lossy +{time.time() - T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def main() -> int:
    per_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 0.79
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    out_path = os.environ.get("AMT_SOAK_OUT")
    snr_db = float(os.environ.get("AMT_SOAK_SNR", "18.0"))

    import jax

    from audio_modem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from audio_modem_tpu import arq, framing
    from audio_modem_tpu.channel import ChannelSpec, apply_channel_np
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.multi_receiver import BatchReceiver

    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    block = 65536
    rng = np.random.default_rng(19)

    def run_session(fec: bool, seed: int) -> dict:
        per_bytes = int(per_mb * 1e6)
        per_bytes -= per_bytes % chunk
        n_chunks = per_bytes // chunk
        srng = np.random.default_rng(seed)
        n_sig = min(8, n)
        files = [srng.bytes(per_bytes) for _ in range(n_sig)]
        mp_payload = chunk + 11
        if fec:
            mp_payload = framing.fec_wire_len(mp_payload)
        n_sym = framing.num_symbols_for_payload(mp_payload, mode)
        est_len = framing.estimate_frame_samples(mp_payload, mode)
        pre_d, post = p.silence_pre_chunk(False), p.silence_post_chunk()
        cadence = est_len + pre_d + post
        log(f"[fec={fec}] {n} x {per_bytes/1e6:.2f} MB ({n_chunks} chunks), "
            f"cadence {cadence}")

        # ---- device TX (soak.py layout: 8 distinct signals tiled) ----
        def payload_for(f: bytes, s: int) -> bytes:
            body = framing.build_data_chunk_payload(f[s * chunk : (s + 1) * chunk], s)
            return framing.wrap_fec(body) if fec else body

        sigs = []
        for i, f in enumerate(files):
            meta_pl = framing.build_metadata_payload(n_chunks, per_bytes, chunk, f"s{i}.bin")
            if fec:
                meta_pl = framing.wrap_fec(meta_pl)
            meta = framing.synthesize_frames(
                [meta_pl], mode, p.silence_pre_chunk(True), post
            )[0]
            pls = np.frombuffer(
                b"".join(payload_for(f, s) for s in range(n_chunks)), np.uint8
            ).reshape(n_chunks, -1)
            frames = framing._synth_frames_core(jnp.asarray(pls), mode, n_sym, pre_d, post)
            sigs.append(jnp.concatenate([jnp.asarray(meta), frames.reshape(-1)]))
        t = max(s.shape[0] for s in sigs)
        t_pad = -(-t // block) * block
        sig8 = jax.block_until_ready(
            jnp.stack([jnp.pad(s, (0, t_pad - s.shape[0])) for s in sigs])
        )
        meta_len = int(sigs[0].shape[0]) - n_chunks * cadence
        log(f"[fec={fec}] device TX done: [{n_sig}, {t_pad}] "
            f"({sig8.nbytes / 1e9:.2f} GB HBM)")

        # ---- per-stream dropout spans (the injected losses) ----
        # 3-6 spans per stream, each 0.5-2 frame cadences, placed past the
        # metadata frame so every stream boots (a killed meta is ARQ-
        # recoverable too, but then EVERY chunk resends — not the topology
        # this soak pins down)
        max_spans = 6
        spans = np.zeros((n, max_spans, 2), np.int64)  # (start, end)
        injected = []
        for i in range(n):
            k = int(rng.integers(3, max_spans + 1))
            hit = set()
            for j in range(k):
                start = int(rng.integers(meta_len, n_chunks * cadence + meta_len))
                length = int(rng.integers(cadence // 2, 2 * cadence))
                spans[i, j] = (start, start + length)
                first = max((start - meta_len) // cadence, 0)
                last = min((start + length - meta_len) // cadence, n_chunks - 1)
                hit.update(range(first, last + 1))
            injected.append(sorted(hit))
        spans_dev = jax.device_put(jnp.asarray(spans, jnp.int32))
        reps = n // n_sig

        @jax.jit
        def channel_block(sig, off, key):
            blk = jnp.tile(jax.lax.dynamic_slice(sig, (0, off), (n_sig, block)), (reps, 1))
            idx = off + jnp.arange(block, dtype=jnp.int32)[None, None, :]
            drop = (
                (idx >= spans_dev[:, :, 0, None]) & (idx < spans_dev[:, :, 1, None])
            ).any(axis=1)
            blk = jnp.where(drop, 0.0, blk)
            noise = jax.random.normal(key, blk.shape, jnp.float32)
            # QPSK frames are peak-normalized; use the whole-signal mean
            # power baked in below rather than per-block power (silence
            # blocks would otherwise get zero noise)
            return blk + noise * sigma

        power = float(jnp.mean(sig8[0, : t - (t_pad - t)] ** 2))
        sigma = float(np.sqrt(power / (10.0 ** (snr_db / 10.0))))

        rx = BatchReceiver(mode, n, fec=fec, scan_bucket=block,
                           device_ingest=True, frames_per_round=8)
        rx.precompile(chunk)
        key0 = jax.random.PRNGKey(seed)
        t0 = time.perf_counter()
        for j in range(t_pad // block):
            rx.process_blocks(channel_block(sig8, jnp.int32(j * block),
                                            jax.random.fold_in(key0, j)))
        rx.flush()
        round1_s = time.perf_counter() - t0
        missing_after_1 = [
            s.assembler.missing_chunks() if s.meta_received else list(range(n_chunks))
            for s in rx.streams
        ]
        log(f"[fec={fec}] round 1 done in {round1_s:.1f}s; "
            f"missing: {sum(map(len, missing_after_1))} chunks "
            f"(injected {sum(map(len, injected))})")

        # ---- ARQ rounds: request back link + host-fed resends ----
        rounds = 1
        resend_counts = []
        max_rounds = 6
        pre_m = p.silence_pre_chunk(True)
        while rounds < max_rounds:
            requests = {}
            for i, s in enumerate(rx.streams):
                missing = (
                    s.assembler.missing_chunks() if s.meta_received
                    else list(range(n_chunks))
                )
                if not missing and s.meta_received:
                    continue
                # request crosses the (noisy) back link with the full
                # decode retry ladder behind it
                req_sig = apply_channel_np(
                    np.asarray(arq.build_request_frame(missing, mode)),
                    ChannelSpec(snr_db=snr_db), seed=rounds * 1000 + i,
                )
                req = arq._decode_request(req_sig, mode)
                if isinstance(req, framing.FrameError) or not req.crc_valid or req.is_ack:
                    if not (isinstance(req, framing.FrameError) or not req.crc_valid):
                        continue  # genuine ACK
                    requests[i] = missing  # lost request: sender resends all missing
                else:
                    requests[i] = list(req.missing)
            if not requests:
                break
            rounds += 1
            resend_counts.append({i: len(m) for i, m in requests.items()})
            items = {}
            for i, missing in requests.items():
                f = files[i % n_sig]
                its = [(payload_for(f, s), pre_d) for s in missing]
                if not rx.streams[i].meta_received:
                    mp = framing.build_metadata_payload(n_chunks, per_bytes, chunk, f"s{i%n_sig}.bin")
                    if fec:
                        mp = framing.wrap_fec(mp)
                    its.insert(0, (mp, pre_m))
                items[i] = its
            flat, slots = [], []
            for i, its in items.items():
                for pl, pre in its:
                    flat.append((pl, pre, post))
                    slots.append(i)
            sigs_r = arq._synthesize_mixed(flat, mode)
            per = {i: [] for i in items}
            for i, sg in zip(slots, sigs_r):
                per[i].append(sg)
            signals = {
                i: apply_channel_np(
                    np.concatenate(s), ChannelSpec(snr_db=snr_db), seed=rounds * 77 + i
                )
                for i, s in per.items()
            }
            length = max(len(s) for s in signals.values())
            length = -(-length // block) * block
            for off in range(0, length, block):
                buf = np.zeros((n, block), np.float32)
                for i, s in signals.items():
                    seg = s[off : off + block]
                    buf[i, : len(seg)] = seg
                rx.process_blocks(buf)
            rx.flush()
            log(f"[fec={fec}] ARQ round {rounds}: resent "
                f"{sum(len(m) for m in requests.values())} chunks to {len(requests)} streams")

        results = rx.results()
        wall = time.perf_counter() - t0
        incomplete = [i for i, r in enumerate(results) if not r["complete"]]
        bitexact = all(
            r["complete"] and r["data"] == files[i % n_sig] for i, r in enumerate(results)
        )
        crc_errors = sum(s.assembler.crc_errors for s in rx.streams)
        rx.cleanup()
        return {
            "fec": fec,
            "streams": n,
            "chunks_per_stream": n_chunks,
            "aggregate_mb": round(n * per_bytes / 1e6, 1),
            "snr_db": snr_db,
            "injected_dropout_chunks": sum(map(len, injected)),
            "missing_after_round1": sum(map(len, missing_after_1)),
            "arq_rounds": rounds,
            "resend_counts_per_round": [
                sum(c.values()) for c in resend_counts
            ],
            "crc_errors": crc_errors,
            "incomplete_streams": incomplete,
            "payload_bitexact": bitexact,
            "wall_s": round(wall, 2),
        }

    sessions = [run_session(fec=False, seed=101), run_session(fec=True, seed=202)]
    record = {
        "config": {
            "mode": "QPSK",
            "sessions": "2 x 32 streams (plain + RS(255,223) FEC)",
            "channel": f"AWGN {snr_db} dB + 3-6 dropout spans/stream "
                       "(0.5-2 frame cadences each), noisy back link",
        },
        "aggregate_mb": round(sum(s["aggregate_mb"] for s in sessions), 1),
        "total_streams": sum(s["streams"] for s in sessions),
        "sessions": sessions,
        "pass": all(
            not s["incomplete_streams"] and s["payload_bitexact"] for s in sessions
        ),
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=2)
    log(json.dumps({k: v for k, v in record.items() if k != "sessions"}))
    for s in sessions:
        log(json.dumps(s))
    log("LOSSY SOAK PASS" if record["pass"] else "LOSSY SOAK FAIL")
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
