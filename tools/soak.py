"""Config-5 soak on an accelerator: N streams x multi-MB transfers through
the full BatchReceiver runtime, wire-accurate signals, zero lost chunks.

Logs sustained Msamples/s and correctness counts (the reference's 500 MB+ claim,
README_en.md:14, at BASELINE config-5 scale); AMT_SOAK_OUT names a JSON
file to write the record to.

Signals are synthesized ON DEVICE and stay device-resident ([B, L] chunk
frames flattened next to the metadata frame — the exact api.encode_chunked
wire layout, verified against it at small size in tests), so the soak
measures the runtime, not host-to-device ingest. Per-stream distinctness comes from 8
independent datasets tiled x8 across the 64 streams (the CPU soak's
layout, tests/test_multi_receiver.py::_run).

Usage: PYTHONPATH=. python tools/soak.py [per_stream_MB] [n_streams]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

T0 = time.time()


def log(m: str) -> None:
    print(f"[soak +{time.time() - T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def main() -> int:
    per_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 0.82
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    out_path = os.environ.get("AMT_SOAK_OUT")
    # frames per turbo round: every round pays fixed costs (dispatch, pop,
    # consume-round overhead) against ONE packed-result D2H whose BYTES are
    # the decoded payload (irreducible); bigger K amortizes the fixed part.
    fpr = int(os.environ.get("AMT_SOAK_FPR", "8"))

    import jax
    import jax.numpy as jnp

    from audio_modem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from audio_modem_tpu import framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.multi_receiver import BatchReceiver

    mode = MODES["QPSK"]
    p = mode.profile
    per_bytes = int(per_mb * 1e6)
    n_sig = min(8, n)
    rng = np.random.default_rng(83)
    chunk = mode.chunk_size
    # whole chunks only: the tail group would be a second TX executable and
    # a second frame length; the soak's subject is the steady-state runtime
    per_bytes -= per_bytes % chunk
    n_chunks = per_bytes // chunk
    log(
        f"{n} streams x {per_bytes / 1e6:.2f} MB ({n_chunks} chunks) = "
        f"{n * per_bytes / 1e6:.0f} MB aggregate"
    )

    # ---- device-resident TX: one _synth_frames_core launch set per signal
    files = [rng.bytes(per_bytes) for _ in range(n_sig)]
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    sigs = []
    for i, f in enumerate(files):
        meta = framing.build_metadata_frame(n_chunks, per_bytes, chunk, f"s{i}.bin", mode)
        pls = np.frombuffer(
            b"".join(
                framing.build_data_chunk_payload(f[s * chunk : (s + 1) * chunk], s)
                for s in range(n_chunks)
            ),
            np.uint8,
        ).reshape(n_chunks, -1)
        frames = framing._synth_frames_core(jnp.asarray(pls), mode, n_sym, pre, post)
        sigs.append(jnp.concatenate([jnp.asarray(meta), frames.reshape(-1)]))
        if i == 0:
            log(f"signal: {sigs[0].shape[0] / 1e6:.1f} M samples/stream")
    t = max(s.shape[0] for s in sigs)
    block = 65536
    t_pad = -(-t // block) * block
    sig8 = jnp.stack([jnp.pad(s, (0, t_pad - s.shape[0])) for s in sigs])
    sig8 = jax.block_until_ready(sig8)
    log(f"device TX done: [{n_sig}, {t_pad}] resident ({sig8.nbytes / 1e9:.2f} GB)")

    reps = n // n_sig
    slice_blocks = jax.jit(
        lambda s, o: jnp.tile(jax.lax.dynamic_slice(s, (0, o), (n_sig, block)), (reps, 1))
    )

    # warm every executable bucket first (startup scan, K∈{8,4,2,1} multi/
    # pred rounds, tail drain): first-use compiles must not sit inside the
    # timed soak
    log("warmup transfer (compiles)")
    n_warm = min(4 * 8, n_chunks)
    wsig = jnp.concatenate(
        [
            jnp.asarray(
                framing.build_metadata_frame(n_warm, n_warm * chunk, chunk, "w.bin", mode)
            ),
            framing._synth_frames_core(
                jnp.asarray(
                    np.frombuffer(
                        b"".join(
                            framing.build_data_chunk_payload(
                                files[0][s * chunk : (s + 1) * chunk], s
                            )
                            for s in range(n_warm)
                        ),
                        np.uint8,
                    ).reshape(n_warm, -1)
                ),
                mode, n_sym, pre, post,
            ).reshape(-1),
        ]
    )
    wt = -(-wsig.shape[0] // block) * block
    wsig8 = jnp.tile(jnp.pad(wsig, (0, wt - wsig.shape[0]))[None, :], (n_sig, 1))
    warm = BatchReceiver(mode, n, scan_bucket=block, device_ingest=True, frames_per_round=fpr)
    n_prog = warm.precompile(chunk)  # every (k, window) bucket incl. k=4/2
    log(f"precompiled {n_prog} bucket programs")
    for j in range(wt // block):
        warm.process_blocks(slice_blocks(wsig8, jnp.int32(j * block)))
    warm.flush()
    assert all(r["complete"] for r in warm.results()), "warmup transfer failed"
    log("warmup done")

    with tempfile.TemporaryDirectory() as td:
        rx = BatchReceiver(mode, n, persist_dir=td, scan_bucket=block, device_ingest=True, frames_per_round=fpr)
        t0 = time.perf_counter()
        n_blocks = t_pad // block
        for j in range(n_blocks):
            rx.process_blocks(slice_blocks(sig8, jnp.int32(j * block)))
            if j % 200 == 0:
                done = sum(s.assembler.received_count for s in rx.streams)
                log(f"block {j}/{n_blocks}, chunks {done}/{n * n_chunks}")
        rx.flush()
        dt = time.perf_counter() - t0
        results = rx.results()
        total_chunks = sum(s.assembler.received_count for s in rx.streams)
        crc_errors = sum(s.assembler.crc_errors for s in rx.streams)
        incomplete = [i for i, r in enumerate(results) if not r["complete"]]
        data_ok = all(r["data"] == files[i % n_sig] for i, r in enumerate(results))
        stage = rx.timer.report()
        rx.cleanup()

    msps = n * t / dt / 1e6
    record = {
        "config": {
            "streams": n,
            "per_stream_bytes": per_bytes,
            "aggregate_mb": round(n * per_bytes / 1e6, 1),
            "chunks_per_stream": n_chunks,
            "mode": "QPSK",
            "assembler": "sqlite (persist_dir, WAL)",
            "frames_per_round": fpr,
        },
        "wall_s": round(dt, 2),
        "sustained_msps": round(msps, 1),
        "realtime_streams": round(msps * 1e6 / 44100.0),
        "chunks_received": total_chunks,
        "chunks_expected": n * n_chunks,
        "crc_errors": crc_errors,
        "incomplete_streams": incomplete,
        "payload_bitexact": data_ok,
        "stage_breakdown": stage,
        "device": str(jax.devices()[0]),
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=2)
    log(json.dumps({k: v for k, v in record.items() if k != "stage_breakdown"}))
    ok = not incomplete and data_ok and total_chunks == n * n_chunks
    log("SOAK PASS" if ok else "SOAK FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
