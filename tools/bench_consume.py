"""Device-free microbench of BatchReceiver._consume_multi at soak volume.

Host consume cost per chunk can grow with transfer volume. This drives
_consume_multi directly with synthetic packed result
matrices (wire-exact CRC-valid chunk payload rows at the steady-state
cadence) for the full config-5 shape: 64 streams x 3818 chunks, sqlite
assemblers, speculative (spec_gens) rounds — zero device work, pure host
attribution. Prints us/chunk per quarter of the transfer so volume
dependence is visible, plus gc stats. Pinned to the CPU on purpose: it is
a host-only microbenchmark.

Usage: python tools/bench_consume.py [n_streams] [chunks_per_stream]
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_modem_tpu import framing
from audio_modem_tpu.configs import MODES
from audio_modem_tpu.parallel.multi_receiver import BatchReceiver


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_chunks = int(sys.argv[2]) if len(sys.argv) > 2 else 3818
    k = 8
    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    mp_payload = chunk + 11
    est_len = framing.estimate_frame_samples(mp_payload, mode)
    cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
    rng = np.random.default_rng(3)

    with tempfile.TemporaryDirectory() as td:
        rx = BatchReceiver(mode, n, persist_dir=td, scan_bucket=65536, device_ingest=True)
        # steady state: metadata received on every stream
        meta = framing.MetaFrame(
            total_chunks=n_chunks, total_file_size=n_chunks * chunk,
            chunk_size=chunk, file_name="b.bin", crc_valid=True,
        )
        for s in rx.streams:
            s.assembler.handle_metadata(meta)
            s.meta_received = True

        # one synthetic packed round template per K chunk seqs:
        # row = [detected, start_be4, payload bytes..., pad]
        n_bytes = 5 + mp_payload + 32  # header + payload + slack like the runtime
        data = rng.integers(0, 256, (n_chunks, chunk), np.uint8)

        def packed_round(r: int, base: int) -> np.ndarray:
            out = np.zeros((n, k, n_bytes), np.uint8)
            for j in range(k):
                seq = r * k + j
                pl = framing.build_data_chunk_payload(data[seq].tobytes(), seq)
                start = j * cadence  # rel to base
                row = np.frombuffer(pl, np.uint8)
                out[:, j, 0] = 1
                out[:, j, 1] = (start >> 24) & 0xFF
                out[:, j, 2] = (start >> 16) & 0xFF
                out[:, j, 3] = (start >> 8) & 0xFF
                out[:, j, 4] = start & 0xFF
                out[:, j, 5 : 5 + len(row)] = row
            return out

        n_rounds = n_chunks // k
        # pre-build all rounds so the timed loop is ONLY consume
        t_build = time.perf_counter()
        rounds = [packed_round(r, 0) for r in range(n_rounds)]
        print(f"built {n_rounds} rounds in {time.perf_counter()-t_build:.1f}s",
              file=sys.stderr)

        gc0 = gc.get_stats()
        quarters = 4
        per_q = n_rounds // quarters
        w = k * cadence + 4096
        for q in range(quarters):
            t0 = time.perf_counter()
            for r in range(q * per_q, (q + 1) * per_q):
                base = r * k * cadence
                bases = {i: base for i in range(n)}
                lens = np.full(n, w, np.int32)
                for s in rx.streams:
                    s.pred_start = base + k * cadence  # as dispatch-time advance did
                    s.inflight = k
                    s.defer_total = 1 << 60  # defer (ring "hasn't" next round yet)
                gens = {i: rx.streams[i].gen for i in range(n)}
                rx._consume_multi(
                    list(range(n)), bases, lens, rounds[r], est_len, cadence, w,
                    predicted=True, spec_gens=gens,
                )
            dt = time.perf_counter() - t0
            done = rx.streams[0].assembler.received_count
            print(
                f"quarter {q}: {dt:.2f}s = "
                f"{dt / (per_q * k * n) * 1e6:.1f} us/chunk (cum chunks/stream {done})",
                file=sys.stderr,
            )
        gc1 = gc.get_stats()
        print("gc gen collections delta:",
              [(a["collections"] - b["collections"]) for a, b in zip(gc1, gc0)],
              file=sys.stderr)
        got = sum(s.assembler.received_count for s in rx.streams)
        print(f"stored {got}/{n * per_q * quarters * k}", file=sys.stderr)
        rx.cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
