"""Dev probe: where does multi_consume's wall go at volume? Runs a
config-5-shaped soak with cProfile restricted to the consume path. Pinned
to the CPU on purpose: it attributes host time only."""

from __future__ import annotations

import cProfile
import os
import pstats
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_modem_tpu import framing
from audio_modem_tpu.configs import MODES
from audio_modem_tpu.parallel.multi_receiver import BatchReceiver


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_chunks = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    rng = np.random.default_rng(7)
    f = rng.bytes(n_chunks * chunk)
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    meta = framing.build_metadata_frame(n_chunks, len(f), chunk, "p.bin", mode)
    pls = np.frombuffer(
        b"".join(
            framing.build_data_chunk_payload(f[s * chunk : (s + 1) * chunk], s)
            for s in range(n_chunks)
        ),
        np.uint8,
    ).reshape(n_chunks, -1)
    frames = framing._synth_frames_core(jnp.asarray(pls), mode, n_sym, pre, post)
    sig = np.concatenate([meta, np.asarray(frames).reshape(-1)])
    block = 65536
    t_pad = -(-len(sig) // block) * block
    sig = np.pad(sig, (0, t_pad - len(sig)))
    blocks = np.tile(sig[None], (n, 1))
    print(f"{n} streams x {n_chunks} chunks, {len(sig)/1e6:.2f} Ms/stream", file=sys.stderr)

    with tempfile.TemporaryDirectory() as td:
        rx = BatchReceiver(mode, n, persist_dir=td, scan_bucket=block, device_ingest=True)
        # warm compiles outside the profile
        for j in range(t_pad // block):
            rx.process_blocks(jnp.asarray(blocks[:, j * block : (j + 1) * block]))
        rx.flush()
        got = sum(s.assembler.received_count for s in rx.streams)
        print(f"warm pass: {got}/{n*n_chunks} chunks", file=sys.stderr)
        rx.cleanup()

        os.makedirs(td + "/x", exist_ok=True)
        rx = BatchReceiver(mode, n, persist_dir=td + "/x", scan_bucket=block, device_ingest=True)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for j in range(t_pad // block):
            rx.process_blocks(jnp.asarray(blocks[:, j * block : (j + 1) * block]))
        rx.flush()
        prof.disable()
        dt = time.perf_counter() - t0
        got = sum(s.assembler.received_count for s in rx.streams)
        print(f"profiled pass: {got}/{n*n_chunks} chunks, wall {dt:.2f}s", file=sys.stderr)
        print("stage breakdown:", rx.timer.report(), file=sys.stderr)
        rx.cleanup()
        st = pstats.Stats(prof)
        st.sort_stats("cumulative").print_stats(40)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
