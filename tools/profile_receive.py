"""Device time of the XLA receive programs against a one-pass memory bound.

    python tools/profile_receive.py [--out DIR]

Times, at 64 QPSK streams, the turbo round BatchReceiver dispatches in steady
state (_batch_window_decode_multi_dev with K=32, and its scan-free predicted
form _batch_window_decode_pred_dev) and the full-pipeline batch decode of one
chunk frame per stream (batch_decode_signals). Each is set beside the
time it would take to read its f32 input signal once from device memory, at
the data-sheet bandwidth and at the bandwidth of a copy measured in the same
process. A profiler trace of each program is reduced to device busy time and
the kernels that take it; the trace and the optimized HLO of each program
(which names the source op behind every fusion) are written under --out.

GPU only: a number from another backend is not a device number.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import time
from collections import defaultdict

import numpy as np

HBM_DATASHEET_BPS = 3.35e12  # H100 SXM data sheet
K = 32
N_STREAMS = 64
ITERS = 10


def timed(fn, reps: int = 3) -> float:
    """Best-of-reps seconds per call over ITERS pipelined calls."""
    import jax

    jax.block_until_ready(fn())
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def reduce_trace(trace_dir: str, top: int = 12) -> dict:
    """Device busy time (union of kernel intervals) and per-kernel totals."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    per_kernel: dict[str, float] = defaultdict(float)
    intervals = []
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen.append(f"{plane.name}/{line.name}: {len(evs)} events")
            if not line.name.startswith("Stream"):
                continue
            for e in evs:
                per_kernel[e.name] += e.duration_ns
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    busy = 0.0
    end = -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) if intervals else 0.0
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"lines": lines_seen, "busy_ns": busy, "span_ns": span, "kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_receive", help="trace directory")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from audio_modem_tpu import framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.batch import batch_decode_signals, pad_signals
    from audio_modem_tpu.parallel.multi_receiver import (
        _batch_window_decode_multi_dev,
        _batch_window_decode_pred_dev,
        _classify_round,
    )
    from audio_modem_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profile_receive: needs a GPU, JAX found {dev.platform!r}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}; jax {jax.__version__}; {dev.device_kind}", flush=True)

    # measured copy bandwidth: read + write of a 1 GiB f32 array
    big = jnp.zeros((1 << 28,), jnp.float32)
    copy = jax.jit(lambda x: x + 1.0)
    t_copy = timed(lambda: copy(big))
    copy_bps = 2 * big.nbytes / t_copy
    print(f"copy 1 GiB: {t_copy * 1e3:.3f} ms/call -> {copy_bps / 1e12:.3f} TB/s "
          f"(read + write)", flush=True)
    del big

    mode = MODES["QPSK"]
    p = mode.profile
    sym = p.symbol_len
    chunk = mode.chunk_size
    rng = np.random.default_rng(0)
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    est_len = framing.estimate_frame_samples(chunk + 11, mode)
    cadence = est_len + pre + post
    margin = 4 * sym + p.fft_size + 2048
    w = -(-(K * cadence + margin) // 128) * 128
    pls = np.frombuffer(
        b"".join(framing.build_data_chunk_payload(rng.bytes(chunk), s % K)
                 for s in range(N_STREAMS * K)),
        np.uint8,
    ).reshape(N_STREAMS * K, -1)
    frames = framing._synth_frames_core(jnp.asarray(pls), mode, n_sym, pre, post)
    buf = jax.block_until_ready(
        jnp.pad(frames.reshape(N_STREAMS, K * cadence), ((0, 0), (0, w - K * cadence)))
    )
    zeros = jnp.zeros(N_STREAMS, jnp.int32)
    nv = jnp.full(N_STREAMS, K * cadence, jnp.int32)
    multi_params = jnp.stack([zeros, zeros, nv])
    pred_params = jnp.stack([zeros, zeros + pre, nv])

    def multi():
        return _batch_window_decode_multi_dev(buf, multi_params, mode, n_sym, K, cadence, w)

    def pred():
        return _batch_window_decode_pred_dev(buf, pred_params, mode, n_sym, K, cadence, w)

    for name, fn in (("multi", multi), ("pred", pred)):
        det, _, full, seq = _classify_round(np.asarray(fn()), chunk)
        assert det.all() and full.all() and (seq == np.arange(K)[None]).all(), name

    chunk_frames = list(framing.build_data_chunk_frames(
        [rng.bytes(chunk) for _ in range(N_STREAMS)], 0, mode))
    signals, n_valid = pad_signals(chunk_frames)
    max_syms = (signals.shape[1] - 3 * sym) // sym
    sig_dev, nv_dev = jax.device_put(signals), jax.device_put(n_valid)
    minp = jnp.zeros(N_STREAMS, jnp.int32)

    def single():
        return batch_decode_signals(sig_dev, nv_dev, mode, max_syms, minp)

    assert np.asarray(single()["detected"]).all()

    programs = (
        (f"_batch_window_decode_multi_dev K={K}", multi, buf.nbytes,
         lambda: _batch_window_decode_multi_dev.lower(buf, multi_params, mode, n_sym, K, cadence, w)),
        (f"_batch_window_decode_pred_dev K={K}", pred, buf.nbytes,
         lambda: _batch_window_decode_pred_dev.lower(buf, pred_params, mode, n_sym, K, cadence, w)),
        ("batch_decode_signals", single, sig_dev.nbytes,
         lambda: batch_decode_signals.lower(sig_dev, nv_dev, mode, max_syms, minp)),
    )
    os.makedirs(args.out, exist_ok=True)
    for name, fn, nbytes, lower in programs:
        t = timed(fn)
        bound_ds = nbytes / HBM_DATASHEET_BPS
        bound_copy = nbytes / copy_bps  # copy_bps counts read + write traffic
        print(f"\n{name}: input {nbytes / 1e6:.1f} MB f32, {t * 1e3:.3f} ms/call "
              f"(host clock, {ITERS} pipelined calls, best of 3)", flush=True)
        print(f"  one-pass bound {bound_ds * 1e3:.3f} ms at 3.35 TB/s data sheet -> "
              f"{t / bound_ds:.1f}x the bound; {bound_copy * 1e3:.3f} ms at the measured "
              f"read rate -> {t / bound_copy:.1f}x", flush=True)
        tdir = os.path.join(args.out, name.split()[0].strip("_"))
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, "optimized_hlo.txt"), "w") as f:
            f.write(lower().compile().as_text())
        with jax.profiler.trace(tdir):
            for _ in range(3):
                out = fn()
            jax.block_until_ready(out)
        r = reduce_trace(tdir)
        for line in r["lines"]:
            print(f"  trace line {line}")
        print(f"  trace: device busy {r['busy_ns'] / 3e6:.3f} ms/call of a "
              f"{r['span_ns'] / 3e6:.3f} ms/call span; top kernels (ms/call):", flush=True)
        for kname, ns in r["kernels"]:
            print(f"    {ns / 3e6:9.3f}  {kname[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
