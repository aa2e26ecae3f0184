"""GPU smoke test: the modem's main path, end to end, on one card.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --chips 4    # only the stream-sharded path on 4 GPUs

Phases (one process; any failure raises and exits non-zero):

0. device    — JAX must see a GPU; there is no CPU fallback.
1. wire      — every mode's TX frame synthesized on the card against the
               float64 reference model (tests/oracle/jsmodem.py), and the
               committed golden WAVs decoded bit-exact.
2. api       — BASELINE configs 1-4 through api.encode*/api.decode*, plus the
               CLI encode -> decode round trip (in-process).
3. served    — BASELINE config 5's shape: 64 concurrent QPSK streams through
               BatchReceiver(device_ingest=True) into sqlite chunk stores,
               every stream byte-equal to its source; plus an 8-stream
               host-fed run.
4. numerics  — the receive-direction DFT and the preamble cross-correlation
               on the card against float64 NumPy at real widths.

The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# TX waveform contract against the float64 model (tests/test_roundtrip.py).
# The TX matmuls request Precision.HIGHEST, which is full fp32 on the GPU
# (no TF32), so the CPU limit applies unchanged.
TX_MAX_ABS_ERR = 3e-5
# Receive-direction DFT (ops.dft.dot_bf16x3): the hi x hi product is exact
# even in TF32; the two lo-term products run at default precision (TF32 on
# Hopper, ~2^-19 relative to the row). Demap decisions have >= 0.1 margins,
# so 1e-4 of the row's peak is four orders of magnitude inside them.
RX_DFT_MAX_REL_ERR = 1e-4
# sync.sliding_correlate requests Precision.HIGHEST (full fp32); its 0.1 / 0.5
# detection thresholds sit far above this.
XCORR_MAX_REL_ERR = 1e-4

SERVED_MODE = "QPSK"
SERVED_STREAMS = 64
SERVED_DISTINCT = 8  # distinct payloads tiled over the streams (tools/soak.py)
SERVED_CHUNKS = 128  # per stream; BASELINE config 5 sends 500 MB in all
# per stream on four cards: each second there costs four chip-seconds, and
# the sharded path is proven by every stream landing, not by its length
SHARDED_CHUNKS = 32
BLOCK = 65536


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(devices) -> None:
    """Refuse anything but a GPU: the smoke proves the card, not a fallback."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found platform {platform!r}")


# ---------------------------------------------------------------- phase 0


def phase_device(n_chips: int):
    import jax
    import jaxlib

    from audio_modem_tpu.utils.cache import enable_compile_cache

    devices = jax.devices()
    require_gpu(devices)
    if len(devices) < n_chips:
        raise SystemExit(f"chip_smoke: --chips {n_chips} but JAX sees {len(devices)} GPU(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"[device] nvidia-smi: {line}")
    log(f"[device] jax {jax.__version__} jaxlib {jaxlib.__version__}")
    log(f"[device] {len(devices)} x {devices[0].device_kind} ({devices[0].platform})")
    log(f"[device] compile cache: {enable_compile_cache()}")
    return devices


# ---------------------------------------------------------------- phase 1


def _load_oracle():
    """tests/oracle/jsmodem.py, loaded by path: another installed package
    named ``tests`` would shadow the repo's namespace package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jsmodem", ROOT / "tests" / "oracle" / "jsmodem.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_wire() -> None:
    from audio_modem_tpu import api, framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.utils.wav import read_wav

    oracle = _load_oracle()

    sizes = {"QPSK": 1500, "16-QAM": 3000, "64-QAM": 3000, "BPSK-ACOUSTIC": 300,
             "BPSK-REPEAT": 120, "BPSK-NARROW": 48}
    assert set(sizes) == set(MODES), sorted(MODES)
    for name, size in sizes.items():
        data = np.random.default_rng(7).bytes(size)
        ours = framing.build_transmit_signal(data, MODES[name], "t.bin")
        ref = oracle.build_transmit_signal(data, name, "t.bin")
        assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
        err = float(np.abs(ours.astype(np.float64) - ref.astype(np.float64)).max())
        log(f"[wire] {name:<14} TX frame {len(ours):>7} samples, max abs err {err:.3e}")
        assert err < TX_MAX_ABS_ERR, (name, err)

    golden = ROOT / "tests" / "golden"
    manifest = json.loads((golden / "manifest.json").read_text())
    for name, entry in sorted(manifest.items()):
        signal, rate = read_wav(str(golden / entry["wav"]))
        assert rate == 44100 and len(signal) == entry["samples"], name
        result, _ = api.decode(signal, name)
        assert isinstance(result, framing.LegacyFrame), (name, result)
        assert result.crc_valid and result.file_name == entry["file_name"], name
        assert result.data.hex() == entry["payload_hex"], name
        assert hashlib.sha256(result.data).hexdigest() == entry["sha256"], name
        log(f"[wire] golden {entry['wav']} decoded bit-exact")


# ---------------------------------------------------------------- phase 2


def _legacy_roundtrip(label: str, data: bytes, mode: str, spec=None, seed: int = 0) -> None:
    from audio_modem_tpu import api, channel, framing

    frames = api.encode(data, mode, "f.bin")
    assert len(frames) == 1, (label, len(frames))
    sig = frames[0]
    if spec is not None:
        sig = channel.apply_channel_np(sig, spec, seed=seed)
    t0 = time.perf_counter()
    result, _ = api.decode(sig, mode)
    dt = time.perf_counter() - t0
    assert isinstance(result, framing.LegacyFrame), (label, result)
    assert result.crc_valid and result.data == data, label
    log(f"[api] {label}: {len(data)} B, {len(sig)} samples, decode {dt:.2f} s, bytes equal")


def _chunked_roundtrip(label: str, data: bytes, mode: str, spec=None, seed: int = 0) -> None:
    from audio_modem_tpu import api, channel

    sig = np.concatenate(list(api.encode_chunked(data, mode, "f.bin")))
    if spec is not None:
        sig = channel.apply_channel_np(sig, spec, seed=seed)
    t0 = time.perf_counter()
    res = api.decode_chunked(sig, mode)
    dt = time.perf_counter() - t0
    assert not hasattr(res, "error"), (label, res)
    assert res.complete and res.data == data, (label, res.missing_chunks[:8])
    log(f"[api] {label}: {len(data)} B in {res.total_chunks} chunks, {len(sig)} samples, "
        f"decode {dt:.2f} s, bytes equal")


def phase_api() -> None:
    from audio_modem_tpu import cli
    from audio_modem_tpu.channel import ChannelSpec

    rng = np.random.default_rng(5)
    _legacy_roundtrip("config 1 BPSK-NARROW legacy", rng.bytes(1024), "BPSK-NARROW")
    _legacy_roundtrip("config 2 BPSK-REPEAT AWGN 12 dB", rng.bytes(32 * 1024 - 32),
                      "BPSK-REPEAT", ChannelSpec(snr_db=12.0), seed=6)
    _chunked_roundtrip("config 3 QPSK chunked", rng.bytes(1024 * 1024), "QPSK")
    _chunked_roundtrip(
        "config 4 16-QAM multipath", rng.bytes(48 * 1024), "16-QAM",
        ChannelSpec(snr_db=28.0, multipath=((23, 0.25), (61, 0.12)), gain=0.7,
                    dc_offset=0.01),
        seed=2,
    )
    with tempfile.TemporaryDirectory() as td:
        src, wav, out = Path(td, "in.bin"), Path(td, "sig.wav"), Path(td, "out.bin")
        src.write_bytes(rng.bytes(3000))
        assert cli.main(["encode", str(src), str(wav), "--mode", "QPSK"]) == 0
        assert cli.main(["decode", str(wav), "-o", str(out), "--mode", "QPSK"]) == 0
        assert out.read_bytes() == src.read_bytes()
    log("[api] cli encode -> decode: bytes equal")


# ---------------------------------------------------------------- phase 3


def _transfers(n_distinct: int, n_chunks: int, mode, seed: int):
    """n_distinct files of n_chunks chunks -> ([n_distinct, T] f32 PCM padded
    to whole blocks, files), through the user TX entry point."""
    from audio_modem_tpu import api

    rng = np.random.default_rng(seed)
    files = [rng.bytes(n_chunks * mode.chunk_size) for _ in range(n_distinct)]
    sigs = [
        np.concatenate(list(api.encode_chunked(f, mode, f"s{i}.bin", batch=n_chunks)))
        for i, f in enumerate(files)
    ]
    t = -(-max(len(s) for s in sigs) // BLOCK) * BLOCK
    pcm = np.zeros((n_distinct, t), np.float32)
    for i, s in enumerate(sigs):
        pcm[i, : len(s)] = s
    return pcm, files, max(len(s) for s in sigs)


class _CompileCounter:
    """Counts XLA backend compilations while active."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self) -> None:
        import jax

        self.count = 0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, _secs: float, **_kw) -> None:
        if self.active and event == self.EVENT:
            self.count += 1


def _check_streams(results, files, label: str) -> None:
    bad = [
        i for i, r in enumerate(results)
        if not r["complete"] or r["data"] != files[i % len(files)]
    ]
    assert not bad, f"{label}: streams {bad[:8]} incomplete or corrupt"


def run_device_ingest(
    n_streams: int, n_chunks: int, mesh=None, warm: bool = True, label: str = "served"
) -> None:
    """n_streams concurrent transfers through BatchReceiver(device_ingest=True)
    with sqlite chunk stores; every stream must equal its source."""
    import jax
    import jax.numpy as jnp

    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.multi_receiver import BatchReceiver

    mode = MODES[SERVED_MODE]
    n_distinct = min(SERVED_DISTINCT, n_streams)
    reps = n_streams // n_distinct
    pcm, files, sig_len = _transfers(n_distinct, n_chunks, mode, seed=83)
    log(f"[{label}] cut: {n_streams} {SERVED_MODE} streams x {n_chunks} chunks of "
        f"{mode.chunk_size} B ({n_streams * n_chunks * mode.chunk_size / 1e6:.1f} MB, "
        f"{n_streams * sig_len / 1e6:.1f} M samples) instead of BASELINE config 5's "
        f"500 MB; {n_distinct} distinct payloads tiled x{reps}")
    pcm_dev = jax.device_put(pcm)
    slice_blocks = jax.jit(
        lambda s, o: jnp.tile(jax.lax.dynamic_slice(s, (0, o), (n_distinct, BLOCK)), (reps, 1))
    )

    def feed(rx) -> None:
        for j in range(pcm.shape[1] // BLOCK):
            rx.process_blocks(slice_blocks(pcm_dev, jnp.int32(j * BLOCK)))
        rx.flush()

    counter = _CompileCounter()
    t0 = time.perf_counter()
    if warm:
        rx = BatchReceiver(mode, n_streams, scan_bucket=BLOCK, device_ingest=True, mesh=mesh)
        n_prog = rx.precompile(mode.chunk_size)
        feed(rx)
        _check_streams(rx.results(), files, f"{label} warm-up")
        del rx
        log(f"[{label}] warm-up transfer ({n_prog} precompiled programs) "
            f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as td:
        rx = BatchReceiver(
            mode, n_streams, persist_dir=td, scan_bucket=BLOCK, device_ingest=True, mesh=mesh
        )
        log(f"[{label}] device ring {tuple(rx.dring.buf.shape)} f32 "
            f"({rx.dring.buf.nbytes / 1e9:.2f} GB)")
        counter.active = True
        t0 = time.perf_counter()
        feed(rx)
        dt = time.perf_counter() - t0
        counter.active = False
        _check_streams(rx.results(), files, label)
        rx.cleanup()
    log(f"[{label}] every stream complete and byte-equal to its source")
    log(f"[{label}] wall {dt:.3f} s, {n_streams * sig_len / dt / 1e6:.2f} Msamples/s "
        f"sustained, {counter.count} compilation(s) in the timed part")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"[{label}] device 0 peak memory {stats['peak_bytes_in_use'] / 1e9:.2f} GB")


def run_host_fed(n_streams: int, n_chunks: int) -> None:
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.multi_receiver import BatchReceiver

    mode = MODES[SERVED_MODE]
    pcm, files, sig_len = _transfers(n_streams, n_chunks, mode, seed=89)
    rx = BatchReceiver(mode, n_streams, scan_bucket=BLOCK, window_decode=True)
    t0 = time.perf_counter()
    for j in range(pcm.shape[1] // BLOCK):
        rx.process_blocks(pcm[:, j * BLOCK : (j + 1) * BLOCK])
    rx.flush()
    dt = time.perf_counter() - t0
    _check_streams(rx.results(), files, "host-fed")
    log(f"[host-fed] {n_streams} streams x {n_chunks} chunks complete and byte-equal; "
        f"wall {dt:.3f} s (compiles included), {n_streams * sig_len / dt / 1e6:.2f} Msamples/s")


# ---------------------------------------------------------------- phase 4


def _row_rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    return float((np.abs(got - ref) / np.maximum(peak, 1e-30)).max())


def phase_numerics() -> None:
    import jax.numpy as jnp

    from audio_modem_tpu import sync
    from audio_modem_tpu.configs import OFDM_PROFILES
    from audio_modem_tpu.ops.dft import time_to_spec

    rng = np.random.default_rng(3)
    for name, prof in OFDM_PROFILES.items():
        body = rng.standard_normal((64, 46, prof.fft_size)).astype(np.float32)
        re, im = time_to_spec(jnp.asarray(body), prof)
        spec = np.fft.rfft(body.astype(np.float64), axis=-1)[..., prof.active_bins]
        err = max(_row_rel_err(np.asarray(re, np.float64), spec.real),
                  _row_rel_err(np.asarray(im, np.float64), spec.imag))
        log(f"[numerics] time_to_spec {name:<10} [64, 46, {prof.fft_size}] "
            f"max err / row peak {err:.3e} (limit {RX_DFT_MAX_REL_ERR:g})")
        assert err < RX_DFT_MAX_REL_ERR, (name, err)

        x = rng.standard_normal((64, 8192)).astype(np.float32)
        corr = np.asarray(sync.sliding_correlate(jnp.asarray(x), prof), np.float64)
        pre1 = prof.preamble1.astype(np.float64)
        ref = np.stack([np.correlate(row, pre1, mode="valid") for row in x.astype(np.float64)])
        err = _row_rel_err(corr, ref)
        log(f"[numerics] sliding_correlate {name:<10} [64, 8192] "
            f"max err / row peak {err:.3e} (limit {XCORR_MAX_REL_ERR:g})")
        assert err < XCORR_MAX_REL_ERR, (name, err)


# ---------------------------------------------------------------- 4 cards


def phase_sharded_decode(n_chips: int) -> None:
    """batch_decode_signals sharded over the stream axis of n_chips cards
    must give the bits of the same call unsharded on card 0."""
    import jax
    import jax.numpy as jnp

    from audio_modem_tpu import framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.batch import batch_decode_signals, pad_signals
    from audio_modem_tpu.parallel.mesh import batch_sharding, make_mesh

    mode = MODES[SERVED_MODE]
    sym = mode.profile.symbol_len
    rng = np.random.default_rng(17)
    frames = list(framing.build_data_chunk_frames(
        [rng.bytes(mode.chunk_size) for _ in range(SERVED_STREAMS)], 0, mode))
    signals, n_valid = pad_signals(frames, pad_len=len(frames[0]) + 2 * sym)
    max_syms = (signals.shape[1] - 3 * sym) // sym
    decode = jax.jit(lambda s, nv: batch_decode_signals(s, nv, mode, max_syms))

    dev0 = jax.devices()[0]
    ref = decode(jax.device_put(signals, dev0), jax.device_put(n_valid, dev0))
    spec = batch_sharding(make_mesh(n_chips))
    out = decode(jax.device_put(signals, spec), jax.device_put(n_valid, spec))
    assert len(out["bits"].sharding.device_set) == n_chips
    assert np.asarray(ref["detected"]).all() and np.asarray(out["detected"]).all()
    assert np.array_equal(np.asarray(ref["start"]), np.asarray(out["start"]))
    # payload symbols only: the zero-padded tail demodulates exact-zero bins
    # whose sign depends on summation order, and every consumer drops it
    n_bits = framing.num_symbols_for_payload(mode.chunk_size + 11, mode) * mode.bits_per_symbol
    assert np.array_equal(np.asarray(ref["bits"])[:, :n_bits], np.asarray(out["bits"])[:, :n_bits])
    log(f"[sharded] batch_decode_signals over {n_chips} cards == card 0 alone "
        f"({SERVED_STREAMS} streams, {n_bits} payload bits each)")


# ---------------------------------------------------------------- main


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the stream-sharded BatchReceiver and "
                         "sharded decode across four cards")
    args = ap.parse_args(argv)

    devices = phase_device(args.chips)
    t_all = time.perf_counter()
    if args.chips == 1:
        for name, fn in (
            ("wire", phase_wire),
            ("api", phase_api),
            ("served", lambda: run_device_ingest(SERVED_STREAMS, SERVED_CHUNKS)),
            ("host-fed", lambda: run_host_fed(8, 16)),
            ("numerics", phase_numerics),
        ):
            t0 = time.perf_counter()
            fn()
            log(f"[phase] {name} passed in {time.perf_counter() - t0:.1f} s")
    else:
        from audio_modem_tpu.parallel.mesh import make_mesh

        t0 = time.perf_counter()
        run_device_ingest(SERVED_STREAMS, SHARDED_CHUNKS, mesh=make_mesh(args.chips),
                          warm=False, label=f"served x{args.chips}")
        phase_sharded_decode(args.chips)
        log(f"[phase] sharded passed in {time.perf_counter() - t0:.1f} s")
    log(f"[phase] all passed in {time.perf_counter() - t_all:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
