"""audio_modem_tpu — a batched OFDM acoustic modem framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
browser modem (playok/audio-modem): OFDM modulation/demodulation, Schmidl-Cox
synchronization, one-tap channel equalization, CRC-framed chunked file
transfer, a streaming multi-stream receiver runtime, channel simulation, and
diagnostics — batched over streams and sharded across accelerator devices.

Layer map (mirrors reference layers, re-designed for batched devices):
  ops/       L1 DSP primitives: JS-LCG, CRC-32, bit packing, constellations,
             matmul-DFT transforms
  configs    L2 OFDM profiles + mode registry (immutable, jit-cache friendly)
  phy        L2 batched modulate / demodulate / channel-estimate
  sync       L2 preamble detection: prefix-sum autocorrelation + xcorr refine
  framing    L3 legacy / metadata / data-chunk payload codecs + frame synth
  channel    fault-injection / test harness: AWGN, multipath, drift, dropout
  runtime/   L4 streaming receiver FSM, ring buffers, chunk assembler
  parallel/  device-level sharding of the stream batch (Mesh + shard_map)
  api        L5 encode()/decode()/stream decode surface
  diag       L3.5 loopback analyzer, sweep/test signals, SNR/BER reports
  cli        L5/L6 command-line application (WAV in/out)
"""

from audio_modem_tpu.configs import OFDM_PROFILES, MODES, OfdmProfile, ModemMode

__version__ = "0.1.0"

__all__ = [
    "OFDM_PROFILES",
    "MODES",
    "OfdmProfile",
    "ModemMode",
    "__version__",
]
