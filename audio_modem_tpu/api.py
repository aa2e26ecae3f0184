"""Public API: encode / decode surface mirroring the reference app layer.

Mirrors the reference's user-visible behavior:
  encode()        routes <=32KB files to one legacy frame, larger files to
                  the chunked protocol (startSend, app.js:124-135)
  encode_legacy() buildTransmitSignal (modem.js:498-555)
  encode_chunked()metadata frame + per-chunk data frames (app.js:201-303)
  decode()        decodeReceivedSignal (modem.js:557-654)
  decode_chunked()full receive of a chunked transmission from one recording
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from audio_modem_tpu import decoder, framing
from audio_modem_tpu.configs import CHUNK_THRESHOLD, ModemMode, get_mode
from audio_modem_tpu.framing import FrameError, ParseResult


def _resolve(mode: str | ModemMode) -> ModemMode:
    return mode if isinstance(mode, ModemMode) else get_mode(mode)


def encode_legacy(
    data: bytes, mode: str | ModemMode = "QPSK", file_name: str = "file", fec: bool = False
) -> np.ndarray:
    """Single-frame TX signal (modem.js:498-555). ``fec=True`` wraps the
    payload in RS(255,223) (extension beyond the reference)."""
    return framing.build_transmit_signal(data, _resolve(mode), file_name, fec=fec)


def encode_chunked(
    data: bytes,
    mode: str | ModemMode = "QPSK",
    file_name: str = "file",
    fec: bool = False,
    batch: int = 16,
) -> Iterator[np.ndarray]:
    """Chunked TX: yields metadata frame, then one frame per chunk
    (playChunkedFrames, app.js:201-303). O(batch * chunk) memory.

    Data frames are synthesized in device-BATCHED groups of up to ``batch``
    equal-length chunks per launch (framing.build_data_chunk_frames): the
    reference builds frames one at a time only because it plays each in
    real time (app.js:235-265); a batched launch amortizes dispatch and
    keeps the TX matmul large. The final short chunk (if any) forms
    its own group, so exactly two TX executables cover any file."""
    m = _resolve(mode)
    chunk_size = m.chunk_size
    total_chunks = -(-len(data) // chunk_size)
    yield framing.build_metadata_frame(total_chunks, len(data), chunk_size, file_name, m, fec=fec)
    seq = 0
    while seq < total_chunks:
        group: list[bytes] = []
        while len(group) < batch and seq + len(group) < total_chunks:
            i = seq + len(group)
            chunk = data[i * chunk_size : (i + 1) * chunk_size]
            if group and len(chunk) != len(group[0]):
                break
            group.append(chunk)
        signals = framing.build_data_chunk_frames(group, seq, m, fec=fec)
        for row in signals:
            yield row
        seq += len(group)


def encode(
    data: bytes, mode: str | ModemMode = "QPSK", file_name: str = "file", fec: bool = False
) -> list[np.ndarray]:
    """Size-routed encode (startSend, app.js:124-135): list of frame signals
    (length 1 for the legacy path)."""
    if len(data) <= CHUNK_THRESHOLD:
        return [encode_legacy(data, mode, file_name, fec=fec)]
    return list(encode_chunked(data, mode, file_name, fec=fec))


def decode(
    signal: np.ndarray, mode: str | ModemMode = "QPSK", track_timing: bool = False
) -> tuple[ParseResult, decoder.DecodeInfo | None]:
    """Full-signal decode of one frame (modem.js:557-654). ``track_timing``
    enables the clock-drift timing tracker for long frames (extension)."""
    return decoder.decode_signal(
        np.asarray(signal, dtype=np.float32), _resolve(mode), track_timing=track_timing
    )


@dataclasses.dataclass
class ChunkedDecodeResult:
    file_name: str
    data: bytes
    total_chunks: int
    received_chunks: int
    missing_chunks: list[int]
    crc_errors: int

    @property
    def complete(self) -> bool:
        return not self.missing_chunks


def decode_chunked(
    signal: np.ndarray, mode: str | ModemMode = "QPSK", fec: bool = False
) -> ChunkedDecodeResult | FrameError:
    """Decode a full chunked transmission from one long recording by scanning
    frame-by-frame (offline analog of the streaming receiver)."""
    from audio_modem_tpu.runtime.receiver import StreamingReceiver

    m = _resolve(mode)
    rx = StreamingReceiver(m, fec=fec)
    signal = np.asarray(signal, dtype=np.float32)
    block = 4096
    for off in range(0, len(signal), block):
        rx.process_audio_block(signal[off : off + block])
    rx.flush()
    asm = rx.assembler
    if asm.total_chunks == 0:
        return FrameError("No metadata frame received")
    return ChunkedDecodeResult(
        file_name=asm.file_name,
        data=asm.assemble(),
        total_chunks=asm.total_chunks,
        received_chunks=asm.received_count,
        missing_chunks=asm.missing_chunks(),
        crc_errors=asm.crc_errors,
    )
