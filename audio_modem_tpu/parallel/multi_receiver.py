"""Multi-stream streaming receiver: N concurrent FSMs, dense batched device
programs (BASELINE config 5: '500MB file over 64 parallel batched streams').

Where runtime.receiver.StreamingReceiver makes one small device call per
stream per state transition, BatchReceiver runs ALL streams through fixed
batched executables every block, SPMD-style:

  1. ingest: batched native EMA DC removal, per-stream ring writes
  2. scan:   one [N, SCAN_BUCKET] detection call; streams not scanning are
             masked out via n_valid = 0
  3. refine: one [N, region] xcorr call, masked the same way
  4. demod:  ready frames grouped by (normalized) frame length, one
             batch_decode_chunk_frames call per group

Host keeps only the per-stream FSM enums/counters and byte-level routing —
a few comparisons per stream per block. Shard the batch axis over a mesh to
span devices (the per-stage arrays are leading-axis sharded).
"""

from __future__ import annotations

from collections import deque
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu import decoder, framing, native, sync
from audio_modem_tpu.configs import ModemMode
from audio_modem_tpu.ops.bits import bits_to_bytes, jnp_bits_to_bytes, jnp_majority_vote, soft_combine
from audio_modem_tpu.parallel import batch
from audio_modem_tpu.parallel.batch import batch_decode_chunk_frames_packed, batch_decode_signals
from audio_modem_tpu.runtime.assembler import AsyncBatchWriter, ChunkAssembler
from audio_modem_tpu.runtime.receiver import PRE_META_MAX_PAYLOAD, STREAM_MIN_ENERGY, RecvState
from audio_modem_tpu.runtime.ring import RingBuffer
from audio_modem_tpu.utils.metrics import StreamStats
from audio_modem_tpu.utils.trace import StageTimer

SCAN_BUCKET = 8192


@partial(jax.jit, static_argnames=("profile",))
def _batch_scan(windows: jnp.ndarray, n_valid: jnp.ndarray, profile):
    return sync.detect_preamble(windows, profile, n_valid, min_energy=STREAM_MIN_ENERGY, stride=sync.COARSE_STRIDE)


@partial(jax.jit, static_argnames=("profile",))
def _batch_refine(regions: jnp.ndarray, coarse_rel: jnp.ndarray, n_valid: jnp.ndarray, profile):
    return jax.vmap(lambda r, c, n: sync.refine_xcorr(r, c, profile, n))(regions, coarse_rel, n_valid)


@partial(jax.jit, static_argnames=("length",))
def _ring_gather(buf: jnp.ndarray, rows: jnp.ndarray, rel_starts: jnp.ndarray, length: int):
    sel = jnp.take(buf, rows, axis=0)
    return jax.vmap(lambda r, s: jax.lax.dynamic_slice(r, (s,), (length,)))(sel, rel_starts)


@partial(jax.jit, donate_argnums=(0,))
def _ring_append(buf: jnp.ndarray, blocks: jnp.ndarray) -> jnp.ndarray:
    """Shift-ring write: keep the LAST capacity samples of every stream.

    One concatenate per block (device-memory copy, trivial at device
    bandwidth); buf[:, 0] always sits at global offset total_written - cap,
    so window reads are plain per-row dynamic slices — no modulo gathers."""
    l = blocks.shape[1]
    return jnp.concatenate([buf[:, l:], blocks.astype(jnp.float32)], axis=1)


def _pack_round(detected: jnp.ndarray, start: jnp.ndarray, by: jnp.ndarray) -> jnp.ndarray:
    """Pack one turbo round's results into a SINGLE uint8 matrix
    [n, 5 + n_bytes]: col 0 = detected flag, cols 1-4 = start (big-endian),
    rest = decoded bytes. One array -> ONE blocking D2H per round instead
    of three (detected/start/bytes), each a host synchronization."""
    s = start.astype(jnp.int32)
    head = jnp.stack(
        [
            detected.astype(jnp.uint8),
            (s >> 24).astype(jnp.uint8),
            (s >> 16).astype(jnp.uint8),
            (s >> 8).astype(jnp.uint8),
            (s & 0xFF).astype(jnp.uint8),
        ],
        axis=1,
    )
    return jnp.concatenate([head, by], axis=1)


def _unpack_round(packed: np.ndarray):
    detected = packed[..., 0].astype(bool)
    starts = (
        (packed[..., 1].astype(np.int64) << 24)
        | (packed[..., 2].astype(np.int64) << 16)
        | (packed[..., 3].astype(np.int64) << 8)
        | packed[..., 4].astype(np.int64)
    )
    return detected, starts, packed[..., 5:]


def _classify_round(packed: np.ndarray, chunk_size: int):
    """Vectorized steady-state classification of a whole K-slot round.

    One numpy pass over the [n, K, 5 + n_bytes] packed matrix marks the
    slots that are CRC-valid data frames of exactly ``chunk_size`` payload
    bytes — the common case of every steady-state slot. _consume_multi's
    per-slot work for those slots collapses to scalar reads + a fast-path
    assembler store; before this, each slot built a bytes copy, a parse, a
    DataFrame, and a full _route_result per slot.

    Returns (detected [n,K], starts [n,K], full [n,K], seqs [n,K]) or None
    when the packed rows cannot hold a full chunk (callers then take the
    general per-slot path for everything).
    """
    detected, starts, by = _unpack_round(packed)
    crc_off = 7 + chunk_size
    if by.shape[-1] < crc_off + 4:
        return None
    dlen = (by[:, :, 5].astype(np.int32) << 8) | by[:, :, 6]
    cand = detected & (by[:, :, 0] == framing.FRAME_DATA) & (dlen == chunk_size)
    seqs = (
        (by[:, :, 1].astype(np.int64) << 24)
        | (by[:, :, 2].astype(np.int64) << 16)
        | (by[:, :, 3].astype(np.int64) << 8)
        | by[:, :, 4].astype(np.int64)
    )
    expected = (
        (by[:, :, crc_off].astype(np.int64) << 24)
        | (by[:, :, crc_off + 1].astype(np.int64) << 16)
        | (by[:, :, crc_off + 2].astype(np.int64) << 8)
        | by[:, :, crc_off + 3].astype(np.int64)
    )
    full = np.zeros(cand.shape, bool)
    # zlib.crc32 straight off the (contiguous) row views — C speed, no copies
    import zlib

    for i, k in zip(*np.nonzero(cand)):
        full[i, k] = zlib.crc32(by[i, k, :crc_off]) == expected[i, k]
    return detected, starts, full, seqs


@partial(jax.jit, static_argnames=("mode", "max_syms", "w"))
def _batch_window_decode_dev(
    buf: jnp.ndarray,
    params: jnp.ndarray,  # [3, n] int32: start_rel, min_pos, n_valid
    mode: ModemMode,
    max_syms: int,
    w: int,
):
    """Device-ring turbo dispatch: slice each stream's window out of the
    resident ring (vmapped dynamic slice — the samples NEVER cross the
    host boundary), then the fused full pipeline + vote + pack. Host
    traffic per round: ONE packed [3, n] scalar upload, ONE packed result
    matrix down."""
    start_rel, min_pos, n_valid = params[0], params[1], params[2]
    windows = jax.vmap(lambda row, s: jax.lax.dynamic_slice(row, (s,), (w,)))(buf, start_rel)
    out = batch_decode_signals(windows, n_valid, mode, max_syms, min_pos=min_pos)
    b = out["bits"]
    if mode.repetition > 1:
        b = jnp_majority_vote(b, mode.repetition)
    return _pack_round(out["detected"], out["start"], jnp_bits_to_bytes(b))


class DeviceRing:
    """Device-resident lockstep ring for N streams: [n, capacity] float32 in
    device memory, shift-write semantics (see _ring_append). The
    multi-stream analog of RingBuffer whose SAMPLES stay on device: scan
    windows are sliced there instead of re-uploaded every round, which
    halves ingest bandwidth.

    ``mesh``: optional jax.sharding.Mesh — the ring (and every block written
    into it) is sharded over the stream axis, so the turbo decode dispatches
    partition across devices with zero cross-device sample traffic (streams
    are independent; only the packed per-stream result rows are gathered)."""

    def __init__(self, n: int, capacity: int, mesh=None):
        self.capacity = -(-capacity // 128) * 128
        self.sharding = None
        if mesh is not None:
            from audio_modem_tpu.parallel.mesh import batch_sharding

            if n % mesh.size != 0:
                raise ValueError(
                    f"DeviceRing: n_streams={n} not divisible by mesh size {mesh.size}"
                )
            self.sharding = batch_sharding(mesh)
        self.buf = jnp.zeros((n, self.capacity), jnp.float32, device=self.sharding)
        self.total_written = 0

    def write(self, blocks) -> None:
        l = int(np.shape(blocks)[1])
        if l > self.capacity:
            blocks = blocks[:, -self.capacity :]
        blocks = jnp.asarray(blocks)
        if self.sharding is not None:
            # place the incoming block batch on the mesh ONCE here (row i of
            # the block goes to the device holding ring row i), so the donated
            # shift-append never reshards
            blocks = jax.device_put(blocks, self.sharding)
        self.buf = _ring_append(self.buf, blocks)
        self.total_written += l

    def rel(self, global_start: int) -> int:
        return global_start - (self.total_written - self.capacity)

    def get_range(self, row: int, global_start: int, length: int) -> np.ndarray | None:
        """Host fetch for the staged fallback paths (rare: parse-failure
        retries, flush tails). One D2H per call."""
        r = self.rel(global_start)
        if r < 0 or global_start + length > self.total_written:
            return None
        return np.asarray(
            jax.lax.dynamic_slice(self.buf[row], (jnp.int32(r),), (length,))
        )

    def gather_ranges(self, rows: "list[int]", global_starts: "list[int]", length: int) -> np.ndarray:
        """Batched host fetch: equal-length ranges for several streams in
        ONE dispatch + D2H (the staged refine/demod stages would otherwise
        pay a dispatch and a host sync per stream). Callers must pre-check
        validity via rel()/total_written."""
        rels = jnp.asarray([self.rel(s) for s in global_starts], jnp.int32)
        return np.asarray(
            _ring_gather(self.buf, jnp.asarray(rows, jnp.int32), rels, length)
        )


class _DeviceRingView:
    """Per-stream RingBuffer-API adapter over a shared DeviceRing row, so
    the staged FSM stages (refine/demod/flush) work unchanged in
    device-ingest mode."""

    def __init__(self, ring: DeviceRing, row: int):
        self._ring = ring
        self._row = row

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    @property
    def total_written(self) -> int:
        return self._ring.total_written

    def get_range(self, global_start: int, length: int) -> np.ndarray | None:
        return self._ring.get_range(self._row, global_start, length)

    def available_from(self, global_start: int) -> int:
        return self._ring.total_written - global_start

    def write(self, samples) -> None:  # writes go through the shared ring
        raise NotImplementedError("device-ingest streams share the DeviceRing")


def _multi_decode_core(
    windows: jnp.ndarray,
    n_valid: jnp.ndarray,
    min_pos: jnp.ndarray,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    pred0: jnp.ndarray | None = None,
):
    """Detect + demod up to ``k_frames`` successive frames of KNOWN symbol
    count and cadence per stream in ONE device program.

    In steady state a chunked sender emits equal-length data frames on an
    exact sample cadence, so after the metadata frame the receiver knows
    every frame's symbol count AND spacing. Every turbo round pays a
    dispatch and one blocking result fetch — decoding K frames per round
    divides that fixed cost by K.

    Slot 0 runs the FULL pipeline (scan + refine + demod). Slots 1..K-1
    are CADENCE-PREDICTED: each refines around
    prev_start + cadence (xcorr, ±3·CP radius — clock drift moves the true
    start ~6 samples/frame at 200 ppm) and demodulates there, skipping the
    O(window) detection scan entirely; a K-slot round costs ONE scan plus K
    refine+demods. The HOST validates each slot in order and stops consuming
    at the first undetected/short/failed slot, and only a slot-0 miss counts
    as 'window clean' (a failed PREDICTION says nothing about frames at
    other positions), so prediction failures can never lose a frame."""
    p = mode.profile
    sym = p.symbol_len

    def pack(out):
        b = out["bits"]
        if mode.repetition > 1:
            b = jnp_majority_vote(b, mode.repetition)
        return _pack_round(out["detected"], out["start"], jnp_bits_to_bytes(b))

    if pred0 is None:
        out0 = batch_decode_signals(windows, n_valid, mode, n_sym_frame, min_pos=min_pos)
        packed0 = pack(out0)
        if k_frames == 1:
            return packed0[:, None]
        carry0 = (out0["start"].astype(jnp.int32), out0["detected"])
        n_pred = k_frames - 1
    else:
        # FULLY predicted round: the host knows slot 0's position from the
        # previous round's cadence bookkeeping, so even the O(window)
        # Schmidl-Cox scan is skipped — a steady-state round is K xcorr
        # refine + demods and nothing else. A slot-0 prediction miss is
        # reported, never absorbed: the host clears the prediction and the
        # next round runs the full scan from its last consumed position.
        carry0 = (
            (pred0 - cadence).astype(jnp.int32),
            jnp.ones(windows.shape[0], jnp.bool_),
        )
        n_pred = k_frames

    ext = batch.preprocess_extend(windows, n_valid, mode, n_sym_frame)

    # lax.scan (not a Python loop): the predicted-slot body is traced and
    # compiled ONCE instead of k_frames-1 times — an unrolled program
    # multiplies compile time for zero runtime benefit (the slots are serial
    # on the prev_start carry either way).
    def step(carry, _):
        prev_start, prev_ok = carry
        coarse = jnp.clip(prev_start + cadence, 0, windows.shape[1] - 1).astype(jnp.int32)
        out = batch.batch_decode_predicted(ext, coarse, n_valid, mode, n_sym_frame)
        ok = out["detected"] & prev_ok
        packed = pack({"detected": ok, "start": out["start"], "bits": out["bits"]})
        return (out["start"].astype(jnp.int32), ok), packed

    _, rest = jax.lax.scan(step, carry0, None, length=n_pred)
    rest = jnp.moveaxis(rest, 0, 1)
    if pred0 is None:
        rest = jnp.concatenate([packed0[:, None], rest], axis=1)
    return rest  # [n, K, 5 + n_bytes]


@partial(jax.jit, static_argnames=("mode", "n_sym_frame", "k_frames", "cadence", "w"))
def _batch_window_decode_multi_dev(
    buf: jnp.ndarray,
    params: jnp.ndarray,  # [3, n] int32: start_rel, min_pos, n_valid
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    w: int,
):
    """Per-round host scalars arrive as ONE packed [3, n] int32 upload
    instead of three separate transfers."""
    start_rel, min_pos, n_valid = params[0], params[1], params[2]
    windows = jax.vmap(lambda row, s: jax.lax.dynamic_slice(row, (s,), (w,)))(buf, start_rel)
    return _multi_decode_core(windows, n_valid, min_pos, mode, n_sym_frame, k_frames, cadence)


@partial(jax.jit, static_argnames=("mode", "n_sym_frame", "k_frames", "cadence", "w"))
def _batch_window_decode_pred_dev(
    buf: jnp.ndarray,
    params: jnp.ndarray,  # [3, n] int32: start_rel, pred0, n_valid
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    w: int,
):
    """Scan-free steady-state round: every slot (including slot 0) decodes at
    a cadence-predicted position (window-relative ``pred0``). Host scalars
    arrive as ONE packed [3, n] int32 upload (see _batch_window_decode_multi_dev)."""
    start_rel, pred0, n_valid = params[0], params[1], params[2]
    windows = jax.vmap(lambda row, s: jax.lax.dynamic_slice(row, (s,), (w,)))(buf, start_rel)
    return _multi_decode_core(
        windows, n_valid, None, mode, n_sym_frame, k_frames, cadence, pred0=pred0
    )


@partial(jax.jit, static_argnames=("mode", "n_sym_frame", "k_frames", "cadence"))
def _batch_window_decode_multi(
    windows: jnp.ndarray,
    min_pos: jnp.ndarray,
    n_valid: jnp.ndarray,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
):
    return _multi_decode_core(windows, n_valid, min_pos, mode, n_sym_frame, k_frames, cadence)


@partial(jax.jit, static_argnames=("mode", "max_syms"))
def _batch_window_decode(windows: jnp.ndarray, n_valid: jnp.ndarray, mode: ModemMode, max_syms: int):
    """The turbo path's ONE dispatch: full pipeline (preprocess + detect +
    refine + CE + demod) over every
    scanning stream's window, with majority vote + byte packing fused on as
    an epilogue; results come back as ONE packed matrix (see _pack_round)."""
    out = batch_decode_signals(windows, n_valid, mode, max_syms)
    b = out["bits"]
    if mode.repetition > 1:
        b = jnp_majority_vote(b, mode.repetition)
    return _pack_round(out["detected"], out["start"], jnp_bits_to_bytes(b))


class _Stream:
    __slots__ = (
        "ring", "assembler", "stats", "state", "meta_received",
        "scan_pos", "preamble_pos", "expected_frame_end", "defer_total",
        "pred_start", "gen", "inflight",
    )

    def __init__(self, ring_capacity: int, persist_path: str | None, resume: bool,
                 writer=None):
        self.ring = RingBuffer(ring_capacity)
        self.assembler = ChunkAssembler(persist_path, resume, writer=writer)
        self.stats = StreamStats()
        self.state = RecvState.IDLE
        self.meta_received = False
        self.scan_pos = 0
        self.preamble_pos = -1
        self.expected_frame_end = -1
        # turbo deferral: a detected frame that will fit a FUTURE window
        # waits for samples instead of dropping to the staged machine;
        # re-scan once total_written exceeds this
        self.defer_total = -1
        # cadence prediction of the NEXT frame's absolute start (-1 unknown):
        # when every active stream carries one, the round skips even the
        # slot-0 detection scan (_batch_window_decode_pred_dev)
        self.pred_start = -1
        # speculation generation: bumped whenever the stream's truth state
        # deviates from a speculatively dispatched round's assumption, so
        # in-flight pipelined results for this stream are discarded on fetch
        self.gen = 0
        # frame slots dispatched speculatively but not yet consumed: the
        # remaining-chunks clamp must count these, or the final rounds of a
        # transfer overshoot (assembler counts lag the dispatch frontier by
        # the whole pipeline), forcing an end-of-input rollback that dumps
        # a K-round of frames per stream onto the slow staged machine
        self.inflight = 0


class BatchReceiver:
    """N independent streams decoded with shared batched device programs."""

    def __init__(
        self,
        mode: ModemMode,
        n_streams: int,
        persist_dir: str | None = None,
        resume: bool = False,
        dc_alpha: float = 0.999,
        fec: bool = False,
        scan_bucket: int = SCAN_BUCKET,
        window_decode: bool = False,
        device_ingest: bool = False,
        frames_per_round: int = 8,
        pipeline_depth: int = 8,
        mesh=None,
    ):
        self.mode = mode
        self.fec = fec
        self.n = n_streams
        # Multi-device: shard the stream axis over a mesh. The DeviceRing
        # and every turbo decode dispatch partition along that axis (GSPMD;
        # each device owns n/mesh.size streams end-to-end), like the raw
        # batch decodes do. Implies device_ingest — host-fed windows would
        # re-gather samples per round.
        self.mesh = mesh
        if mesh is not None:
            device_ingest = True
        # Device-resident ingest: blocks (host numpy or already-device jnp)
        # append to ONE shared [n, cap] device ring; turbo windows are
        # sliced on device, so per decode round only scalars go up and
        # decoded bytes come down. Without it, the staged/turbo paths
        # re-upload sample windows every round.
        # Implies window_decode; streaming host EMA DC removal is skipped —
        # the decode window's own preprocess (mean-subtract + peak norm,
        # sync.preprocess) subsumes it.
        self.device_ingest = bool(device_ingest)
        window_decode = window_decode or self.device_ingest
        # turbo steady state: frames decoded per dispatch round (each round
        # pays a dispatch and a blocking result fetch, so K frames per
        # round divides that fixed cost by K)
        self.frames_per_round = max(int(frames_per_round), 1)
        # Speculative fetch pipeline (device-ingest steady state): a fully
        # cadence-predicted round's SCHEDULING needs no decode results — the
        # next round's slot-0 position is pred_start + K*cadence either way.
        # So predicted rounds are dispatched with an async D2H copy and
        # queued; the blocking fetch happens up to pipeline_depth rounds
        # later, by which point the copy has completed in the background
        # and np.asarray reads the host-side copy for free. Consumption validates each round against its speculated
        # positions and rolls the stream back (per-stream generation
        # counter) on any deviation, so prediction misses still never lose
        # a frame. 0 disables (every round fetches synchronously).
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self._pending: "deque" = deque()
        # Turbo path: instead of staged scan -> refine -> demod dispatches
        # (3+ per frame), run the FULL fused pipeline over each scanning
        # stream's window — one dispatch yields detection, refined start,
        # and decoded bytes together. Frames that don't fit the window or
        # fail to parse fall back to the staged machine (and its full retry
        # ladder). One dispatch per frame round instead of three.
        self.window_decode = bool(window_decode)
        # Scan-call granularity: each _scan_all dispatch covers up to
        # (scan_bucket - fft) positions per stream. Larger buckets amortize
        # the per-dispatch cost when the caller feeds big blocks; the
        # default matches the 4096-sample real-time block cadence.
        self.scan_bucket = int(scan_bucket)
        p = mode.profile
        max_payload = max(mode.chunk_size, 4096) + 16
        if fec:
            max_payload = framing.fec_wire_len(max_payload)
        max_frame = framing.estimate_frame_samples(max_payload, mode)
        # the ring must hold a whole K-frame turbo round plus scan margin
        cap = max_frame * max(3, self.frames_per_round + 1) + max(8192, self.scan_bucket)
        self._max_frame = max_frame
        if device_ingest and self.pipeline_depth > 0:
            # rollback safety: a deviation is discovered only when its
            # speculative round is consumed, up to pipeline_depth K-rounds
            # after dispatch — the staged retry ladder then re-reads that
            # frame's samples from the ring, so the ring must keep the
            # whole in-flight span resident (process_blocks additionally
            # force-drains the oldest round whenever its window base nears
            # eviction, so ANY capacity stays correct; this sizing just
            # lets the pipeline actually reach its configured depth)
            cap += self.pipeline_depth * self.frames_per_round * max_frame
        # one shared background sqlite landing thread for every stream's
        # assembler: batch executemany+commit leaves the consume critical
        # path (sqlite releases the GIL during disk IO).
        self._writer = AsyncBatchWriter() if persist_dir else None
        self.streams = [
            _Stream(
                cap if not self.device_ingest else 0,
                f"{persist_dir}/stream{i}.db" if persist_dir else None,
                resume,
                writer=self._writer,
            )
            for i in range(n_streams)
        ]
        if self.device_ingest:
            self.dring = DeviceRing(n_streams, cap, mesh=self.mesh)
            for i, s in enumerate(self.streams):
                s.ring = _DeviceRingView(self.dring, i)
        self.dc_alpha = dc_alpha
        self.dc_states = np.zeros(n_streams, dtype=np.float64)
        # per-stage wall-clock accounting (dispatch vs blocking fetch vs host
        # consume) — read via .timer.report() after a run
        self.timer = StageTimer()
        self._half = p.fft_size // 2
        plen = p.symbol_len
        radius = 3 * p.cp_len
        self._region_len = 2 * radius + plen
        self._refine_pad = self._region_len + plen
        self._win_max_syms = max((self.scan_bucket - 3 * plen) // plen, 1)
        # window margin kept ahead of a predicted slot-0 (refinement radius
        # + symbol context); must stay below _multi_params' window margin
        self._pred_pad = 4 * plen + 1024

    # ---- ingest ----

    def process_blocks(self, blocks) -> None:
        """blocks: [n_streams, block_len] float32 — one audio block per
        stream, all streams in lockstep (pad with zeros for silent ones).
        In device-ingest mode, blocks may already be a device (jnp) array —
        the zero-copy path."""
        assert np.shape(blocks)[0] == self.n
        if self.device_ingest:
            self.dring.write(blocks)
        else:
            cleaned = native.ema_dc_removal_batch(
                np.asarray(blocks), self.dc_alpha, self.dc_states
            )
            for s, row in zip(self.streams, cleaned):
                s.ring.write(row)
        if self._pending:
            # rollback safety: settle any in-flight speculative round whose
            # window base is close to shifting out of the device ring —
            # after that, a late-discovered deviation could no longer
            # re-read its frame for the staged retry ladder
            self._drain_pending()
        # iterate state steps until no stream progresses (frames can
        # complete several states within one block)
        for _ in range(8):
            if not self._step_all():
                break

    def _step_all(self) -> bool:
        if self.window_decode:
            progressed = self._window_decode_all()
        else:
            progressed = self._scan_all()
        progressed |= self._refine_all()
        progressed |= self._demod_ready()
        return progressed

    # ---- turbo: fused window decode (scan+refine+demod in one dispatch) ----

    def _multi_params(self, active: "list[int]", w_cap: int) -> "tuple[int, int, int, int, int] | None":
        """(n_sym_frame, est_len, cadence, k, w) when every active stream
        expects the SAME data-frame shape (post-metadata steady state) — the
        precondition for the K-frames-per-dispatch program.

        k is the number of frame slots this round: the configured
        frames_per_round, clamped by the fewest chunks any active stream
        still needs (slots past the transfer's end would each pay a full
        window scan for nothing) and by how many frame cadences fit the
        window budget, then bucketed to a power of two so at most
        log2(frames_per_round) distinct programs ever compile. w is the
        turbo window sized to HOLD k frames — with the default scan-bucket
        window only ~1.5 frames fit, so K-slot rounds were wasting most of
        their slots."""
        if self.frames_per_round <= 1:
            return None
        css = set()
        remaining = 1 << 30
        for i in active:
            s = self.streams[i]
            if not s.meta_received or not s.assembler.chunk_size:
                return None
            css.add(s.assembler.chunk_size)
            remaining = min(
                remaining,
                max(
                    s.assembler.total_chunks
                    - s.assembler.received_count
                    - s.inflight,
                    1,
                ),
            )
        if len(css) != 1:
            return None
        mp_payload = css.pop() + 11
        if self.fec:
            mp_payload = framing.fec_wire_len(mp_payload)
        p = self.mode.profile
        est_len = framing.estimate_frame_samples(mp_payload, self.mode)
        cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
        margin = 4 * p.symbol_len + 2 * self._half + 2048
        k = min(self.frames_per_round, remaining, max((w_cap - margin) // cadence, 1))
        if k <= 1:
            return None
        k = 1 << (k.bit_length() - 1)  # power-of-two program buckets
        w = -(-(k * cadence + margin) // 128) * 128
        return (
            framing.num_symbols_for_payload(mp_payload, self.mode),
            est_len,
            cadence,
            k,
            min(w, w_cap),
        )

    def precompile(self, chunk_size: int | None = None) -> int:
        """AOT-compile every decode program this receiver can dispatch for a
        transfer with the given steady-state chunk size (default: the mode's
        native chunk size), and return how many programs were built.

        The K-frames-per-round machinery buckets its programs by
        (k, window): k is a power of two ≤ frames_per_round, clamped late in
        a transfer by the chunks remaining (k_next), so a long run
        eventually dispatches k = 4, 2 rounds that a short warmup transfer
        never exercises; a cold bucket mid-run stalls the pipeline for a
        whole compile. Production receivers should call this once before
        going live."""
        cs = int(chunk_size) if chunk_size is not None else self.mode.chunk_size
        mp_payload = cs + 11
        if self.fec:
            mp_payload = framing.fec_wire_len(mp_payload)
        p = self.mode.profile
        est_len = framing.estimate_frame_samples(mp_payload, self.mode)
        cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
        margin = 4 * p.symbol_len + 2 * self._half + 2048
        n_sym_frame = framing.num_symbols_for_payload(mp_payload, self.mode)
        w_cap = self.dring.capacity if self.device_ingest else self.scan_bucket
        k_max = min(self.frames_per_round, max((w_cap - margin) // cadence, 1))
        ones = jnp.ones(self.n, jnp.int32)
        zeros = jnp.zeros(self.n, jnp.int32)
        n_built = 0
        k = 1 << (k_max.bit_length() - 1) if k_max > 1 else 0
        while k >= 2:
            w = min(-(-(k * cadence + margin) // 128) * 128, w_cap)
            if self.device_ingest:
                jax.block_until_ready(_batch_window_decode_multi_dev(
                    self.dring.buf, jnp.stack([zeros, zeros, ones * w]),
                    self.mode, n_sym_frame, k, cadence, w,
                ))
                jax.block_until_ready(_batch_window_decode_pred_dev(
                    self.dring.buf,
                    jnp.stack([zeros, zeros + margin // 2, ones * w]),
                    self.mode, n_sym_frame, k, cadence, w,
                ))
            else:
                # host-fed dispatches are ALWAYS (n, scan_bucket) wide
                # (_window_decode_all keeps windows at scan_bucket and
                # discards _multi_params' w), so trace that exact shape —
                # a (n, w) trace here would miss the jit cache at first use
                # and re-pay the compile this exists to avoid
                win = jnp.zeros((self.n, self.scan_bucket), jnp.float32)
                jax.block_until_ready(_batch_window_decode_multi(
                    win, zeros, ones * self.scan_bucket, self.mode,
                    n_sym_frame, k, cadence,
                ))
            n_built += 2 if self.device_ingest else 1
            k //= 2
        # the startup / k=1 / non-uniform-shape fallback program
        if self.device_ingest:
            jax.block_until_ready(_batch_window_decode_dev(
                self.dring.buf,
                jnp.stack([zeros, zeros, ones * self.scan_bucket]),
                self.mode, self._win_max_syms, self.scan_bucket,
            ))
        else:
            jax.block_until_ready(_batch_window_decode(
                jnp.zeros((self.n, self.scan_bucket), jnp.float32),
                ones * self.scan_bucket, self.mode, self._win_max_syms,
            ))
        return n_built + 1

    def _consume_multi(
        self, active, bases, lens, packed, est_len: int, cadence: int, w: int,
        predicted: bool = False, spec_gens: "dict[int, int] | None" = None,
    ) -> bool:
        """Route up to K frame slots per stream, in order, stopping at the
        first undetected / deferred / short / failed slot (whose true end
        the host then knows, bounding any device-side advance overshoot).

        ``predicted``: the round was fully cadence-predicted (slot 0 had no
        detection scan) — a slot-0 miss then says nothing about the window's
        content, so coverage must NOT advance; the prediction is cleared and
        the immediate rerun performs the full scan.

        Returns whether another round could make progress NOW: a stream
        whose last slot came back undetected (window drained) or deferred
        (waiting for samples) contributes nothing until more samples arrive,
        so a round of all-drained streams returns False — otherwise every
        ingest block paid one or two extra no-op rounds.

        ``spec_gens``: the round was dispatched SPECULATIVELY (fetch
        pipeline): per-stream generation counters captured at dispatch.
        Streams whose gen moved since (an earlier round deviated and rolled
        them back) are skipped — their results describe positions the truth
        state abandoned. On full success the stream's speculated cursors
        (pred_start/defer_total, already advanced past LATER in-flight
        rounds at dispatch time) are preserved; on any deviation the gen is
        bumped (discarding the stream's later in-flight rounds) and the
        truth-state updates below apply as usual."""
        rerun = False
        spec = spec_gens is not None
        # vectorized pre-pass: unpack + classify EVERY slot in one numpy
        # sweep (magic/seq/dlen fields, C-speed CRC over contiguous row
        # views) so the per-slot Python below reads precomputed scalars for
        # the steady-state common case instead of building bytes + parse +
        # DataFrame per slot.
        with self.timer.stage("consume_classify"):  # sub-stage of multi_consume
            det_all, start_all, by_all = _unpack_round(packed)
            full_all = seq_all = None
            fast_ok = None
            cs0 = self.streams[active[0]].assembler.chunk_size if active else 0
            if not self.fec and cs0:
                cls = _classify_round(packed, cs0)
                if cls is not None:
                    _, _, full_all, seq_all = cls
                    # Whole-round eligibility, O(streams) numpy: a stream
                    # whose EVERY slot is a CRC-valid full
                    # chunk with its estimated end inside the window takes
                    # none of the per-slot break branches below — its whole
                    # round collapses to one batch store + one cursor update.
                    ia = np.asarray(active, np.intp)
                    lens_a = np.asarray([int(lens[i]) for i in active])
                    fast_ok = (
                        full_all[ia].all(axis=1)
                        & (start_all[ia] + est_len <= lens_a[:, None]).all(axis=1)
                    )
        for j_act, i in enumerate(active):
            s = self.streams[i]
            if spec and spec_gens[i] != s.gen:
                continue
            if spec:
                s.inflight = max(s.inflight - packed.shape[1], 0)
            base = bases[i]
            if not spec:
                s.defer_total = -1
                s.pred_start = -1
            saved_pred, saved_defer = s.pred_start, s.defer_total
            last_start = -1

            def k_next() -> int:
                return min(
                    self.frames_per_round,
                    max(
                        s.assembler.total_chunks
                        - s.assembler.received_count
                        - s.inflight,
                        1,
                    ),
                )

            det, start_v, by_row = det_all[i], start_all[i], by_all[i]
            if (
                fast_ok is not None
                and fast_ok[j_act]
                and s.meta_received
                and s.assembler.chunk_size == cs0
            ):
                # WHOLE-ROUND FAST PATH: the vectorized pre-pass proved every
                # slot of this stream's round is a CRC-valid full data chunk
                # ending inside the window — exactly the state updates the
                # per-slot loop would make, without K Python iterations
                # (the 500 MB soak executes ~244k slot iterations; this
                # collapses steady-state rounds to one iteration per stream).
                kk = packed.shape[1]
                s.assembler.store_valid_chunks(seq_all[i], by_row, 7, cs0)
                s.stats.frames_decoded += kk
                s.stats.chunks_received = s.assembler.received_count
                last_start = base + int(start_v[kk - 1])
                s.scan_pos = last_start + est_len
                s.preamble_pos = -1
                s.expected_frame_end = -1
                s.state = RecvState.IDLE
                if spec:
                    # every slot routed exactly as speculated: the cursors
                    # advanced at dispatch time stay the live truth
                    s.pred_start, s.defer_total = saved_pred, saved_defer
                    continue
                s.pred_start = last_start + cadence
                next_round_end = s.pred_start + (k_next() - 1) * cadence + est_len
                if next_round_end <= s.ring.total_written:
                    rerun = True
                else:
                    s.defer_total = next_round_end - 1
                continue
            for k in range(packed.shape[1]):
                if not bool(det[k]):
                    if k == 0 and not predicted:
                        # full-scan slot found nothing: positions up to the
                        # scan horizon are clean — advance coverage. If the
                        # window ended short of the stream's write head
                        # there is more unscanned data to cover right now.
                        s.scan_pos = max(
                            s.scan_pos, base + max(int(lens[i]) - 2 * self._half + 1, 1)
                        )
                        if base + int(lens[i]) < s.ring.total_written:
                            rerun = True
                    else:
                        # a failed PREDICTION says nothing about frames at
                        # other positions — rescan (full) from the last
                        # consumed position next round
                        rerun = True
                        if spec:
                            s.gen += 1
                            s.inflight = 0
                            s.pred_start = -1
                            s.defer_total = -1
                    break
                abs_start = base + int(start_v[k])
                est_end = abs_start + est_len
                if est_end > base + int(lens[i]):
                    if spec:  # later in-flight rounds assumed this one fit
                        s.gen += 1
                        s.inflight = 0
                    if est_len <= w:
                        # wait until a whole round of frames can exist, not
                        # just this one: steady-state senders emit chunks on
                        # a fixed cadence, so one K-slot dispatch per K
                        # frames replaces one dispatch per frame. The frame's
                        # detected start seeds the next round's slot-0
                        # prediction — the deferred round needs no scan.
                        s.defer_total = est_end - 1 + (k_next() - 1) * cadence
                        s.pred_start = abs_start
                    else:
                        s.preamble_pos = abs_start
                        s.scan_pos = abs_start + self._half
                        s.state = RecvState.PREAMBLE_DETECTED
                        rerun = True
                    break
                if (
                    full_all is not None
                    and bool(full_all[i, k])
                    and s.meta_received
                    and s.assembler.chunk_size == cs0
                ):
                    # FAST PATH: the vectorized pre-pass already proved this
                    # slot is a CRC-valid full data chunk. Store straight off
                    # the numpy row view and apply exactly the state updates
                    # _route_result would make for it: payload_len = 11 + cs0
                    # is the same value est_len was computed from, so
                    # resume_pos = min(abs_start + est_len, est_end) = est_end.
                    s.assembler.store_valid_chunk(
                        int(seq_all[i, k]), by_row[k, 7 : 7 + cs0]
                    )
                    s.stats.frames_decoded += 1
                    s.stats.chunks_received = s.assembler.received_count
                    s.scan_pos = est_end
                    s.preamble_pos = -1
                    s.expected_frame_end = -1
                    s.state = RecvState.IDLE
                    s.pred_start = -1
                    last_start = abs_start
                    continue
                result = framing.parse_payload_bytes(by_row[k].tobytes(), min_len=6)
                s.preamble_pos = abs_start
                s.expected_frame_end = est_end
                if decoder._parse_failed(result):
                    s.state = RecvState.COLLECTING_FRAME  # staged retry ladder
                    rerun = True
                    if spec:
                        s.gen += 1
                        s.inflight = 0
                        s.pred_start = -1
                        s.defer_total = -1
                    break
                full = (
                    isinstance(result, framing.DataFrame)
                    and result.crc_valid
                    and len(result.data) == s.assembler.chunk_size
                )
                self._route_result(s, result)
                if not full:
                    rerun = True  # short/other frame: rescan from its true end
                    if spec:
                        s.gen += 1
                        s.inflight = 0
                        s.defer_total = -1  # pred cleared by _reset already
                    break
                last_start = abs_start
            else:
                if spec:
                    # every slot routed exactly as speculated: the cursors
                    # advanced at dispatch time (past LATER in-flight
                    # rounds) are the live truth — restore them over the
                    # clears _route_result's _reset performed
                    s.pred_start = saved_pred
                    s.defer_total = saved_defer
                    continue
                # every slot routed a full frame. Re-run only once the ring
                # holds the whole NEXT K-round — the same precondition the
                # scan-free predicted round checks. Re-running as soon as a
                # single next frame existed (the old threshold) degraded the
                # steady state to one full-scan round per K-round: the early
                # round could never be predicted (not all K frames present),
                # so it paid a window scan AND a result fetch to decode
                # 1-2 frames, alternating scan/predicted forever.
                s.pred_start = last_start + cadence
                next_round_end = s.pred_start + (k_next() - 1) * cadence + est_len
                if next_round_end <= s.ring.total_written:
                    rerun = True
                else:
                    s.defer_total = next_round_end - 1
        with self.timer.stage("consume_commit"):  # sub-stage of multi_consume
            for i in active:
                # round-boundary commit hook: the assembler buffers fast-path
                # rows host-side and only lands an executemany+commit batch once
                # _FLUSH_ROWS accumulate instead of one execute per chunk and
                # one commit per round; no-op for in-memory assemblers
                self.streams[i].assembler.commit()
        return rerun

    def _drain_pending(self, drain_all: bool = False) -> None:
        """Fetch + consume queued speculative rounds, oldest first: down to
        pipeline_depth normally, entirely when ``drain_all`` (end of input,
        or a non-predicted dispatch is about to touch truth state). By pop
        time the round's async D2H copy has long finished in the
        background, so the np.asarray is a host-memory read, not a device
        synchronization."""
        while self._pending and (
            drain_all
            or len(self._pending) > self.pipeline_depth
            or (
                self.device_ingest
                and self.dring.total_written - self._pending[0][-1]
                > self.dring.capacity - 2 * self._max_frame
            )  # oldest round's window nearing ring eviction: settle it now
        ):
            dev, active, bases, lens, est_len, cadence, w, gens, _base = (
                self._pending.popleft()
            )
            with self.timer.stage("pipe_fetch"):
                packed = np.asarray(dev)
            with self.timer.stage("multi_consume"):
                self._consume_multi(
                    active, bases, lens, packed, est_len, cadence, w,
                    predicted=True, spec_gens=gens,
                )

    def _window_decode_all(self) -> bool:
        p = self.mode.profile
        sym = p.symbol_len
        w = self.scan_bucket
        min_need = 4 * sym + 2 * self._half
        lens = np.zeros(self.n, np.int32)
        bases: dict[int, int] = {}
        active = []
        if self.device_ingest:
            total = self.dring.total_written
            cap = self.dring.capacity
            start_rel = np.zeros(self.n, np.int32)
            min_rel = np.zeros(self.n, np.int32)

            def fill(i: int, s: _Stream, w_eff: int) -> None:
                # window base: cover scan_pos..total, sliding left so the
                # slice stays inside the ring; min_pos preserves resume
                # semantics when the base precedes scan_pos. A live cadence
                # prediction anchors the window on the PREDICTED span
                # instead — during pipelined rounds scan_pos (truth,
                # advanced at consume) lags the dispatch frontier by up to
                # pipeline_depth K-rounds, far beyond the window width.
                anchor = s.scan_pos
                if s.pred_start >= 0:
                    anchor = max(anchor, s.pred_start - self._pred_pad)
                eff = max(min(anchor, total - w_eff), total - cap)
                start_rel[i] = eff - (total - cap)
                min_rel[i] = max(s.scan_pos - eff, 0)
                lens[i] = min(total - eff, w_eff)
                bases[i] = eff

            for i, s in enumerate(self.streams):
                if s.state is not RecvState.IDLE:
                    continue
                if s.defer_total >= 0 and total <= s.defer_total:
                    continue  # deferred: waiting for more samples
                s.scan_pos = max(s.scan_pos, total - cap, 0)
                if total - s.scan_pos < min_need:
                    continue
                fill(i, s, w)
                active.append(i)
            if not active:
                return False
            multi = self._multi_params(active, cap)
            if multi:
                n_sym_frame, est_len, cadence, k, w_multi = multi
                for i in active:  # re-slice with the K-frame window
                    fill(i, self.streams[i], w_multi)
                # scan-free round: every active stream predicts its next
                # frame's start (cadence bookkeeping from the previous
                # round) and all K frames fit the window
                pred_rel = np.zeros(self.n, np.int32)
                predicted = True
                for i in active:
                    pr = self.streams[i].pred_start - bases[i]
                    if pr < 0 or pr + (k - 1) * cadence + est_len > int(lens[i]):
                        predicted = False
                        break
                    pred_rel[i] = pr
                if self._pending and not predicted:
                    # speculation survives only unbroken predicted rounds:
                    # drain before any scanning dispatch so stale in-flight
                    # results can't interleave with truth-state scans
                    self._drain_pending(drain_all=True)
                    return True
                if predicted and self.pipeline_depth > 0:
                    # speculative dispatch: enqueue the round with an async
                    # D2H copy and advance the cursors as if all K slots
                    # will route (consumption validates, up to
                    # pipeline_depth rounds later) — the blocking fetch
                    # leaves the per-round critical path entirely
                    with self.timer.stage(
                        "pred_dispatch", k * cadence * len(active)
                    ):
                        dev = _batch_window_decode_pred_dev(
                            self.dring.buf,
                            jnp.asarray(np.stack([start_rel, pred_rel, lens])),
                            self.mode,
                            n_sym_frame,
                            k,
                            cadence,
                            w_multi,
                        )
                    dev.copy_to_host_async()
                    self._pending.append((
                        dev,
                        list(active),
                        dict(bases),
                        lens.copy(),
                        est_len,
                        cadence,
                        w_multi,
                        {i: self.streams[i].gen for i in active},
                        min(bases[i] for i in active),
                    ))
                    for i in active:
                        s = self.streams[i]
                        s.pred_start += k * cadence
                        s.inflight += k
                        nre = s.pred_start + (k - 1) * cadence + est_len
                        s.defer_total = -1 if nre <= total else nre - 1
                    self._drain_pending()
                    return True
                stage = "pred" if predicted else "multi"
                with self.timer.stage(f"{stage}_dispatch", k * cadence * len(active)):
                    if predicted:
                        dev = _batch_window_decode_pred_dev(
                            self.dring.buf,
                            jnp.asarray(np.stack([start_rel, pred_rel, lens])),
                            self.mode,
                            n_sym_frame,
                            k,
                            cadence,
                            w_multi,
                        )
                    else:
                        dev = _batch_window_decode_multi_dev(
                            self.dring.buf,
                            jnp.asarray(np.stack([start_rel, min_rel, lens])),
                            self.mode,
                            n_sym_frame,
                            k,
                            cadence,
                            w_multi,
                        )
                with self.timer.stage(f"{stage}_fetch"):
                    packed = np.asarray(dev)
                with self.timer.stage("multi_consume"):
                    return self._consume_multi(
                        active, bases, lens, packed, est_len, cadence, w_multi,
                        predicted=predicted,
                    )
            if self._pending:
                self._drain_pending(drain_all=True)
                return True
            with self.timer.stage("single_dispatch", int(lens.sum())):
                out = _batch_window_decode_dev(
                    self.dring.buf,
                    jnp.asarray(np.stack([start_rel, min_rel, lens])),
                    self.mode,
                    self._win_max_syms,
                    w,
                )
        else:
            windows = np.zeros((self.n, w), np.float32)
            for i, s in enumerate(self.streams):
                if s.state is not RecvState.IDLE:
                    continue
                total = s.ring.total_written
                if s.defer_total >= 0 and total <= s.defer_total:
                    continue  # deferred: waiting for more samples
                s.scan_pos = max(s.scan_pos, total - s.ring.capacity, 0)
                avail = total - s.scan_pos
                if avail < min_need:
                    continue  # too short to host a frame; staged flush drains tails
                win = s.ring.get_range(s.scan_pos, min(avail, w))
                if win is None:
                    continue
                windows[i, : len(win)] = win
                lens[i] = len(win)
                bases[i] = s.scan_pos
                active.append(i)
            if not active:
                return False
            # host-fed windows stay at scan_bucket width (bigger windows
            # would multiply the per-round sample upload); K clamps to the
            # frame cadences that width can hold
            multi = self._multi_params(active, w)
            if multi:
                n_sym_frame, est_len, cadence, k, _ = multi
                packed = np.asarray(
                    _batch_window_decode_multi(
                        jnp.asarray(windows),
                        jnp.zeros(self.n, jnp.int32),
                        jnp.asarray(lens),
                        self.mode,
                        n_sym_frame,
                        k,
                        cadence,
                    )
                )
                return self._consume_multi(active, bases, lens, packed, est_len, cadence, w)
            out = _batch_window_decode(
                jnp.asarray(windows), jnp.asarray(lens), self.mode, self._win_max_syms
            )
        with self.timer.stage("single_fetch"):
            detected, starts, by_rows = _unpack_round(np.asarray(out))
        progressed = False
        for i in active:
            s = self.streams[i]
            base = bases[i]
            s.defer_total = -1
            if not detected[i]:
                s.scan_pos = max(
                    s.scan_pos, base + max(int(lens[i]) - 2 * self._half + 1, 1)
                )
                progressed = True
                continue
            abs_start = base + int(starts[i])
            max_payload = (
                (s.assembler.chunk_size or 4096) + 11 if s.meta_received else PRE_META_MAX_PAYLOAD
            )
            if self.fec:
                max_payload = framing.fec_wire_len(max_payload)
            est_len = framing.estimate_frame_samples(max_payload, self.mode)
            est_end = abs_start + est_len
            if est_end > base + int(lens[i]):
                if est_len <= w:
                    # the frame will fit a FUTURE window once est_end
                    # samples exist — wait instead of dropping to the
                    # staged machine (whose per-stream range fetches cost a
                    # dispatch each in device-ingest mode). Not progress:
                    # nothing changes until more samples arrive.
                    s.defer_total = est_end - 1
                    continue
                # frame longer than any window: stage it
                s.preamble_pos = abs_start
                s.scan_pos = abs_start + self._half
                s.state = RecvState.PREAMBLE_DETECTED
                progressed = True
                continue
            n_sym = (est_end - abs_start - 3 * sym) // sym
            result = framing.parse_payload_bytes(by_rows[i].tobytes(), min_len=6)
            s.preamble_pos = abs_start
            s.expected_frame_end = est_end
            progressed = True
            if decoder._parse_failed(result):
                # hand the frame to the staged demod + its retry ladder
                s.state = RecvState.COLLECTING_FRAME
                continue
            self._route_result(s, result)
        return progressed

    # ---- batched scan ----

    def _scan_all(self) -> bool:
        p = self.mode.profile
        windows = np.zeros((self.n, self.scan_bucket), np.float32)
        lens = np.zeros(self.n, np.int32)
        active = []
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.IDLE:
                continue
            total = s.ring.total_written
            s.scan_pos = max(s.scan_pos, total - s.ring.capacity, 0)
            scan_end = total - 2 * self._half
            if s.scan_pos > scan_end:
                continue
            n_pos = min(scan_end - s.scan_pos + 1, self.scan_bucket - 2 * self._half)
            win_len = n_pos + 2 * self._half - 1
            w = s.ring.get_range(s.scan_pos, win_len)
            if w is None:
                continue
            windows[i, :win_len] = w
            lens[i] = win_len
            active.append((i, n_pos))
        if not active:
            return False
        idx, _ = _batch_scan(jnp.asarray(windows), jnp.asarray(lens), p)
        idx = np.asarray(idx)
        progressed = False
        for i, n_pos in active:
            s = self.streams[i]
            if idx[i] >= 0:
                s.preamble_pos = s.scan_pos + int(idx[i])
                s.scan_pos = s.preamble_pos + self._half
                s.state = RecvState.PREAMBLE_DETECTED
            else:
                s.scan_pos += n_pos
            progressed = True
        return progressed

    # ---- batched refine ----

    def _refine_all(self) -> bool:
        p = self.mode.profile
        plen = p.symbol_len
        radius = 3 * p.cp_len
        regions = np.zeros((self.n, self._refine_pad), np.float32)
        coarse_rel = np.zeros(self.n, np.int32)
        lens = np.zeros(self.n, np.int32)
        active: list[tuple[int, int]] = []
        pending: list[tuple[int, int, int]] = []  # (i, lo, avail)
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.PREAMBLE_DETECTED:
                continue
            if s.ring.total_written < s.preamble_pos + plen + radius:
                continue  # wait for samples
            lo = max(s.ring.total_written - s.ring.capacity, s.preamble_pos - radius, 0)
            avail = min(self._region_len, s.ring.available_from(lo))
            pending.append((i, lo, avail))
        if self.device_ingest and pending:
            # one gather dispatch for all regions (fixed length; the lens
            # array masks each stream's true extent)
            glen = self._region_len
            fetch = []
            for i, lo, avail in pending:
                end = min(lo + glen, self.dring.total_written)
                if self.dring.rel(lo) < 0 or end <= lo:
                    self.streams[i].state = RecvState.IDLE
                    continue
                fetch.append((i, lo, avail))
            if fetch:
                # slice a fixed glen window; samples past total_written are
                # stale ring content, masked out by lens
                safe_starts = [
                    min(lo, max(self.dring.total_written - glen, self.dring.total_written - self.dring.capacity))
                    for _, lo, _ in fetch
                ]
                got = self.dring.gather_ranges([i for i, _, _ in fetch], safe_starts, glen)
                for k, (i, lo, avail) in enumerate(fetch):
                    off = lo - safe_starts[k]
                    regions[i, :avail] = got[k][off : off + avail]
                    coarse_rel[i] = self.streams[i].preamble_pos - lo
                    lens[i] = avail
                    active.append((i, lo))
        else:
            for i, lo, avail in pending:
                s = self.streams[i]
                region = s.ring.get_range(lo, avail)
                if region is None:
                    s.state = RecvState.IDLE
                    continue
                regions[i, : len(region)] = region
                coarse_rel[i] = s.preamble_pos - lo
                lens[i] = len(region)
                active.append((i, lo))
        if not active:
            return False
        best_rel, metric = _batch_refine(
            jnp.asarray(regions), jnp.asarray(coarse_rel), jnp.asarray(lens), p
        )
        best_rel, metric = np.asarray(best_rel), np.asarray(metric)
        for i, lo in active:
            s = self.streams[i]
            if metric[i] < sync.XCORR_THRESHOLD:
                s.state = RecvState.IDLE  # false positive (app.js:879-884)
                continue
            s.preamble_pos = lo + int(best_rel[i])
            max_payload = (
                (s.assembler.chunk_size or 4096) + 11 if s.meta_received else PRE_META_MAX_PAYLOAD
            )
            if self.fec:
                max_payload = framing.fec_wire_len(max_payload)
            s.expected_frame_end = s.preamble_pos + framing.estimate_frame_samples(
                max_payload, self.mode
            )
            s.state = RecvState.COLLECTING_FRAME
        return True

    # ---- batched demod ----

    def _demod_ready(self) -> bool:
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.COLLECTING_FRAME:
                continue
            if s.ring.total_written < s.expected_frame_end:
                continue
            groups.setdefault(s.expected_frame_end - s.preamble_pos, []).append(i)
        if not groups:
            return False
        p = self.mode.profile
        sym = p.symbol_len
        for frame_len, members in groups.items():
            n_sym = (frame_len - 3 * sym) // sym
            usable = (3 + n_sym) * sym
            frames = np.zeros((len(members), usable), np.float32)
            ok_members = []
            if self.device_ingest:
                # ONE gather dispatch for the whole group (per-stream
                # get_range costs a dispatch and a host sync each)
                fetch: list[tuple[int, int]] = []
                for row, i in enumerate(members):
                    s = self.streams[i]
                    if (
                        self.dring.rel(s.preamble_pos) < 0
                        or s.preamble_pos + usable > self.dring.total_written
                    ):
                        s.stats.frame_errors += 1
                        self._reset(s, None)
                        continue
                    fetch.append((row, i))
                if fetch:
                    got = self.dring.gather_ranges(
                        [i for _, i in fetch],
                        [self.streams[i].preamble_pos for _, i in fetch],
                        usable,
                    )
                    for k, (row, i) in enumerate(fetch):
                        frames[row] = got[k]
                        ok_members.append((row, i))
            else:
                for row, i in enumerate(members):
                    s = self.streams[i]
                    f = s.ring.get_range(s.preamble_pos, usable)
                    if f is None:
                        s.stats.frame_errors += 1
                        self._reset(s, None)
                        continue
                    frames[row] = f
                    ok_members.append((row, i))
            if not ok_members:
                continue
            # ONE device dispatch per group: decode + majority vote + bit
            # packing fused (batch_decode_chunk_frames_packed); D2H is the
            # decoded byte matrix, 8-32x smaller than bits.
            by_rows = np.asarray(
                batch_decode_chunk_frames_packed(jnp.asarray(frames), self.mode, n_sym)
            )
            for row, i in ok_members:
                self._route(self.streams[i], by_rows[row].tobytes(), n_sym, frames[row])
        return True

    def _route(
        self, s: _Stream, by: bytes, n_sym: int, frame: np.ndarray | None = None
    ) -> None:
        result = framing.parse_payload_bytes(by, min_len=6)
        if (
            frame is not None
            and decoder._parse_failed(result)
            and decoder._soft_retry_applicable(self.mode)
        ):
            # soft repetition-combining retry (see decoder.decode_chunk_frame)
            soft = np.asarray(decoder._chunk_soft_core(jnp.asarray(frame), self.mode, n_sym))
            soft_by = bits_to_bytes(soft_combine(soft, self.mode.repetition))
            soft_result = framing.parse_payload_bytes(soft_by, min_len=6)
            if not decoder._parse_failed(soft_result):
                result = soft_result
        if (
            frame is not None
            and isinstance(result, framing.FrameError)
            and result.error.startswith("FEC decode failed")
        ):
            # errors-and-erasures retry (see decoder.decode_chunk_frame)
            evm = np.asarray(decoder._chunk_evm_core(jnp.asarray(frame), self.mode, n_sym))
            flags = decoder._byte_erasures(evm, self.mode, decoder._fec_region_bytes(by))
            if flags is not None:
                retry = framing.parse_payload_bytes(by, min_len=6, erasures=flags)
                if not isinstance(retry, framing.FrameError):
                    result = retry
        if frame is not None and decoder._parse_failed(result):
            # timing-tracked retry (see decoder.decode_chunk_frame)
            tbits = np.asarray(
                decoder._chunk_tracked_core(jnp.asarray(frame), self.mode, n_sym)
            )
            tresult = decoder._bits_to_parse(tbits, n_sym, self.mode, min_len=6)
            if not decoder._parse_failed(tresult):
                result = tresult
        self._route_result(s, result)

    def _route_result(self, s: _Stream, result: framing.ParseResult) -> None:
        """Post-parse routing: assembler/stats updates + FSM reset. Expects
        s.preamble_pos / s.expected_frame_end to describe the frame."""
        resume_pos = None
        if isinstance(result, framing.FrameError):
            s.stats.frame_errors += 1
            resume_pos = s.preamble_pos + 4 * self.mode.profile.symbol_len
        else:
            s.stats.frames_decoded += 1
            payload_len = None
            if isinstance(result, framing.MetaFrame):
                if result.crc_valid:
                    s.assembler.handle_metadata(result)
                    s.meta_received = True
                    s.stats.total_chunks = result.total_chunks
                    payload_len = 12 + len(result.file_name.encode("utf-8")) + 4
                else:
                    s.stats.frame_errors += 1
            elif isinstance(result, framing.DataFrame):
                s.assembler.handle_data_chunk(result)
                s.stats.crc_errors = s.assembler.crc_errors
                s.stats.chunks_received = s.assembler.received_count
                if result.crc_valid:
                    payload_len = 11 + len(result.data)
            if payload_len is not None:
                if self.fec:
                    payload_len = framing.fec_wire_len(payload_len)
                actual = framing.estimate_frame_samples(payload_len, self.mode)
                resume_pos = min(s.preamble_pos + actual, s.expected_frame_end)
        self._reset(s, resume_pos)

    def _reset(self, s: _Stream, resume_pos: int | None) -> None:
        if resume_pos is not None:
            s.scan_pos = resume_pos
        elif s.expected_frame_end > 0:
            s.scan_pos = s.expected_frame_end
        s.preamble_pos = -1
        s.expected_frame_end = -1
        s.state = RecvState.IDLE
        # any route invalidates a cadence prediction; _consume_multi re-seeds
        # its own predictions after routing a full round
        s.pred_start = -1

    # ---- results ----

    def flush(self) -> None:
        """Decode partially collected frames at end of input.

        Mirrors runtime.receiver.StreamingReceiver.flush for EVERY stream
        state: a stream that detected a preamble but hadn't refined when the
        input ended (PREAMBLE_DETECTED) gets one final refinement attempt on
        whatever samples exist, then demodulates from its best-known
        position — previously such streams silently dropped their last frame.
        Frame expectations are truncated to the samples actually available
        (the batch analog of partial_ok)."""
        p = self.mode.profile
        # settle the speculative fetch pipeline first: truth state (scan
        # positions, assembler contents) must be current before tail logic
        self._drain_pending(drain_all=True)
        if self.window_decode:
            # Input has ended: deferrals wait for samples that will never
            # arrive, and cadence predictions point past the write head
            # (their windows would anchor beyond the remaining tail). Clear
            # BOTH every iteration and re-run the TURBO machine — truth-
            # anchored full-scan window rounds over the undelivered span
            # (the pipeline leaves up to pipeline_depth K-rounds of frames
            # between the truth scan position and the write head) — until
            # quiescent. Leaving this to the staged scanner costs seconds:
            # it fetches windows per stream per cycle.
            for _ in range(8 * max(self.pipeline_depth, 1)):
                for s in self.streams:
                    s.defer_total = -1
                    s.pred_start = -1
                if self._step_all():
                    continue
                if not self._pending:
                    break
                self._drain_pending(drain_all=True)  # may roll back → retry
        # drain via the STAGED machine first: the turbo path skips windows
        # too short to host a whole frame, so a tail frame can still be
        # sitting undetected in the ring at end of input
        for _ in range(8):
            if not (self._scan_all() | self._refine_all() | self._demod_ready()):
                break
        # final refinement attempt with the samples we have
        self._refine_all()
        for s in self.streams:
            if (
                s.state in (RecvState.PREAMBLE_DETECTED, RecvState.COLLECTING_FRAME)
                and s.preamble_pos >= 0
            ):
                have = s.ring.available_from(s.preamble_pos)
                if have >= 4 * p.symbol_len:
                    end = s.preamble_pos + have
                    if s.expected_frame_end > 0:
                        end = min(end, s.expected_frame_end)
                    s.expected_frame_end = end
                    s.state = RecvState.COLLECTING_FRAME
        self._demod_ready()

    def results(self):
        return [
            {
                "complete": s.assembler.is_complete,
                "data": s.assembler.assemble() if s.assembler.total_chunks else b"",
                "file_name": s.assembler.file_name,
                "missing": s.assembler.missing_chunks(),
                "stats": s.stats,
            }
            for s in self.streams
        ]

    def cleanup(self) -> None:
        for s in self.streams:
            s.assembler.cleanup()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
