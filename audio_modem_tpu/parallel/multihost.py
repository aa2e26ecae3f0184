"""Multi-host (multi-process) distribution: the DCN story.

SURVEY §2's parallelism table names "DCN for multi-host batch ingest" as the
first-class distributed equivalent of this domain (the reference has no
analog — app.js is a single browser thread). The layout:

  * intra-host device links carry the stream-batch sharding — each device
    owns a contiguous slab of independent audio streams, so steady-state
    cross-device traffic is ZERO;
  * the host-to-host network carries only (a) batch ingest — each host
    feeds its own local streams, there is no resharding — and (b) the tiny
    result collectives (scalar BER psum, decode-flag all-gather).

In JAX this is one GLOBAL mesh spanning every process's devices
(jax.distributed.initialize + Mesh over jax.devices()); GSPMD places the
psum/all-gather on the right fabric automatically because the mesh axis
order puts same-host devices adjacent. Each process materializes only its
local shard (jax.make_array_from_process_local_data) — the multi-host form
of "the audio never leaves the host that captured it".

This is a multi-process dry run of jax.distributed, not a device path:
``__graft_entry__.dryrun_multihost`` launches N coordinator-connected child
processes x M virtual CPU devices (each child is pinned to the CPU on
purpose) and runs the SAME sharded loopback + full-pipeline decode step as
the single-process dryrun, proving the sharded program compiles and executes
across process boundaries.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

COORD_PORT = 9876


def _child_main(process_id: int, n_processes: int, devices_per_process: int, coord: str) -> None:
    """One host: join the cluster, run the sharded step on the global mesh."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=n_processes, process_id=process_id
    )
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from audio_modem_tpu import framing
    from audio_modem_tpu.configs import MODES
    from audio_modem_tpu.parallel.batch import batch_decode_signals, batch_loopback_step
    from audio_modem_tpu.parallel.mesh import STREAM_AXIS

    n_total = n_processes * devices_per_process
    devs = jax.devices()
    assert len(devs) == n_total, f"global mesh has {len(devs)} devices, wanted {n_total}"
    assert len(jax.local_devices()) == devices_per_process
    mesh = Mesh(np.asarray(devs), (STREAM_AXIS,))
    batch_spec = NamedSharding(mesh, P(STREAM_AXIS))
    repl = NamedSharding(mesh, P())

    mode = MODES["QPSK"]
    n_sym = 2
    per_dev = 2
    b = per_dev * n_total
    b_local = per_dev * devices_per_process

    # 1) sharded loopback step; the BER mean is the one cross-host collective
    rng = np.random.default_rng(100 + process_id)  # per-host local ingest
    bits_local = rng.integers(0, 2, (b_local, n_sym * mode.bits_per_symbol), dtype=np.int8)
    bits = jax.make_array_from_process_local_data(batch_spec, bits_local)
    key = jax.device_put(jax.random.PRNGKey(0), repl)
    step = jax.jit(
        lambda bb, kk: batch_loopback_step(bb, kk, mode, n_sym, 30.0)[0],
        out_shardings=repl,
    )
    ber = float(jax.block_until_ready(step(bits, key)))
    assert ber < 0.01, f"multihost loopback BER {ber}"

    # 2) sharded full-pipeline decode; detected flags all-gather over DCN
    frame = framing.build_data_chunk_frame(b"\x42" * 64, 0, mode)
    pad_len = -(-(len(frame) + mode.profile.symbol_len) // 128) * 128
    sig_local = np.zeros((b_local, pad_len), np.float32)
    sig_local[:, : len(frame)] = frame
    nv_local = np.full(b_local, len(frame), np.int32)
    sig = jax.make_array_from_process_local_data(batch_spec, sig_local)
    nv = jax.make_array_from_process_local_data(batch_spec, nv_local)
    max_syms = 4
    dec = jax.jit(
        lambda s, v: batch_decode_signals(s, v, mode, max_syms)["detected"],
        out_shardings=repl,
    )
    detected = np.asarray(jax.block_until_ready(dec(sig, nv)))
    assert detected.shape == (b,) and detected.all(), f"multihost decode: {detected}"
    print(f"multihost child {process_id}/{n_processes} OK (ber={ber:.4f})", flush=True)


def run_dryrun(n_processes: int = 2, devices_per_process: int = 4, timeout: float = 900.0) -> None:
    """Launch ``n_processes`` coordinator-connected CPU processes and run the
    sharded step across them (parent side of dryrun_multihost)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    flags.append(f"--xla_force_host_platform_device_count={devices_per_process}")
    env["XLA_FLAGS"] = " ".join(flags)
    coord = f"127.0.0.1:{COORD_PORT}"
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-m",
                "audio_modem_tpu.parallel.multihost",
                "--child",
                str(pid),
                str(n_processes),
                str(devices_per_process),
                coord,
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(n_processes)
    ]
    outs = []
    failed = False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            failed = True
        outs.append((p.returncode, out, err))
        failed |= p.returncode != 0
    if failed:
        detail = "\n".join(
            f"--- child rc={rc} ---\n{out[-1500:]}\n{err[-3000:]}" for rc, out, err in outs
        )
        raise RuntimeError(f"multihost dryrun failed:\n{detail}")


if __name__ == "__main__":
    if len(sys.argv) >= 6 and sys.argv[1] == "--child":
        _child_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    run_dryrun()
    print("multihost dryrun OK")
