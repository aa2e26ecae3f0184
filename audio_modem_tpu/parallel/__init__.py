"""Device-level parallelism: mesh construction + sharded stream-batch decode.

The domain's parallel dimension is (streams x frames x symbols x subcarriers)
— embarrassingly parallel (SURVEY §2 'parallelism inventory'). Data
parallelism over the stream/frame batch is the first-class axis, sharded with
jax.sharding; no tensor/pipeline/expert-parallel analog exists in
this domain (there is no model with weights), which we state rather than
invent. Cross-device communication is limited to final metric reductions
(psum-style all-reduce), exactly as the physics of independent audio streams
dictates.

Fabric placement: the stream batch shards over the devices of a host —
zero steady-state cross-device traffic since streams are independent —
while the host-to-host network carries only multi-host batch INGEST (each host
feeds its locally captured streams; there is no resharding) and the tiny
result collectives. multihost.py runs this as a real
jax.distributed.initialize cluster (N processes x M devices, one global
mesh) and is exercised by __graft_entry__.dryrun_multihost.
"""

from audio_modem_tpu.parallel.mesh import make_mesh, shard_batch
from audio_modem_tpu.parallel.batch import (
    batch_decode_chunk_frames,
    batch_decode_signals,
    batch_loopback_step,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "batch_decode_chunk_frames",
    "batch_decode_signals",
    "batch_loopback_step",
]
