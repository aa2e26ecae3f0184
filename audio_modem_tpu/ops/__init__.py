"""L1 DSP primitives: deterministic sequences, codecs, and matmul transforms."""
