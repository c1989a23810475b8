"""The benchmark's plain reference: HOISDF, its sampler, MANO, losses and
AdamW in plain PyTorch and f32.  It imports nothing of the measured program
and takes nothing it made: the benchmark hands both sides the same weights,
MANO buffers and inputs."""
