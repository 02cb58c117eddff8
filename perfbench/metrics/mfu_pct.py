"""mfu_pct (``.chat``, ``.long``: split by the end-to-end metric it moves):
model FLOPs the served tokens needed over the window's seconds, over 495
TFLOP/s (see ``harness.flops.mfu_pct``)."""
from perfbench.harness import flops


def read(run):
    return flops.mfu_pct(run)
