"""fused_moe_pipeline_roofline (``.chat``, ``.long``: split by the end-to-
end metric it moves): the fused MoE kernel's share of its roofline over
the traced sub-window: the least time each call could take (its
operations at 495 TFLOP/s, the tensor cores' float32-operand rate, or
its bytes at 3.35 TB/s, whichever is larger; operations and bytes
counted from the routing outcome handed to the call) summed over the
calls, over the device time of the kernels named below."""
from perfbench.harness import flops

# the kernels of csrc/fused_moe_pipeline.cu and csrc/swiglu_tiles.cuh
KERNELS = (r"(?<![A-Za-z0-9_])((up|down)(_mma|_tf32)?|position_key|combine)"
           r"_kernel(?![A-Za-z0-9_])")


def read(run):
    if run.trace is None:
        return None
    return flops.fused_roofline_pct(run.fused_calls,
                                    run.trace.device_time(KERNELS))
