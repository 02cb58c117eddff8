"""A tiny configuration, mixes and cells for the CPU tests: the benchmark's
code paths at sizes a test run holds (the port's plain kernel versions
stand in for the CUDA kernels on the CPU)."""
import copy

from perfbench.harness import driver, spec

DIMS = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "n_experts": 8, "top_k": 2, "d_expert": 32,
        "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-05}

CONFIG = {
    "name": "tiny", "reference": "moe_decoder",
    "port": {"arch": "qwen3-moe-30b-a3b",
             "fields": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                        "n_kv_heads": 2, "head_dim": 16, "n_experts": 8,
                        "top_k": 2, "d_expert": 32, "d_ff": 32,
                        "vocab_size": 512, "rope_theta": 10000.0}},
    "dims": DIMS,
    "serving": {"weights_dtype": "float32", "kv_cache_dtype": "bfloat16",
                "policy": "2t", "drop_target": 0.25, "delta": 0.05,
                "partition_p": 2, "importance": "abs_gate",
                "calibration_tokens": 256},
}

CHAT = {
    "engine": {"kind": "paged", "n_slots": 4, "page_size": 16,
               "chunk_size": 32, "max_prompt_len": 96, "max_new_tokens": 16,
               "prefix_cache": True},
    "rate_per_s": 6.0,
    "prompt": {"shared_prefix": {"count": 2, "length": 32, "zipf_s": 1.0},
               "suffix": {"dist": "lognormal", "median": 20, "sigma": 0.6,
                          "min": 8, "max": 64}},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4,
               "max": 16},
    "check": {"requests": 6},
}

LONG = {
    "engine": {"kind": "continuous", "n_slots": 4, "max_prompt_len": 96,
               "max_new_tokens": 16},
    "rate_per_s": 6.0,
    "prompt": {"suffix": {"dist": "lognormal", "median": 48, "sigma": 0.4,
                          "min": 16, "max": 96}},
    "output": {"dist": "uniform", "min": 4, "max": 12},
    "check": {"requests": 6},
}

# set as a cell's limit is set, from the tiny readings on the CPU: sound
# runs read 0 (no served token differs from the reference's best), the
# TF32 control 6e-8 - 1e-7 over 3000 positions, a fault 1e-3 or more
LIMITS = {"mean_logit_gap": {"limit": 2e-8}, "min_compared": {"limit": 5}}
# keep-all compares the share of served tokens not the reference's best:
# sound runs read 0, the TF32 control 3e-4 - 1.3e-3 over 3000 positions
KEEPALL_LIMITS = {"mismatch_share": {"limit": 1e-4},
                  "min_compared": {"limit": 5}}


# the tiny configuration served keep-all: no partition, no dropping
KEEPALL = {**CONFIG, "name": "tiny-keepall",
           "serving": {"weights_dtype": "float32",
                       "kv_cache_dtype": "bfloat16", "policy": "none",
                       "partition_p": 1}}


def cell(mix, name="tiny.chat", config=CONFIG, limits=LIMITS):
    bench = spec.load_benchmark()
    return spec.Cell(
        workload={"name": name, "config": config["name"], "traffic": name,
                  "chips": 1},
        config=copy.deepcopy(config), traffic=copy.deepcopy(mix),
        limits=copy.deepcopy(limits),
        end_to_end=bench["end_to_end"],
        per_layer=[m for m in bench["per_layer"]
                   if m["source"] not in ("device_trace",)])


class VirtualTime(driver.Hooks):
    """A window clock that moves only when the loop steps the engine (a
    fixed ``step_s`` a step) or waits: a CPU test's window then holds the
    same work however busy the machine is."""

    def __init__(self, step_s: float = 0.02):
        self.now = 0.0
        self.step_s = step_s

    def clock(self) -> float:
        return self.now

    def step(self, engine) -> None:
        engine.step()
        self.now += self.step_s

    def wait(self, seconds: float) -> None:
        self.now += max(seconds, 1e-4)
