"""Everything the benchmark asks of the program (``repro_torch``): its
configuration, its model with the benchmark's weights copied in, the 2T
preparation, an engine, and what the engine exposes — its counters, its
spans, and the calls into the fused MoE kernel (recorded from here,
around the call, while a trace is taken). This module is the only one of
the harness that imports the program."""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Dict, List

import torch

from . import weights as W

_ATTN = ("wq", "wk", "wv", "wo")
# the sizes in a configuration file's ``dims`` that the program's config
# must hold too (others, such as ``clip_qkv``, are the reference's alone)
PORT_DIMS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "n_experts", "top_k", "d_expert", "vocab_size", "rope_theta",
             "norm_eps")
_MOE = ("wg", "w1", "w3", "w2")


def port_param_name(name: str) -> str:
    """The program's parameter name of one of the benchmark's leaves."""
    if name == "embed":
        return "embed.embedding"
    if name == "lm_head":
        return "embed.lm_head"
    if name == "final_norm":
        return "final_norm"
    _, i, leaf = name.split(".")
    if leaf in _ATTN:
        return f"blocks.{i}.attn.{leaf}"
    if leaf in _MOE:
        return f"blocks.{i}.moe.{leaf}"
    return f"blocks.{i}.{leaf}"


def port_config(conf: Dict):
    """The program's ``ModelConfig``: its registry entry with the file's
    sizes put in. Refuses an architecture the reference does not
    cover."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(conf["port"]["arch"]),
                              **conf["port"]["fields"])
    serving = conf["serving"]
    want = dict(family="moe", attn_kind="gqa", qkv_bias=False,
                n_shared_experts=0, mlp_kind="swiglu", frontend="",
                tie_embeddings=False, router_norm_topk=True)
    for key, value in want.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"{cfg.arch_id}: {key} is {getattr(cfg, key)!r}"
                             f", the reference covers {value!r}")
    ds = cfg.dualsparse
    if (ds.partition_p, ds.importance) != (serving["partition_p"],
                                           serving["importance"]):
        raise ValueError(f"{cfg.arch_id}: the program prepares P="
                         f"{ds.partition_p} by {ds.importance}, the file "
                         f"says P={serving['partition_p']} by "
                         f"{serving['importance']}")
    for key in PORT_DIMS:
        have = cfg.resolved_head_dim if key == "head_dim" else \
            getattr(cfg, key)
        value = conf["dims"][key]
        if have != value:
            raise ValueError(f"{cfg.arch_id}: {key} is {have}, the file "
                             f"says {value}")
    return cfg


def build_model(cfg, dims: Dict, seed: int, device):
    """The program's model, allocated by the program and filled with the
    benchmark's seeded leaves."""
    from repro_torch.models import model as M
    model = M.empty_model(cfg, device=device)
    named = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, shape, kind in W.leaves(dims):
            p = named[port_param_name(name)]
            if tuple(p.shape) != tuple(shape):
                raise ValueError(f"{name}: the program holds {tuple(p.shape)}"
                                 f", the benchmark makes {tuple(shape)}")
            p.copy_(W.make_leaf(name, shape, kind, seed, device))
            filled.add(port_param_name(name))
    left = sorted(set(named) - filled)
    if left:
        raise ValueError(f"parameters the benchmark does not make: {left}")
    return model


def prepare(model, cfg, serving: Dict, calib):
    """The port's 2T preparation (partition, neuron reordering, thresholds
    calibrated to the drop target); returns the calibrated policy."""
    from repro_torch.core.policy import make_policy
    policy = make_policy(serving["policy"], cfg.dualsparse,
                         drop_target=serving["drop_target"])
    _, policy = policy.prepare(model, cfg, calib)
    return policy


def make_engine(cfg, model, policy, eng: Dict, device):
    from repro_torch.serving import ContinuousBatchingEngine, PagedEngine
    common = dict(n_slots=eng["n_slots"], max_prompt_len=eng["max_prompt_len"],
                  max_new_tokens=eng["max_new_tokens"], policy=policy,
                  device=device)
    if eng["kind"] == "paged":
        return PagedEngine(cfg, model, page_size=eng["page_size"],
                           chunk_size=eng["chunk_size"],
                           prefix_cache=eng["prefix_cache"], **common)
    if eng["kind"] == "continuous":
        return ContinuousBatchingEngine(cfg, model, **common)
    raise ValueError(f"unknown engine kind {eng['kind']!r}")


def generation(n_out: int):
    """Greedy decoding of ``n_out`` tokens, no early stop."""
    from repro_torch.serving import GenerationConfig
    return GenerationConfig(max_new_tokens=n_out, temperature=0.0,
                            eos_token=-1)


def counters(engine) -> Dict[str, float]:
    """The engine's counters now: the MoE sub-pair outcomes (read from
    the device once), the paged engine's prefix-cache lookups and
    prefilled prompt tokens."""
    snap = engine.metrics()
    out = {}
    for outcome in ("kept_full", "kept_major", "dropped", "overflow"):
        out[outcome] = snap.counters.get(
            f'repro_moe_subpairs_total{{outcome="{outcome}"}}', 0.0)
    for name in ("prefix_hits", "prefix_misses", "prefill_tokens"):
        if hasattr(engine, name):
            out[name] = float(getattr(engine, name))
    return out


def spans(engine) -> List[tuple]:
    """(name, start s, duration s, args) of the engine's spans since its
    tracer was last cleared."""
    return [(ev["name"], ev["ts"] / 1e6, ev["dur"] / 1e6, ev["args"])
            for ev in engine.tracer.events() if ev["ph"] == "X"]


@dataclasses.dataclass
class FusedCall:
    """One call into the fused MoE kernel: its shapes and the routing
    outcome it was handed, per ORIGINAL expert."""
    n_tokens: int
    d: int
    f_sub: int
    p_factor: int
    n_pos: int
    elem_bytes: int
    counts_full: torch.Tensor
    counts_major: torch.Tensor


@contextlib.contextmanager
def fused_calls(into: List[FusedCall]):
    """Record every call into ``kernels.ops.fused_moe_pipeline`` while the
    context is open (device-side copies of the counts, no read-back)."""
    from repro_torch.kernels import ops
    orig = ops.fused_moe_pipeline

    sig = inspect.signature(orig)

    def probe(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        x, w1 = a["x"], a["w1"]
        into.append(FusedCall(
            n_tokens=x.shape[0], d=x.shape[1], f_sub=w1.shape[-1],
            p_factor=int(a["p_factor"]), n_pos=a["tok_sorted"].shape[0],
            elem_bytes=x.element_size(),
            counts_full=a["counts_full"].clone(),
            counts_major=a["counts_major"].clone()))
        return orig(*args, **kw)
    # the wrapper counts its launches on its own function attributes
    probe.__dict__.update(orig.__dict__)
    ops.fused_moe_pipeline = probe
    try:
        yield into
    finally:
        orig.__dict__.update(probe.__dict__)
        ops.fused_moe_pipeline = orig
