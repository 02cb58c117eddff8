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

from . import spec
from . import weights as W

_ATTN = ("wq", "wk", "wv", "wo", "wq_a", "q_norm", "wq_b", "wkv_a",
         "kv_norm", "wk_b", "wv_b")
# the sizes in a configuration file's ``dims`` that the program's config
# must hold too, where the file gives them (others, such as
# ``first_k_dense``, which the program has no field for, are the
# harness's and the reference's alone)
PORT_DIMS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "n_experts", "top_k", "d_expert", "vocab_size", "rope_theta",
             "norm_eps", "attn_kind", "q_lora_rank", "kv_lora_rank",
             "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
             "n_shared_experts", "d_ff", "router_norm_topk")
_MOE = ("wg", "w1", "w3", "w2")
# leaf prefix -> the program's submodule of the block that holds it
_SUB = {"shared_": "moe.shared", "mlp_": "mlp"}


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
    for prefix, sub in _SUB.items():
        if leaf.startswith(prefix):
            return f"blocks.{i}.{sub}.{leaf[len(prefix):]}"
    return f"blocks.{i}.{leaf}"


def port_config(conf: Dict):
    """The program's ``ModelConfig``: its registry entry with the file's
    sizes put in. Refuses, before any weight is made, an architecture or
    policy the configuration's reference does not cover
    (``spec.uncovered``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    cfg = dataclasses.replace(get_config(conf["port"]["arch"]),
                              **conf["port"]["fields"])
    dims, serving = conf["dims"], conf["serving"]
    missing = spec.uncovered(spec.reference_module(conf), dims, serving, cfg)
    if missing:
        raise ValueError(f"{cfg.arch_id}: " + "; ".join(missing))
    # the partition the program's policy prepares (P = 1: none)
    policy = make_policy(serving["policy"], cfg.dualsparse)
    p = serving.get("partition_p", 1)
    if policy.partition_p != p or (p > 1 and policy.importance !=
                                   serving["importance"]):
        raise ValueError(f"{cfg.arch_id}: the program prepares P="
                         f"{policy.partition_p} by {policy.importance}, the "
                         f"file says P={p} by {serving.get('importance')}")
    for key in PORT_DIMS:
        if key not in dims:
            continue
        have = cfg.resolved_head_dim if key == "head_dim" else \
            getattr(cfg, key)
        if have != dims[key]:
            raise ValueError(f"{cfg.arch_id}: {key} is {have}, the file "
                             f"says {dims[key]}")
    return cfg


def build_model(cfg, dims: Dict, seed: int, device):
    """The program's model, allocated by the program and filled with the
    benchmark's seeded leaves. Every leaf's place and shape in the
    program, and every parameter's leaf, is checked before a weight is
    made."""
    from repro_torch.models import model as M
    model = M.empty_model(cfg, device=device)
    named = dict(model.named_parameters())
    todo = []
    for name, shape, kind in W.leaves(dims):
        pname = port_param_name(name)
        if pname not in named:
            raise ValueError(f"{name}: the program holds no {pname}")
        if tuple(named[pname].shape) != tuple(shape):
            raise ValueError(f"{name}: the program holds "
                             f"{tuple(named[pname].shape)}, the benchmark "
                             f"makes {tuple(shape)}")
        todo.append((pname, name, shape, kind))
    left = sorted(set(named) - {t[0] for t in todo})
    if left:
        raise ValueError(f"parameters the benchmark does not make: {left}")
    with torch.no_grad():
        for pname, name, shape, kind in todo:
            named[pname].copy_(W.make_leaf(name, shape, kind, seed, device))
    return model


def prepare(model, cfg, serving: Dict, calib):
    """The port's preparation under the file's policy (2T: partition,
    neuron reordering, thresholds calibrated to the drop target; none:
    nothing); returns the calibrated policy."""
    from repro_torch.core.policy import make_policy
    policy = make_policy(serving["policy"], cfg.dualsparse,
                         drop_target=serving.get("drop_target"))
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
