"""Finding a cell's parts by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<name>.json``), its
correctness limits (``limits/<workload>.json``), the reader of each of
its metrics (``metrics/<metric>.py``, or ``metrics/<base>.py`` for a
metric ``<base>.<suffix>``) and its configuration's plain
reference (``reference/<name>.py``, which declares what it covers).
Adding a cell, a mix, a configuration or a metric is adding files;
nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from . import weights as W

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    workload: Dict
    config: Dict            # the configuration file's contents
    traffic: Dict           # the mix, its ``extends`` chain applied
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def traffic_mix(name: str) -> Dict:
    """A mix with its ``extends`` chain applied: a mix may name another
    and give only the top-level keys it replaces."""
    mix = load_json(BENCH_DIR / "traffic" / f"{name}.json")
    seen = {name}
    while "extends" in mix:
        parent = mix.pop("extends")
        if parent in seen:
            raise ValueError(f"traffic mix {name!r}: extends loops")
        seen.add(parent)
        mix = {**load_json(BENCH_DIR / "traffic" / f"{parent}.json"), **mix}
    return mix


def cell(bench: Dict, workload: str, root: Path = ROOT) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(wl)}")
    w = wl[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        workload=w,
        config=load_json(root / conf_entry["file"]),
        traffic=traffic_mix(w["traffic"]),
        limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or, for a metric named ``<base>.<suffix>``
    (one quantity split by the cells it is read in) that has no file of
    its own, ``metrics/<base>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if path.is_file() or "." not in metric:
        return path
    return BENCH_DIR / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def reader(metric: str) -> Callable:
    """The ``read(run)`` function of the metric's file (``reader_path``)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config: Dict):
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def reference_class(config: Dict):
    return reference_module(config).Reference


# the layer-kind keys a reference has to name in ``COVERS`` to be given
# anything but their default (``weights.LAYER_KIND``); the others are
# sizes
KIND_KEYS = ("attn_kind", "n_shared_experts", "first_k_dense",
             "router_norm_topk")


def uncovered(mod, dims: Dict, serving: Dict, cfg=None) -> List[str]:
    """What a configuration asks that its reference module ``mod`` does
    not compute, one line each, naming the key. ``mod.COVERS`` maps keys
    to the values it computes: each is checked in the program's config
    ``cfg`` where that has it and, for a layer-kind key, in ``dims``
    (default ``weights.LAYER_KIND``); a ``KIND_KEYS`` key it does not
    name must hold its default; ``mod.POLICIES`` lists the serving
    policies it follows."""
    out = []
    for key, allowed in mod.COVERS.items():
        seen = []
        if cfg is not None and hasattr(cfg, key):
            seen.append(("the program's config", getattr(cfg, key)))
        if key in W.LAYER_KIND:
            seen.append(("dims", W.layer_kind(dims, key)))
        out += [f"{key} is {v!r} in {where}, {mod.__name__} covers "
                f"{list(allowed)}" for where, v in seen if v not in allowed]
    for key in KIND_KEYS:
        if key not in mod.COVERS and \
                W.layer_kind(dims, key) != W.LAYER_KIND[key]:
            out.append(f"{key} is {W.layer_kind(dims, key)!r} in dims, "
                       f"{mod.__name__} covers only "
                       f"{W.LAYER_KIND[key]!r}")
    if serving["policy"] not in mod.POLICIES:
        out.append(f"policy {serving['policy']!r}: {mod.__name__} "
                   f"follows {list(mod.POLICIES)}")
    return out
