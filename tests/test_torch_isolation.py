"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points that
default to the card raise — rather than fall back to the CPU — when no
CUDA device is available."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_package_found():
    assert len(PORT_FILES) > 20
    for name in ("fused_moe_pipeline.cu", "grouped_swiglu.cu",
                 "swiglu_tiles.cuh"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / name).exists()


def test_ep_and_mla_modules_are_checked():
    """The S-ETP / ETP modules, the EP context and MLA's config are among
    the files checked above."""
    port = ROOT / "src" / "repro_torch"
    for rel in ("core/setp.py", "distributed/__init__.py",
                "distributed/context.py", "distributed/sharding.py",
                "configs/minicpm3_4b.py", "models/attention.py"):
        assert port / rel in PORT_FILES, rel


def test_training_modules_are_checked():
    """The optimizer, checkpoint IO and the train CLI are among the files
    checked above."""
    port = ROOT / "src" / "repro_torch"
    for rel in ("optim/__init__.py", "optim/adamw.py", "checkpoint/io.py",
                "checkpoint/from_numpy.py", "launch/train.py",
                "data/pipeline.py"):
        assert port / rel in PORT_FILES, rel


def test_examples_are_checked():
    """The three walkthroughs are among the files checked above."""
    port = ROOT / "src" / "repro_torch"
    for rel in ("examples/__init__.py", "examples/quickstart.py",
                "examples/serve_dualsparse.py",
                "examples/finetune_partitioned.py"):
        assert port / rel in PORT_FILES, rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import calibration_activations
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as TT
    from repro_torch.obs import MetricsState
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig, PagedEngine,
                                     ServingEngine)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_paged_cache(cfg, 4, 4, 1)
    mla = get_config("minicpm3-4b").reduced()
    for helper in (lambda: TT.init_cache(cfg, 1, 8),
                   lambda: TT.init_cache(mla, 1, 8),
                   lambda: TT.init_paged_cache(cfg, 4, 4, 1),
                   lambda: MetricsState.zeros(1, 4),
                   lambda: calibration_activations(
                       np.random.default_rng(0), 4, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            helper()
    model = M.init_params(cfg, device="cpu")
    for engine in (ServingEngine, ContinuousBatchingEngine, PagedEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    for engine in (ServingEngine, ContinuousBatchingEngine, PagedEngine):
        eng = engine(cfg, model, device="cpu", max_prompt_len=4,
                     max_new_tokens=2)
        out = eng.generate([np.arange(4)], GenerationConfig(max_new_tokens=2))
        assert len(out[0].tokens) == 2


def test_kernel_wrapper_has_no_fallback():
    """A tensor on a device without a kernel is refused, never routed to
    the plain version."""
    from repro_torch.kernels import ops
    x = torch.zeros((2, 4), device="meta")
    w = torch.zeros((2, 4, 4), device="meta")
    i = torch.zeros((2,), dtype=torch.int32, device="meta")
    calls = ops.fused_moe_pipeline_ref.calls
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_moe_pipeline(x, w, w, w, i, i, i,
                               torch.zeros((4,), dtype=torch.int32,
                                           device="meta"),
                               torch.zeros((4,), device="meta"),
                               capacity=2, p_factor=1)
    assert ops.fused_moe_pipeline_ref.calls == calls
    calls = ops.grouped_swiglu_ref.calls
    with pytest.raises(ValueError, match="no kernel"):
        ops.grouped_swiglu(torch.zeros((2, 3, 4), device="meta"), w, w, w,
                           i, i)
    assert ops.grouped_swiglu_ref.calls == calls


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_train_cli_defaults_to_the_card(no_cuda):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("name", ["quickstart", "serve_dualsparse",
                                  "finetune_partitioned"])
def test_examples_default_to_the_card(no_cuda, name):
    """Each walkthrough raises without CUDA, before building a model,
    unless ``--device cpu`` is given."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
