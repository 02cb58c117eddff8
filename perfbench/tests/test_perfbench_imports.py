"""The harness's import check compares whole top-level names."""
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from perfbench.harness import imports  # noqa: E402


@pytest.mark.parametrize("mods,found", [
    (["repro_torch", "repro_torch.core.moe", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.moe"], ["repro"]),
    (["jaxlib.xla_client", "jaxtyping", "flaxen"], ["jaxlib"]),
    (["jax", "flax.linen"], ["flax", "jax"]),
])
def test_forbidden_by_whole_top_level_name(mods, found):
    assert imports.forbidden_loaded(mods) == found


def test_harness_and_program_load_no_jax():
    """The harness's modules and the port import neither JAX nor the JAX
    package (checked in a fresh interpreter: this test process may hold
    them for other tests)."""
    import subprocess
    root = Path(__file__).resolve().parents[2]
    code = ("import sys; sys.path[:0] = ['.', 'src'];"
            "import perfbench.harness.cell, perfbench.harness.check;"
            "import perfbench.reference.moe_decoder;"
            "import repro_torch.serving, repro_torch.models.model;"
            "from perfbench.harness import imports;"
            "print(imports.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
