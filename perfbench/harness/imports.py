"""The check that the run loaded neither JAX nor the JAX package. Names
are compared by their whole top-level part (before the first dot), so the
port (``repro_torch``) does not match the JAX package (``repro``)."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in FORBIDDEN if n in names)
