#!/usr/bin/env python3
"""MLA's absorbed attention over the paged latent pool
(``kernels.ops.mla_latent_attend``) on the card at the DeepSeek-V2-Lite doc
cell's shapes, against its plain version, each case beside its bound:
``chip_smoke.py``'s phase 2d on its own (the cases and bounds:
``chip_smoke.mla_attend_case``):

* ``decode``: one decode step of the cell's 32 slots over 5120 positions:
  7 live slots at positions 4160-4700, the other 25 retired on page 0;
* ``chunk_0`` / ``chunk_4096``: a 256-row prompt chunk over 4608
  positions, at start 0 and at start 4096 (the document's last chunk).

Runs from any checkout's root with that checkout's kernels:

    python3 tools/mla_attend_shapes.py [--cases decode,chunk_0]

Prints the library's ptxas report when this process built it, one line per
case and, last, the results as one JSON line. Fails when a case disagrees
with the plain version.
"""
import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("mla_attend_shapes: no CUDA device is visible", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(cs.MLA_CASES))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; tree {ROOT}", flush=True)
    _build.load("mla_latent_attend")
    for line in _build.BUILD_LOG.get("mla_latent_attend", "").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  ptxas: " + line.strip(), flush=True)
    out = cs.mla_attend_phase(torch.device("cuda"), args.cases.split(","))
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), cases=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
