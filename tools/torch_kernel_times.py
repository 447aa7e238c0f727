"""Time the PyTorch/CUDA port's kernels at the main path's shapes, for one
checkout of the repo.

    python3 tools/torch_kernel_times.py [ROOT]   # ROOT: a checkout (default: this one)

Imports `cess_tpu_torch` from ROOT (its kernels build into ROOT's own
build directory), builds the inputs and the launch calls with this
repo's chip_smoke.py (`kernel_inputs`, `kernel_calls`, `_time_ms`), so it
times exactly what the smoke's phase 1 times, and prints one JSON line:
the card and its power limit, ROOT, and each call's mean time over REPS
launches after a warm-up (CUDA events).  K3 is timed on the verify
chunk's launch (`K3`), on prove_batch's (`K3_prove`) and on the first
lanes of prove_batch's for each count in K3_LANES, where a launcher that
picks its thread mapping by lane count changes mapping.  To compare two
trees, run them in turns in one call on one card (old, new, new, old).
Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPS = 10
K3_LANES = (6144, 12288, 24576, 49152)


def main() -> None:
    here = Path(__file__).resolve().parents[1]
    root = Path(sys.argv[1]) if len(sys.argv) > 1 else here
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: kernel times need the card")
    spec = importlib.util.spec_from_file_location("chip_smoke", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cess_tpu_torch.ops import _cuda, g1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _cuda.build()
    _cuda.load_all()
    inp = smoke.kernel_inputs(torch, torch.device("cuda:0"))
    calls = smoke.kernel_calls(inp)
    (X, Y, Z), s, bits = inp["K3_prove"]
    for m in K3_LANES:
        pts, sm = (X[:, :m], Y[:, :m], Z[:, :m]), s[:, :m]
        calls[f"K3_prove_{m}"] = (
            lambda pts=pts, sm=sm: g1.scalar_mul_ladder(pts, sm, bits=bits))
    ms = {name: smoke._time_ms(torch, fn, REPS) for name, fn in calls.items()}
    print(json.dumps({"root": str(root), "card": card, "reps": REPS, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
