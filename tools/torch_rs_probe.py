"""A quick check of the port's RS data plane on one card, without the
verify phases of chip_smoke.py (about 40 s of command time on an H100).

    python3 tools/torch_rs_probe.py [SEGMENTS]    # default 96

It holds RSCode and RSStream on the card against the port's gf256
reference at small shapes (both products, RS(2,1) and RS(12,4), odd
widths, tiles, slabs, grouped per-segment masks), then runs
chip_smoke.py's phase 5-rs with SEGMENTS segments in place of 640.
Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def small_checks() -> None:
    import numpy as np

    from cess_tpu_torch.ops import gf256, rs

    rng = np.random.default_rng(0)
    for path in ("gather", "bitplane"):
        for k, m in ((2, 1), (12, 4)):
            for n in (16, 100, 1021, 4096, 256):
                d = rng.integers(0, 256, (k, n), dtype=np.uint8)
                c = rs.RSCode(k, m, path=path)
                p = c.encode(d).cpu().numpy()
                assert np.array_equal(p, gf256.rs_encode_ref(d, k, m)), (path, k, m, n)
                allsh = np.concatenate([d, p])
                pres = sorted(rng.choice(k + m, size=k, replace=False).tolist())
                assert np.array_equal(c.reconstruct(allsh[pres], pres).cpu().numpy(), d)
        c = rs.RSCode(2, 1, path=path, tile=4096)
        d = rng.integers(0, 256, (2, 13500), dtype=np.uint8)
        assert np.array_equal(rs.RSStream(c).run(d), gf256.rs_encode_ref(d, 2, 1))
        b = rng.integers(0, 256, (9, 2, 700), dtype=np.uint8)
        want = np.stack([gf256.rs_encode_ref(x, 2, 1) for x in b])
        assert np.array_equal(rs.RSStream(c, slab=4).run_batch(b), want)
        k, m, nseg, n = 12, 4, 11, 129
        data = rng.integers(0, 256, (nseg, k, n), dtype=np.uint8)
        allsh = np.stack([np.concatenate([x, gf256.rs_encode_ref(x, k, m)]) for x in data])
        pats = [sorted(rng.choice(k + m, size=k, replace=False).tolist()) for _ in range(nseg)]
        surv = np.stack([allsh[i, pats[i]] for i in range(nseg)])
        code = rs.RSCode(k, m, path=path)
        assert np.array_equal(code.reconstruct_batch(surv, pats), data)
        assert np.array_equal(rs.RSStream(code, present=pats, slab=2).run_batch(surv), data)


def main() -> None:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this probe needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(sys.version, torch.__version__, torch.version.cuda, card, flush=True)
    small_checks()
    print("small checks ok", flush=True)
    chip_smoke.RS_SEGMENTS = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    t0 = time.perf_counter()
    chip_smoke.phase_rs(torch, torch.device("cuda:0"), card)
    print(f"phase 5-rs: {time.perf_counter() - t0:.3f} s", flush=True)


if __name__ == "__main__":
    main()
