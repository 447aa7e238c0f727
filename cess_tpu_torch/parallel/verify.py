"""Sharded audit-round data plane over a mesh of torch devices.

The port of `cess_tpu/parallel/verify.py`.  A `Mesh` is one process over
a tuple of torch devices, as a `jax.sharding.Mesh` is one controller over
its devices: there is no process group and no collective library.  Each
meshed function splits its batch axis into `mesh.size` equal contiguous
shards, runs the unmeshed kernel on each shard on that shard's device,
and sums the partials on `mesh.devices[0]` (the `psum`):

  stage 1 (μ):       every proof's μ_j = Σ_c v_c·m_{c,j} — batch-sharded,
                     no reduction;
  stage 2 (combine): e_j = Σ_b ρ_b·μ_{b,j} — each rank combines its
                     shard, the (S, 37) partials are added on the first
                     device and re-canonicalized there.

Every mesh size, one included, goes through the shard and partial-sum
code, so the result equals the unmeshed kernel's bit for bit
(tests/test_torch_parallel.py holds it to cess_tpu's).  Repeated devices
are allowed: eight ranks on the one CPU device are how the tests build
the reference's virtual eight-device mesh, four ranks on one card how
chip_smoke.py checks the sharding there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import fr


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the batch axis: one rank per entry of `devices`
    (repeats allowed), all of one device type."""

    devices: tuple[torch.device, ...]

    def __post_init__(self) -> None:
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds one device type, got {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def require_type(self, device) -> None:
        """Raise unless `device` is of the mesh's device type: the
        meshed callers never move work between the card and the host."""
        kind = torch.device(device).type
        if kind != self.devices[0].type:
            raise ValueError(
                f"a {self.devices[0].type} mesh cannot serve a {kind} device"
            )

    def shards(self, n: int) -> list[slice]:
        """The ranks' equal contiguous slices of a batch axis of n."""
        if n % self.size:
            raise ValueError(
                f"batch of {n} does not divide over {self.size} ranks "
                "(pad it first: pad_batch_rows)"
            )
        per = n // self.size
        return [slice(r * per, (r + 1) * per) for r in range(self.size)]


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh over the proof-batch axis.  device=None means the card:
    cuda:0 … cuda:n-1, n defaulting to every visible card (more than
    there are raises, as mesh_utils.create_device_mesh does); "cpu"
    gives n ranks on the CPU device (default 1)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"cannot build a mesh of {n} from {count} cards")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"cannot build a mesh of {n} ranks")
    return Mesh((dev,) * n)


def pad_batch_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad the leading (batch) axis up to a multiple — the host
    staging step every sharded entry point needs (ρ=0 / μ=0 rows are
    combine-inert, so the padded result is bit-identical)."""
    pad = (-arr.shape[0]) % multiple
    if not pad:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)]
    )


def _psum_canonical(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """Add the ranks' canonical (S, 37) partials on the first device
    (limbs ≤ 127 · ranks) and re-canonicalize there."""
    root = mesh.devices[0]
    total = parts[0].to(root)
    for p in parts[1:]:
        total = total + p.to(root)
    return fr._fold_to_canonical(fr._normalize(fr._pad_last(total, 3)))


@torch.inference_mode()
def combine_mu_sharded(
    mesh: Mesh, rho_limbs: np.ndarray, mu_limbs: np.ndarray
) -> np.ndarray:
    """Σ_b ρ_b·μ_b mod r with the batch axis sharded over the mesh.

    rho_limbs: (B, Lw) int8;  mu_limbs: (B, S, Lm) int8.
    B must divide by the mesh size (pad with ρ=0 rows host-side).
    Returns (S, NLIMBS) canonical int32 limbs."""
    rho = np.asarray(rho_limbs)
    mu = np.asarray(mu_limbs)
    if rho.shape[0] != mu.shape[0]:
        raise ValueError("rho/mu batch length mismatch")
    parts = []
    for dev, sl in zip(mesh.devices, mesh.shards(rho.shape[0])):
        w = torch.as_tensor(rho[sl], device=dev)
        v = torch.as_tensor(np.ascontiguousarray(np.moveaxis(mu[sl], 0, -2)), device=dev)
        parts.append(fr.weighted_sum_kernel(w, v))
    return _psum_canonical(mesh, parts).cpu().numpy()


def audit_data_plane_step(mesh: Mesh):
    """The multi-rank audit step.

    Returns fn(v_limbs (C, Lv), sector_limbs (B, C, S, Lm) [sharded on B],
    rho_limbs (B, Lw) [sharded on B]) → (μ (B, S, 37), combined (S, 37)),
    numpy int32.  Each rank computes μ for its proofs, recasts it to int8
    (canonical limbs are < 128, so the recast is lossless) and contracts
    it with its ρ; the partials are summed and re-canonicalized."""

    @torch.inference_mode()
    def step(v_limbs, sector_limbs, rho_limbs):
        sectors = np.asarray(sector_limbs)
        rho = np.asarray(rho_limbs)
        if rho.shape[0] != sectors.shape[0]:
            raise ValueError("rho/sector batch length mismatch")
        # one upload of v per distinct device: ranks on one card share it
        v_limbs = np.asarray(v_limbs)
        v_on = {d: torch.as_tensor(v_limbs, device=d) for d in dict.fromkeys(mesh.devices)}
        mus, parts = [], []
        for dev, sl in zip(mesh.devices, mesh.shards(sectors.shape[0])):
            sec = np.ascontiguousarray(np.moveaxis(sectors[sl], 1, -2))
            mu = fr.weighted_sum_kernel(v_on[dev], torch.as_tensor(sec, device=dev))
            w = torch.as_tensor(rho[sl], device=dev)
            parts.append(fr.weighted_sum_kernel(w, mu.to(torch.int8).movedim(0, -2)))
            mus.append(mu)
        combined = _psum_canonical(mesh, parts)
        # every rank is enqueued before the one pull of μ to the host
        mu_all = torch.cat([m.to(mesh.devices[0]) for m in mus])
        return mu_all.cpu().numpy(), combined.cpu().numpy()

    return step
