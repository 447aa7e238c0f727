"""Fused PoDR2 batch verification — the port's main path.

One device program per chunk of CHUNK proofs (the JAX package's
proof/fused.py `_verify_chunk_device`):

  u words ──unpack──► SSWU map (K1, with K4) ──► GLV fold (K2: cofactor
  clear → φ table → 64-step ladder) ──gather/mask──► per-proof tree
  reduce ──┐
  σ limbs ─┴► one ladder launch (K3) over [ρ]·inner ‖ [ρ]·σ ‖ [r]·σ ──►
           lhs/rhs partials + the σ subgroup mask
  μ words ──unpack──► ρ-weighted Fr combine ──► exponent partials

Chunk partials accumulate on the device; one final pull (two points +
s exponents), the u-side fold (K2, clear=False) and two host pairings
decide the batch.  The three ladders of the JAX program — the 128-bit ρ
folds and the 255-bit [r] chain — run as one K3 launch at 255 bits: a
ρ < 2^128 leaves the accumulator at (0 : 1 : 0) mod p through its
leading zero bits, so every coordinate equals the separate ladders' mod
p, and the card runs one pass of 255 steps instead of three passes.

Host preparation of chunk k+1 (the native XMD hashing, which releases
the GIL, limb packing, lane maps) runs on a one-worker prefetch thread
while chunk k's kernels run; every chunk is padded to CHUNK proofs so
the kernels see one shape.

Verdicts are bit-identical to the host reference (ops/podr2.py
batch_verify): same ρ transcript, same zip-truncation semantics, same
rejection set (bad σ encodings and non-subgroup σ reject the batch).
"""

from __future__ import annotations

import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import bls12_381 as bls
from ..ops import fr, g1, glv, h2c, podr2
from ..ops.bls12_381 import G1Point, G2Point, R
from ..ops.podr2 import Podr2Params
from . import frontend

# Proofs per device program: every chunk pads to it, so the kernels see
# one shape per challenge geometry.
CHUNK = 1024

_PREP_POOL: ThreadPoolExecutor | None = None
_PREP_POOL_LOCK = threading.Lock()


def _prep_pool() -> ThreadPoolExecutor:
    global _PREP_POOL
    with _PREP_POOL_LOCK:
        if _PREP_POOL is None:
            _PREP_POOL = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fused-prep"
            )
    return _PREP_POOL


# ------------------------------------------------------------ host packing


def pack_u_words(u_be: np.ndarray) -> np.ndarray:
    """(N, 2, 48) big-endian field bytes → (N, 2, 12) uint32 words."""
    le = u_be[..., ::-1].copy()
    return le.view("<u4").reshape(u_be.shape[0], 2, 12)


def pack_points_limbs(points: list[G1Point]) -> tuple[np.ndarray, ...]:
    """Host points → (33, N) int32 limb triples, ∞ = (0 : 1 : 0)."""
    n = len(points)
    raw = bytearray(n * 2 * 48)
    zs = np.zeros((n,), dtype=np.int32)
    for i, p in enumerate(points):
        if p.is_infinity():
            continue
        raw[i * 96 : i * 96 + 48] = p.x.to_bytes(48, "big")
        raw[i * 96 + 48 : i * 96 + 96] = p.y.to_bytes(48, "big")
        zs[i] = 1
    be = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(n, 2, 48)
    limbs = h2c.u_bytes_to_limbs(be)  # (33, n, 2)
    X = np.ascontiguousarray(limbs[:, :, 0])
    Y = np.where(zs[None, :] == 1, limbs[:, :, 1], 0).astype(np.int32)
    Y[0] = np.where(zs == 1, Y[0], 1)
    Z = np.zeros_like(X)
    Z[0] = zs
    return X, Y, Z


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → device tensor; uint32 words travel as int32 bit patterns,
    through pinned memory on CUDA so the copy does not wait on the
    stream's earlier kernels."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ------------------------------------------------------------ device unpack


def _words_to_limbs(words: torch.Tensor, limb_bits: int, nlimbs: int):
    """(…, W) uint32 words carried as int32 → (nlimbs, …) int32 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    nwords = w.shape[-1]
    rows = []
    for i in range(nlimbs):
        wi, sh = divmod(limb_bits * i, 32)
        if wi >= nwords:
            rows.append(torch.zeros_like(w[..., 0]))
            continue
        val = w[..., wi] >> sh
        if sh + limb_bits > 32 and wi + 1 < nwords:
            val = val | (w[..., wi + 1] << (32 - sh))
        rows.append(val & ((1 << limb_bits) - 1))
    return torch.stack(rows).to(torch.int32)


def _u_words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(N, 2, 12) u words → (33, 2, N) int32 base-4096 limbs."""
    return _words_to_limbs(words, g1.LIMB_BITS, g1.L).transpose(1, 2).contiguous()


def _mu_words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(B, S, 8) μ words → (B, S, 37) int8 base-128 limbs."""
    return _words_to_limbs(words, fr.LIMB_BITS, fr.NLIMBS).permute(1, 2, 0).to(
        torch.int8
    )


def _flag_bits(flags: torch.Tensor):
    f = flags.to(torch.int32)
    sgn = torch.stack([f & 1, (f >> 2) & 1])
    exc = torch.stack([(f >> 1) & 1, (f >> 3) & 1])
    return sgn, exc


# ------------------------------------------------------------ device chunk


def _tree_reduce_last(points):
    """Σ over the last axis, padded to a power of two with identity
    points (0 : 1 : 0) first — pairwise halving drops lanes on odd
    lengths, so a 3-chunk batch must never reach it unpadded."""
    X, Y, Z = points
    n = X.shape[-1]
    npow = 1 << max(0, (n - 1).bit_length())
    if npow != n:
        pad = (0, npow - n)
        X = torch.nn.functional.pad(X, pad)
        Z = torch.nn.functional.pad(Z, pad)
        Y = torch.nn.functional.pad(Y, pad)
        Y[0, ..., n:] = 1
    return g1.tree_reduce((X, Y, Z), npow)


def _group_reduce(a, lane_map, lane_mask):
    """Gather lanes into per-proof groups (dead slots → ∞) and sum each."""
    aX, aY, aZ = a
    B, G = lane_map.shape
    flat = lane_map.reshape(-1).long()
    m = (lane_mask.reshape(-1) == 1).unsqueeze(0)
    zero = torch.zeros((), dtype=torch.int32, device=aX.device)
    gX = torch.where(m, aX[:, flat], zero)
    gY = torch.where(m, aY[:, flat], g1.limb_one(aY[:, flat]))
    gZ = torch.where(m, aZ[:, flat], zero)
    return g1.tree_reduce(tuple(t.reshape(g1.L, B, G) for t in (gX, gY, gZ)), G)


def _verify_chunk_device(
    u_words, flags, v_k1, v_k2, lane_map, lane_mask,
    sX, sY, sZ, rho_digits, rho_i8, mu_words,
):
    """One chunk's group computation on the inputs' device.

    u_words (Np, 2, 12) words; flags (Np,) XMD predicate bits; v_k1/v_k2
    (12, Np) GLV digit halves of each lane's coefficient; lane_map /
    lane_mask (B, G) gather map from lanes to per-proof groups; sX/sY/sZ
    (33, B) σ limbs; rho_digits (22, B) ladder digits; rho_i8 (B, 19) fr
    limbs; mu_words (B, S, 8).  Returns partial lhs/rhs triples (33,),
    exps (S, 37) and the σ subgroup mask (B,)."""
    B = lane_map.shape[0]
    sgn, exc = _flag_bits(flags)
    hX, hY, hZ = h2c._map_pairs_kernel(_u_words_to_limbs(u_words), sgn, exc)
    acc = glv.glv_fold(hX, hY, hZ, v_k1, v_k2, clear=True)
    inner = _group_reduce(acc, lane_map, lane_mask)

    # one K3 launch: [ρ]·inner ‖ [ρ]·σ ‖ [r]·σ
    pts = tuple(torch.cat([i, s, s], dim=1) for i, s in zip(inner, (sX, sY, sZ)))
    scal = torch.cat([rho_digits, rho_digits, glv.r_scalars(B, sX.device)], dim=1)
    lX, lY, lZ = g1.scalar_mul_ladder(pts, scal, bits=g1.SCALAR_BITS)
    rhs = _tree_reduce_last((lX[:, None, :B], lY[:, None, :B], lZ[:, None, :B]))
    lhs = _tree_reduce_last(
        (lX[:, None, B : 2 * B], lY[:, None, B : 2 * B], lZ[:, None, B : 2 * B])
    )
    mask = h2c._is_zero_mod_p(lZ[:, 2 * B :]).to(torch.int32)

    # u-side exponents: Σ_b ρ_b μ_bj
    mu_limbs = _mu_words_to_limbs(mu_words)  # (B, S, 37)
    exps = fr.weighted_sum_kernel(rho_i8, mu_limbs.transpose(0, 1))  # (S, 37)
    return (
        tuple(t[..., 0] for t in lhs),
        tuple(t[..., 0] for t in rhs),
        exps,
        mask,
    )


def _accumulate_points(stackX, stackY, stackZ):
    """(33, K) chunk partials → one projective total."""
    return _tree_reduce_last(tuple(a[:, None, :] for a in (stackX, stackY, stackZ)))


def _finalize_exps(parts: torch.Tensor) -> torch.Tensor:
    """(K, S, 37) canonical chunk partials → (S, 37) canonical total."""
    total = parts.to(torch.int32).sum(dim=0, dtype=torch.int32)
    total = fr._normalize(fr._pad_last(total, 3))
    return fr._fold_to_canonical(total)


# ------------------------------------------------------------ GLV cache


@lru_cache(maxsize=1 << 14)
def _v_digits(v: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-coefficient GLV digit rows (cached — a round shares its
    coefficients across every proof)."""
    k1, k2 = glv.decompose_to_limbs([v])
    return k1[:, 0], k2[:, 0]


# ------------------------------------------------------------ pipeline


@dataclass
class _ChunkOut:
    lhs: tuple
    rhs: tuple
    exps: torch.Tensor
    mask: torch.Tensor


# The port needs no autograd: inference mode skips its per-op bookkeeping,
# about a third of a check's time where the plain twins run on the CPU
# (on the card, where each small op costs a launch, no change was seen).
@torch.inference_mode()
def combined_check_fused(
    pk: bytes,
    items: list,
    seed: bytes,
    params: Podr2Params,
    stages: dict | None = None,
    device="cuda",
) -> bool:
    """One combined pairing check over `items` (podr2.batch_verify
    semantics): empty → True; undecodable pk or σ, wrong μ width,
    out-of-range μ, or a σ outside the r-order subgroup → False;
    otherwise the combined equation decides.  `stages` accumulates
    wall seconds per stage (host_prep, chunk_program, dispatch_wait,
    u_fold, pairing), and every mark is observed into the process-wide
    `cess_proof_stage_*` histograms; a check that reaches its device
    program also bumps the `cess_proof*` counters (proof/torch_backend.py,
    as cess_tpu/proof/fused.py does)."""
    if not items:
        return True
    from .torch_backend import (
        STAGE_METRICS_ENABLED,
        _observe_stage,
        _stage_counters,
        proof_stage_registry,
    )

    device = torch.device(device)
    metered = STAGE_METRICS_ENABLED

    def mark(name, t0):
        if not metered and stages is None:
            return t0
        now = _time.perf_counter()
        if stages is not None:
            stages[name] = stages.get(name, 0.0) + (now - t0)
        if metered:
            _observe_stage(name, now - t0)
        return now

    check_t0 = _time.perf_counter()
    t0 = check_t0
    try:
        pk_point = G2Point.from_bytes(pk)
    except ValueError:
        return False
    sigmas = frontend.decompress_sigmas(items)
    if sigmas is None:
        return False
    if any(len(p.mu) != params.s for _, _, p in items):
        return False
    encs = frontend.encode_proofs(items)
    if encs is None:
        return False
    mu_w = frontend.mu_words(encs, params.s)
    if not frontend.mu_in_range(mu_w):
        return False
    batch_items = [podr2.BatchItem(n, c, p) for n, c, p in items]
    rhos = podr2.batch_rho(
        podr2.batch_transcript(seed, batch_items, encodings=encs), len(items)
    )

    chunk = CHUNK
    counts_all = [min(len(ch.indices), len(ch.randoms)) for _, ch, _ in items]
    cnt_max = max(counts_all)
    g = 1 << max(0, (cnt_max - 1).bit_length())
    pad_lanes = max(chunk * cnt_max, 1)
    spans = list(range(0, len(items), chunk))

    def prep(start):
        return _prep_chunk(
            items[start : start + chunk],
            sigmas[start : start + chunk],
            rhos[start : start + chunk],
            mu_w[start : start + chunk],
            counts_all[start : start + chunk],
            params, chunk, pad_lanes, g,
        )

    outs: list[_ChunkOut] = []
    pool = _prep_pool()
    fut = pool.submit(prep, spans[0])
    for si in range(len(spans)):
        host_in = fut.result()
        t0 = mark("host_prep", t0)
        if si + 1 < len(spans):
            fut = pool.submit(prep, spans[si + 1])
        outs.append(_launch_chunk(host_in, device))
        t0 = mark("chunk_program", t0)

    lhs = _accumulate_points(*(torch.stack([o.lhs[c] for o in outs], -1) for c in range(3)))
    rhs = _accumulate_points(*(torch.stack([o.rhs[c] for o in outs], -1) for c in range(3)))
    exps = _finalize_exps(torch.stack([o.exps for o in outs]))
    masks = torch.cat([o.mask for o in outs])
    t0 = mark("chunk_program", t0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ok = bool((masks == 1).all())
    t0 = mark("dispatch_wait", t0)

    if not ok:
        verdict = False
    else:
        lhs_pt = g1.projective_to_points(*(a.reshape(1, -1) for a in lhs))[0]
        rhs_pt = g1.projective_to_points(*(a.reshape(1, -1) for a in rhs))[0]
        exps_ints = fr.limbs_to_ints(exps)
        us = list(podr2.u_generators(params.s))
        rhs_pt = rhs_pt + _u_fold(us, exps_ints, device)
        t0 = mark("u_fold", t0)
        verdict = bls.pairing_check([(lhs_pt, -bls.G2_GENERATOR), (rhs_pt, pk_point)])
        mark("pairing", t0)
    if metered:
        proof_stage_registry()
        _stage_counters["checks"].inc()
        _stage_counters["proofs"].inc(len(items))
        _stage_counters["seconds"].inc(_time.perf_counter() - check_t0)
    return verdict


def _u_fold(us: list[G1Point], exps: list[int], device) -> G1Point:
    """Π u_j^{e_j} over the sector generators through K2 (clear=False:
    the generators are in the subgroup)."""
    device = torch.device(device)
    X, Y, Z = pack_points_limbs(us)
    k1 = np.zeros((glv.K_LIMBS, len(us)), dtype=np.int32)
    k2 = np.zeros((glv.K_LIMBS, len(us)), dtype=np.int32)
    for j, e in enumerate(exps):
        k1[:, j], k2[:, j] = _v_digits(int(e) % R)
    a = glv.glv_fold(*(_to_device(t, device) for t in (X, Y, Z, k1, k2)), clear=False)
    tX, tY, tZ = _accumulate_points(*a)
    return g1.projective_to_points(*(t.reshape(1, -1) for t in (tX, tY, tZ)))[0]


def _prep_chunk(sub, sigmas, rhos, mu_w, counts, params, pad_b: int,
                pad_lanes: int, g: int):
    """Pack one chunk's device inputs on the host (runs on the prefetch
    worker while the previous chunk's kernels execute)."""
    B = len(sub)
    n_pairs = sum(counts)
    name_ids = np.repeat(np.arange(B, dtype=np.uint32), counts)
    indices = np.concatenate(
        [np.asarray(ch.indices[:c], dtype=np.uint64) for (_, ch, _), c in zip(sub, counts)]
    ) if n_pairs else np.zeros((0,), dtype=np.uint64)
    u, flags = _xmd_u([name for name, _, _ in sub], name_ids, indices)
    u_words = np.zeros((pad_lanes, 2, 12), dtype=np.uint32)
    u_words[:n_pairs] = pack_u_words(u)
    fl = np.zeros((pad_lanes,), dtype=np.int32)
    fl[:n_pairs] = flags

    v_k1, v_k2, lane_map, lane_mask = _lane_scalars(sub, counts, pad_lanes, pad_b, g)

    # pad the proof axis with (σ = ∞, ρ = 0, μ = 0): every fold treats
    # them as identity and [r]∞ = ∞ passes the mask
    sX, sY, sZ = pack_points_limbs(sigmas + [G1Point.infinity()] * (pad_b - B))
    rho_digits = np.zeros((g1.R_LIMBS, pad_b), dtype=np.int32)
    rho_digits[:, :B] = frontend.rho_digits(rhos)
    rho_i8 = np.zeros((pad_b, 19), dtype=np.int8)
    rho_i8[:B] = frontend.rho_limbs7(rhos)
    mu_words = np.zeros((pad_b, params.s, 8), dtype=np.uint32)
    mu_words[:B] = mu_w
    return (
        u_words, fl, v_k1, v_k2, lane_map, lane_mask,
        sX, sY, sZ, rho_digits, rho_i8, mu_words,
    )


def _launch_chunk(host_in, device) -> _ChunkOut:
    """Upload one prepped chunk and enqueue its kernels (asynchronous on
    CUDA: the caller's next prep overlaps this chunk's device work)."""
    lhs, rhs, exps, mask = _verify_chunk_device(
        *(_to_device(a, device) for a in host_in)
    )
    return _ChunkOut(lhs, rhs, exps, mask)


def _lane_scalars(sub, counts, npad: int, Bp: int, g: int):
    """Per-lane GLV digit arrays + the lane→group gather map (a uniform
    challenge takes a tiled fast path)."""
    B = len(sub)
    v_k1 = np.zeros((glv.K_LIMBS, npad), dtype=np.int32)
    v_k2 = np.zeros((glv.K_LIMBS, npad), dtype=np.int32)
    lane_map = np.zeros((Bp, g), dtype=np.int32)
    lane_mask = np.zeros((Bp, g), dtype=np.int32)
    first_ch = sub[0][1] if sub else None
    if B > 1 and all(it[1] is first_ch for it in sub):
        cnt = counts[0]
        coeffs = first_ch.coefficients()[:cnt]
        n_pairs = cnt * B
        v_k1[:, :n_pairs] = np.tile(np.stack([_v_digits(v)[0] for v in coeffs], 1), B)
        v_k2[:, :n_pairs] = np.tile(np.stack([_v_digits(v)[1] for v in coeffs], 1), B)
        lane_map[:B, :cnt] = (
            np.arange(B, dtype=np.int32)[:, None] * cnt
            + np.arange(cnt, dtype=np.int32)[None]
        )
        lane_mask[:B, :cnt] = 1
        return v_k1, v_k2, lane_map, lane_mask
    pos = 0
    for b, ((_, ch, _), cnt) in enumerate(zip(sub, counts)):
        for k, v in enumerate(ch.coefficients()[:cnt]):
            v_k1[:, pos + k], v_k2[:, pos + k] = _v_digits(v)
            lane_map[b, k] = pos + k
            lane_mask[b, k] = 1
        pos += cnt
    return v_k1, v_k2, lane_map, lane_mask


def _craft_device(u_words, flags, k1, k2, lane_map, lane_mask):
    """Per-group Π H^{s_c} over freshly hashed chunk points (the device
    form of σ-tag aggregation: K1, K2, gather, tree reduce)."""
    sgn, exc = _flag_bits(flags)
    hX, hY, hZ = h2c._map_pairs_kernel(_u_words_to_limbs(u_words), sgn, exc)
    acc = glv.glv_fold(hX, hY, hZ, k1, k2, clear=True)
    return _group_reduce(acc, lane_map, lane_mask)


@torch.inference_mode()
def craft_sigmas(names: list[bytes], challenge, scalars: list[int],
                 device="cuda") -> list[G1Point]:
    """Π_c H(name‖i_c)^{s_c} for every name under one challenge, on the
    device (s_c = sk·v_c mod r crafts valid zero-data proofs)."""
    device = torch.device(device)
    B = len(names)
    Bp = 1 << max(0, (B - 1).bit_length())
    cnt = min(len(challenge.indices), len(challenge.randoms))
    n_pairs = B * cnt
    npad = max(n_pairs, 1)

    name_ids = np.repeat(np.arange(B, dtype=np.uint32), cnt)
    indices = np.tile(np.asarray(challenge.indices[:cnt], dtype=np.uint64), B)
    u, flags = _xmd_u(names, name_ids, indices)
    u_words = np.zeros((npad, 2, 12), dtype=np.uint32)
    u_words[:n_pairs] = pack_u_words(u)
    fl = np.zeros((npad,), dtype=np.int32)
    fl[:n_pairs] = flags

    k1 = np.zeros((glv.K_LIMBS, npad), dtype=np.int32)
    k2 = np.zeros((glv.K_LIMBS, npad), dtype=np.int32)
    k1[:, :n_pairs] = np.tile(np.stack([_v_digits(s % R)[0] for s in scalars[:cnt]], 1), B)
    k2[:, :n_pairs] = np.tile(np.stack([_v_digits(s % R)[1] for s in scalars[:cnt]], 1), B)

    g = 1 << max(0, (cnt - 1).bit_length())
    lane_map = np.zeros((Bp, g), dtype=np.int32)
    lane_mask = np.zeros((Bp, g), dtype=np.int32)
    lane_map[:B, :cnt] = (
        np.arange(B, dtype=np.int32)[:, None] * cnt
        + np.arange(cnt, dtype=np.int32)[None]
    )
    lane_mask[:B, :cnt] = 1

    sX, sY, sZ = _craft_device(
        *(_to_device(a, device) for a in (u_words, fl, k1, k2, lane_map, lane_mask))
    )
    return g1.projective_to_points(sX.T[:B], sY.T[:B], sZ.T[:B])


def _xmd_u(names, name_ids, indices):
    """Host expand_message_xmd batch (native, 8 threads: `h2c.xmd_u`)."""
    if len(name_ids) == 0:
        return np.zeros((0, 2, 48), dtype=np.uint8), np.zeros((0,), dtype=np.uint8)
    return h2c.xmd_u(names, name_ids, indices, podr2.H_DST, threads=8)
