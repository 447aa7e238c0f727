"""The port's staged verify route, TorchBackend(device="cpu", fused=False)
(the counterpart of cess_tpu's XlaBackend off a TPU), against the JAX
package on the inputs of tests/test_proof_backends.py: Podr2Params(8, 4),
four fragments under the "backend-tee" key, challenge [0, 2, 5, 7].

That file holds XlaBackend's verdicts equal to CpuBackend's on exactly
these items.  XlaBackend itself is not run here: in a fresh process its
first check loads compiled ladder programs for tens of seconds, so the
port is held to cess_tpu's host references — CpuBackend's verdicts,
podr2.batch_verify for one combined check, chunk_point and the host G1
arithmetic for the device H fold — and its stage marks to the marks of
XlaBackend._combined_check, read from cess_tpu's source.  A staged check
runs four ladders as plain-tensor twins on the CPU, seconds each, so the
failing batches are decided by one combined check each (chip_smoke.py's
phase 3-staged runs the staged bisection on the card)."""

import ast
import inspect
import textwrap
from collections import Counter

import pytest
import torch

from cess_tpu.ops import bls12_381 as jbls
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.proof import CpuBackend as JaxCpuBackend
from cess_tpu.proof import xla_backend as jxla
from cess_tpu_torch.node.metrics import parse_exposition
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.ops.bls12_381 import R
from cess_tpu_torch.proof import TorchBackend, get_backend, torch_backend

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

PARAMS = podr2.Podr2Params(n=8, s=4)
JPARAMS = jpodr2.Podr2Params(n=8, s=4)
SK, PK = jpodr2.keygen(b"backend-tee")
STAGES = ("host_prep", "u_fold", "sigma_fold", "chunk_program", "pairing")


def jax_marks() -> Counter:
    """The stage marks of one staged check in cess_tpu: every
    mark("<stage>", …) call in XlaBackend._combined_check after its
    fused branch (none of them sits in a loop or a branch)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jxla.XlaBackend._combined_check)))
    return Counter(
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "mark"
        and isinstance(node.args[0], ast.Constant)
    )


def to_port(items):
    return [
        (name, podr2.Challenge(ch.indices, ch.randoms), podr2.Podr2Proof(p.sigma, list(p.mu)))
        for name, ch, p in items
    ]


def with_mu(items, at, delta):
    """items with μ_0 of each item in `at` moved by `delta` (mod r)."""
    return [
        (n, c, jpodr2.Podr2Proof(p.sigma, [(p.mu[0] + delta) % R] + list(p.mu[1:])))
        if i in at else (n, c, p)
        for i, (n, c, p) in enumerate(items)
    ]


def proof_counts() -> dict:
    fams = parse_exposition(torch_backend.proof_stage_registry().render())
    return {name: (fam.histogram()["count"] if fam.kind == "histogram" else fam.value())
            for name, fam in fams.items()}


@pytest.fixture(scope="module")
def items():
    """tests/test_proof_backends.py's `proved` items, as cess_tpu's types."""
    ch = jpodr2.Challenge(
        indices=(0, 2, 5, 7),
        randoms=tuple((b"x" + i.to_bytes(2, "little")).ljust(20, b"\x55") for i in (0, 2, 5, 7)),
    )
    out = []
    for k in range(4):
        name = f"frag-{k}".encode()
        data = bytes([(k * 37 + i) % 256 for i in range(JPARAMS.fragment_bytes)])
        tags = jpodr2.tag_fragment(SK, name, data, JPARAMS)
        out.append((name, ch, jpodr2.prove(tags, data, ch, JPARAMS)))
    return out


@pytest.fixture(scope="module")
def honest(items):
    """One staged verify_batch of the honest batch: its verdicts, its
    backend and the port registry's counts around it."""
    backend = TorchBackend(device="cpu", fused=False)
    before = proof_counts()
    verdicts = backend.verify_batch(PK, to_port(items), b"round", PARAMS)
    return verdicts, backend, before, proof_counts()


def test_honest_batch_verdicts_equal_the_jax_package(items, honest):
    assert honest[0] == JaxCpuBackend().verify_batch(PK, items, b"round", JPARAMS) == [True] * 4
    assert honest[1]._h_memo == {}  # verify_batch drops its H memo


def test_stage_seconds_keys_equal_the_jax_package(honest):
    """tests/test_proof_backends.py test_profile_stages_breakdown's set."""
    stages = honest[1].stage_seconds
    assert set(stages) == set(STAGES)
    assert all(v >= 0 for v in stages.values()) and stages["pairing"] > 0


def test_stage_histogram_counts_equal_the_jax_package(honest):
    _, _, before, after = honest
    marks = jax_marks()
    assert marks == {"host_prep": 1, "sigma_fold": 2, "u_fold": 2, "chunk_program": 1, "pairing": 1}
    for stage in torch_backend.STAGE_NAMES:
        name = f"cess_proof_stage_{stage}_seconds"
        assert after[name] - before[name] == marks[stage], stage
    assert after["cess_proof_checks"] - before["cess_proof_checks"] == 1
    assert after["cess_proofs_verified"] - before["cess_proofs_verified"] == 4
    assert after["cess_proof_verify_seconds_total"] > before["cess_proof_verify_seconds_total"]


@pytest.mark.parametrize("bad", [(2,), (0, 1, 2, 3)], ids=["one_bad_mu", "all_bad"])
def test_failing_batch_check_equals_the_host_reference(items, bad):
    """test_verify_with_one_bad's and test_verify_all_bad's batches: the
    combined check at the root of their bisection."""
    tampered = with_mu(items, bad, 1)
    seed = b"round" + (0).to_bytes(2, "little")
    ref = jpodr2.batch_verify(PK, [jpodr2.BatchItem(*it) for it in tampered], seed, s=JPARAMS.s)
    got = TorchBackend(device="cpu", fused=False)._combined_check(PK, to_port(tampered), seed, PARAMS)
    assert got is ref is False


def test_off_subgroup_sigma_gives_false(items):
    """A σ on the curve but outside the r-order subgroup passes
    decompression (its test is deferred) and fails the σ gate."""
    off = jbls.map_to_curve_g1(12345)
    assert off.is_on_curve() and not off.in_subgroup()
    name, ch, p = items[1]
    bad = [(name, ch, jpodr2.Podr2Proof(off.to_bytes(), list(p.mu)))]
    assert TorchBackend(device="cpu", fused=False).verify_batch(PK, to_port(bad), b"s", PARAMS) == \
        JaxCpuBackend().verify_batch(PK, bad, b"s", JPARAMS) == [False]


def test_empty_batch_and_early_rejections_mark_nothing(items):
    backend = get_backend("torch", device="cpu", fused=False)
    assert backend.fused is False
    assert backend.verify_batch(PK, [], b"s", PARAMS) == []
    before = proof_counts()
    wide = [(n, c, podr2.Podr2Proof(p.sigma, [R] + list(p.mu[1:]))) for n, c, p in to_port(items)]
    assert backend._combined_check(PK, wide, b"s", PARAMS) is False
    assert backend._combined_check(b"\x00" * 96, to_port(items), b"s", PARAMS) is False
    assert proof_counts() == before
    assert backend.stage_seconds == {}


def test_device_h_fold_equals_the_host_fold(items):
    """_h_inner_fold_device on the CPU twins (K1 with K4, then K3 at
    v·h_eff scalars on uncleared points) against Π_c H(name‖i_c)^{v_c}
    from cess_tpu's chunk_point."""
    backend = TorchBackend(device="cpu", fused=False)
    got = backend._h_inner_fold_device(to_port(items))
    for (name, ch, _), pt in zip(items, got):
        want = jbls.G1Point.infinity()
        for i, v in zip(ch.indices, ch.coefficients()):
            want = want + jpodr2.chunk_point(name, i).mul(v)
        assert (pt.x, pt.y) == (want.x, want.y)
    assert got[0] != got[1] and isinstance(got[0], bls.G1Point)
