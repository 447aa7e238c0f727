"""The PyTorch port stands alone: importing cess_tpu_torch pulls in neither
jax nor any module of the JAX package, its sources import neither, and
its device entry points refuse to run without a card instead of falling
back to the plain tensor path or to a host fold."""

import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cess_tpu_torch
from cess_tpu_torch.chain import node
from cess_tpu_torch.chain.runtime import Runtime
from cess_tpu_torch.consensus import vrf
from cess_tpu_torch.ops import _cuda, bigmod, bls_agg, g1, glv, h2c, rs, rsa
from cess_tpu_torch.light import ReplicaService
from cess_tpu_torch.node import NodeService, dev_spec
from cess_tpu_torch.proof import TorchBackend, get_backend, ias

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cess_tpu_torch"

# `import jax`, `from jaxlib …`, `import cess_tpu.ops…`, `from cess_tpu
# import …` — but not the port's own name, which starts with cess_tpu.
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|cess_tpu)(?![\w])", re.MULTILINE
)


_NODE = ("__init__", "metrics", "tracing", "chain_spec", "sync", "service", "store",
         "rpc", "client", "faults", "cli")
_LIGHT = ("__init__", "client", "replica")


def _all_modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages(cess_tpu_torch.__path__, "cess_tpu_torch.")
    )


def test_import_pulls_in_no_jax_and_no_cess_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {_all_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cess_tpu'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax_and_no_cess_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert offenders == []
    scanned = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    host = {"native.py", "consensus/engine.py", "utils/codec.py", "utils/hashing.py",
            "utils/keccak.py", "utils/rng.py", "chain/node.py", "chain/runtime.py",
            "chain/checkpoint.py", "chain/offences.py", "__main__.py"}
    host |= {f"node/{m}.py" for m in _NODE} | {f"light/{m}.py" for m in _LIGHT}
    assert host <= scanned


def test_forbidden_pattern_tells_the_port_from_the_reference():
    assert _FORBIDDEN.search("from cess_tpu.ops import g1")
    assert _FORBIDDEN.search("import cess_tpu")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from cess_tpu_torch.ops import g1")
    assert not _FORBIDDEN.search("import cess_tpu_torch")


def test_every_kernel_has_a_cuda_source():
    for name, src in _cuda._SOURCES.items():
        text = (PKG / "csrc" / src).read_text()
        assert "__global__" in text
        for fn in _cuda._SIGS[name]:
            ret = "long long" if fn in _cuda._RESTYPES else "int"
            assert f'extern "C" {ret} {fn}(' in text, (src, fn)
        assert 'extern "C" int cess_init(' in text


def test_torch_backend_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend()  # the default backend is the card's
    assert TorchBackend(device="cpu").device.type == "cpu"


def test_rs_codes_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.RSCode(2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.segment_code()
    assert rs.segment_code(device="cpu").device.type == "cpu"


def test_module_walk_reaches_the_rs_data_plane():
    assert {"cess_tpu_torch.ops.rs", "cess_tpu_torch.ops.gf256",
            "cess_tpu_torch.device"} <= set(_all_modules())


def test_module_walk_reaches_the_signature_verifiers():
    assert {"cess_tpu_torch.ops.bigmod", "cess_tpu_torch.ops.rsa",
            "cess_tpu_torch.ops.bls_agg", "cess_tpu_torch.proof.ias",
            "cess_tpu_torch.consensus", "cess_tpu_torch.consensus.vrf"} <= set(_all_modules())


def test_module_walk_reaches_the_host_layers():
    chain = {f"cess_tpu_torch.chain.{m}" for m in (
        "types", "state", "smt", "checkpoint", "session", "staking", "sminer",
        "file_bank", "storage_handler", "audit", "tee_worker", "cacher", "oss",
        "scheduler_credit", "fees", "offences", "rrsc", "evm", "runtime", "node")}
    utils = {f"cess_tpu_torch.utils.{m}" for m in ("codec", "hashing", "rng", "keccak")}
    assert chain | utils | {"cess_tpu_torch.native", "cess_tpu_torch.consensus.engine"} \
        <= set(_all_modules())


def test_module_walk_reaches_the_node_light_client_and_cli():
    node_mods = {f"cess_tpu_torch.node.{m}" for m in _NODE if m != "__init__"}
    light_mods = {f"cess_tpu_torch.light.{m}" for m in _LIGHT if m != "__init__"}
    assert node_mods | light_mods | {"cess_tpu_torch.node", "cess_tpu_torch.light",
                                     "cess_tpu_torch.__main__"} <= set(_all_modules())


def test_node_services_refuse_without_cuda(monkeypatch):
    """A node resolves its device at construction: without a card it
    raises there, and never reaches a TEE registration whose IAS check
    would fail as a receipt."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (NodeService, ReplicaService):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(dev_spec())
    with pytest.raises(ValueError, match="unsupported device"):
        NodeService(dev_spec(), device="meta")
    seen = []
    monkeypatch.setattr(ias, "verify_attestation",
                        lambda *a, device=None: seen.append(device) or False)
    for make in (NodeService, ReplicaService):
        node = make(dev_spec(), device="cpu")
        assert node.device.type == "cpu"
        pbk = bytes(96)
        report = b'{"podr2_pbk":"' + pbk.hex().encode() + b'"}'
        assert not node.rt.tee_worker.cert_verifier(b"", b"", report, pbk)
    assert [d.type for d in seen] == ["cpu", "cpu"]  # the runtime's IAS check


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "cess_tpu_torch", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_cli_run_refuses_without_cuda():
    """`python -m cess_tpu_torch run` runs on the card unless told
    otherwise: with no card it exits non-zero before its RPC plane is up."""
    out = _cli("run", "--chain", "dev", "--rpc-port", "0", "--blocks", "1",
               env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "rpc=" not in out.stdout


def test_cli_export_then_import_state_on_the_cpu(tmp_path):
    """`--device cpu` is the plain path: a checkpoint exported by one
    process imports in another to the same state line."""
    blob = tmp_path / "state.bin"
    out = _cli("export-state", "--chain", "dev", "--blocks", "3", "--device", "cpu", str(blob))
    assert out.returncode == 0, out.stderr
    state_line = out.stdout.strip().split("state=")[1]
    out2 = _cli("import-state", "--chain", "dev", "--device", "cpu", str(blob))
    assert out2.returncode == 0, out2.stderr
    assert f"block=3 state={state_line}" in out2.stdout


def test_node_sim_refuses_without_cuda(monkeypatch):
    """NodeSim and the runtime's IAS registration run on the card unless
    told otherwise, whichever proof backend is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("torch", "cpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            node.NodeSim(backend=backend)
    root, _ = node._sim_authority()
    rt = Runtime(node.RuntimeConfig(ias_roots=ias.RootStore.from_der([root])))
    pbk = bytes(96)
    sign, cert, report = node._sim_report(pbk)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.tee_worker.cert_verifier(sign, cert, report, pbk)


def test_signature_verifiers_refuse_without_cuda(monkeypatch):
    """The default device is the card: without one every new entry point
    raises, whatever the batch holds, and never takes a host fold."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    triple = (b"\x00" * 96, b"m", b"\x00" * 48)
    claim = (b"\x00" * 96, b"m", b"\x00" * 32, b"\x00" * 48)
    key = rsa.RsaPublicKey((1 << 1023) + 1)
    roots = ias.RootStore(())
    calls = [
        lambda: bigmod.modexp_65537_batch([2], (1 << 511) + 1),
        lambda: rsa.verify_batch(key, [(b"m", b"\x01" * key.size_bytes)]),
        lambda: ias.verify_attestation_batch([(b"", b"", b"")], roots),
        lambda: ias.verify_attestation(b"", b"", b"", roots),
        lambda: bls_agg.batch_verify_signatures([triple]),
        lambda: bls_agg.verify_signatures([triple]),
        lambda: vrf.batch_verify([claim]),
        lambda: vrf.verify_claims([claim]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    n = (1 << 127) + 1
    assert bigmod.modexp_65537_batch([2], n, device="cpu") == [pow(2, 65537, n)]
    assert bls_agg.batch_verify_signatures([triple], device="cpu") is False
    assert vrf.verify_claims([claim], device="cpu") == [False]


def test_kernel_library_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        _cuda.lib("ladder")


def test_wrappers_raise_on_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a card gets an error,
    never the plain tensor path."""
    x = torch.zeros((g1.L, 4), dtype=torch.int32, device="meta")
    s = torch.zeros((g1.R_LIMBS, 4), dtype=torch.int32, device="meta")
    k = torch.zeros((glv.K_LIMBS, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="K3"):
        g1.scalar_mul_ladder((x, x, x), s, bits=8)
    with pytest.raises(RuntimeError, match="K2"):
        glv.glv_fold(x, x, x, k, k)
    with pytest.raises(RuntimeError, match="K4"):
        h2c._pow_c1(x)
    u = torch.zeros((g1.L, 2, 4), dtype=torch.int32, device="meta")
    f = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="K1"):
        h2c._map_pairs_kernel(u, f, f)


def test_wrappers_check_shapes():
    x = torch.zeros((g1.L, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        g1.scalar_mul_ladder((x, x, x[:, :3]), torch.zeros((22, 4), dtype=torch.int32), bits=8)
    with pytest.raises(ValueError):
        glv.glv_fold(x, x, x, torch.zeros((11, 4), dtype=torch.int32),
                     torch.zeros((11, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        h2c._pow_c1(x[:32])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is false, and where it stands alone."""
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
