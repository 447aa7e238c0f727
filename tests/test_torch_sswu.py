"""The port's SSWU isogeny derivation (tools/torch_derive_sswu.py): its
text equals both packages' committed `_sswu_g1.py` byte for byte, its
map is the JAX package's hash to G1, and the IC known-answer vector
picks it out of the other sixth-root normalizations.  The derivation
runs once, about 6 s on one core; no test writes into either package."""

from pathlib import Path

import pytest

from cess_tpu.ops import bls12_381 as jbls
from cess_tpu_torch.ops import bls12_381 as tbls
from tools import torch_derive_sswu as tool

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = {
    "port": ROOT / "cess_tpu_torch" / "ops" / "_sswu_g1.py",
    "reference": ROOT / "cess_tpu" / "ops" / "_sswu_g1.py",
}


@pytest.fixture(scope="module")
def selected():
    return tool.derive()


@pytest.mark.parametrize("package", sorted(COMMITTED))
def test_render_equals_committed_module(selected, package):
    assert tool.render(*selected[2:]) == COMMITTED[package].read_text()


def test_main_writes_the_module_where_told(selected, tmp_path, monkeypatch):
    monkeypatch.setattr(tool, "derive", lambda: selected)
    out = tmp_path / "sswu.py"
    assert tool.main(["--out", str(out)]) == 0
    assert out.read_bytes() == COMMITTED["port"].read_bytes()


def test_selected_map_regenerates_the_kat_signature(selected):
    apply = tool.make_apply(*selected[2:])
    point = tool.hash_to_g1_with(apply, tool.KAT_MSG, tool.IC_DST)
    assert tbls.G1Point.from_bytes(tool.KAT_SIG) == point.mul(tool.KAT_SK)
    assert tool.passes_kat(*selected[2:])


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(range(97))], ids=["empty", "abc", "97-bytes"])
def test_selected_map_is_the_reference_hash_to_g1(selected, msg):
    got = tool.hash_to_g1_with(tool.make_apply(*selected[2:]), msg, tool.IC_DST)
    want = jbls.hash_to_g1(msg, tool.IC_DST)
    assert (got.x, got.y) == (want.x, want.y)


def test_another_sixth_root_fails_the_kat(selected):
    # w·ζ with ζ⁶ = 1, ζ ≠ 1 is another candidate of the same kernel: its
    # maps are the selected ones with X_NUM·ζ⁻² and Y_NUM·ζ⁻³
    zetas = [z for z in tool.sixth_roots(1) if z != 1]
    assert len(zetas) == 5
    _, _, xn, xd, yn, yd = selected
    P = tool.P
    for z in zetas:
        xn2 = tool.pscale(xn, pow(z * z, P - 2, P))
        yn2 = tool.pscale(yn, pow(z * z * z, P - 2, P))
        assert not tool.passes_kat(xn2, xd, yn2, yd)
