"""The port's lint gate (tools/torch_lint.py): cesslint's four passes and
the torch `torch-host-sync` rule over cess_tpu_torch/, in process.  The
port is clean, findings carry cess_tpu_torch/ paths, the new rule fires
on each of torch's pulls inside a hot-section loop and nowhere else,
pragmas work as in tools/cesslint, and the audit step as it was before
its pulls were hoisted out of the rank loop is caught."""

import pytest

from tools import torch_lint
from tools.cesslint.core import SourceFile

pytestmark = pytest.mark.cesslint

HOT = "cess_tpu_torch/ops/rs.py"
COLD = "cess_tpu_torch/ops/g1.py"
RULE = torch_lint.RULE


def lint(path, text):
    sf = SourceFile.from_text(torch_lint.as_ref(path), text)
    return torch_lint.run_port([sf], {})


def at(findings, rule=RULE):
    return sorted((f.path, f.line) for f in findings if f.rule == rule)


LOOP = """\
def drain(xs, ev):
    out = []
    for x in xs:
        out.append(x.cpu())
    return out
"""

AFTER = """\
def drain(xs):
    out = []
    for x in xs:
        out.append(x + 1)
    return [y for y in out][0].cpu()
"""

PRAGMA = """\
def drain(xs):
    out = []
    for x in xs:
        # cesslint: allow[torch-host-sync] a host tensor here
        out.append(x.cpu())
    return out
"""

# audit_data_plane_step's step as the port first had it: v re-made and
# re-uploaded for every rank, each rank's μ pulled before the next rank
PARENT_AUDIT = """\
def audit_data_plane_step(mesh):
    @torch.inference_mode()
    def step(v_limbs, sector_limbs, rho_limbs):
        sectors = np.asarray(sector_limbs)
        rho = np.asarray(rho_limbs)
        if rho.shape[0] != sectors.shape[0]:
            raise ValueError("rho/sector batch length mismatch")
        mus, parts = [], []
        for dev, sl in zip(mesh.devices, mesh.shards(sectors.shape[0])):
            v = torch.as_tensor(np.asarray(v_limbs), device=dev)
            sec = np.ascontiguousarray(np.moveaxis(sectors[sl], 1, -2))
            mu = fr.weighted_sum_kernel(v, torch.as_tensor(sec, device=dev))
            w = torch.as_tensor(rho[sl], device=dev)
            parts.append(fr.weighted_sum_kernel(w, mu.to(torch.int8).movedim(0, -2)))
            mus.append(mu.cpu())
        combined = _psum_canonical(mesh, parts)
        return torch.cat(mus).numpy(), combined.cpu().numpy()

    return step
"""


def test_port_is_clean():
    files, docs = torch_lint.load_port()
    assert len(files) > 60 and docs
    assert not any("_build" in sf.path for sf in files)
    kept, suppressed = torch_lint.run_port(files, docs)
    assert kept == []
    assert all(f.path.startswith("cess_tpu_torch/") for f in suppressed)
    assert {f.path for f in suppressed if f.rule == RULE} == {HOT}


def test_main_exits_zero_with_one_summary_line(capsys):
    assert torch_lint.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("torch_lint: ok")
    assert "0 finding(s)" in out[0]


def test_findings_carry_port_paths():
    kept, _ = lint(HOT, LOOP)
    assert at(kept) == [(HOT, 4)]
    kept, _ = lint("cess_tpu_torch/chain/fixture.py", "import time\nT = time.time()\n")
    assert [(f.rule, f.path) for f in kept] == [
        ("det-wallclock", "cess_tpu_torch/chain/fixture.py")
    ]


@pytest.mark.parametrize("call", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
    "x.to('cpu')", "x.to(device='cpu')", "x.to(torch.device('cpu'))",
    "x.to('cpu', non_blocking=True)",
    "torch.cuda.synchronize()", "torch.cuda.synchronize(dev)",
    "ev.synchronize()", "stream.synchronize()",
])
def test_each_pull_fires_inside_a_hot_loop(call):
    kept, _ = lint(HOT, f"def f(xs, dev, ev, stream):\n    for x in xs:\n        {call}\n")
    assert at(kept) == [(HOT, 3)]


@pytest.mark.parametrize("expr", [
    "[x.cpu() for x in xs]",
    "{x.item() for x in xs}",
    "{i: x.to('cpu') for i, x in enumerate(xs)}",
    "{i: i for i, x in enumerate(xs) if x.item()}",
    "list(x.numpy() for x in xs)",
])
def test_comprehension_bodies_are_loops(expr):
    kept, _ = lint(HOT, f"def f(xs):\n    return {expr}\n")
    assert at(kept) == [(HOT, 2)]


@pytest.mark.parametrize("call", [
    "x.to(dev)", "x.to('cuda')", "x.to(torch.int8)", "x.to(device='cuda:0')",
])
def test_to_a_device_or_dtype_is_not_a_pull(call):
    kept, _ = lint(HOT, f"def f(xs, dev):\n    for x in xs:\n        {call}\n")
    assert at(kept) == []


def test_while_test_is_inside_the_loop():
    kept, _ = lint(HOT, "def f(x):\n    while x.sum().item() > 0:\n        x = x - 1\n")
    assert at(kept) == [(HOT, 2)]


def test_nested_loops_report_a_pull_once():
    kept, _ = lint(HOT, "def f(xss):\n    for xs in xss:\n        for x in xs:\n            x.cpu()\n")
    assert at(kept) == [(HOT, 4)]


@pytest.mark.parametrize("path,text", [
    (HOT, AFTER),
    (HOT, "def f(xs):\n    for x in xs.tolist():\n        print(x)\n"),
    (COLD, LOOP),
    ("cess_tpu_torch/proof/torch_backend.py", LOOP),
])
def test_silent_after_the_loop_and_outside_the_hot_files(path, text):
    kept, _ = lint(path, text)
    assert at(kept) == []


def test_pragma_suppresses_it():
    kept, suppressed = lint(HOT, PRAGMA)
    assert kept == []
    assert at(suppressed) == [(HOT, 5)]


def test_unused_and_bare_pragmas_are_findings():
    unused = "# cesslint: allow[torch-host-sync] nothing to allow\nX = 1\n"
    kept, _ = lint(HOT, unused)
    assert [(f.rule, f.line) for f in kept] == [("pragma", 1)]
    bare = PRAGMA.replace(" a host tensor here", "")
    kept, _ = lint(HOT, bare)
    assert [(f.rule, f.line) for f in kept] == [("pragma", 4)]


def test_pragma_rule_that_suppresses_nothing_is_reported():
    both = PRAGMA.replace("allow[torch-host-sync]", "allow[torch-host-sync,host-sync]")
    kept, suppressed = lint(HOT, both)
    assert at(suppressed) == [(HOT, 5)]
    assert [(f.rule, f.line) for f in kept] == [("pragma", 4)]
    assert "allow[host-sync]" in kept[0].message


def test_parent_audit_step_is_flagged_at_its_pulls():
    path = "cess_tpu_torch/parallel/verify.py"
    kept, _ = lint(path, PARENT_AUDIT)
    lines = PARENT_AUDIT.splitlines()
    cpu = next(i for i, ln in enumerate(lines, 1) if "mus.append(mu.cpu())" in ln)
    upload = next(i for i, ln in enumerate(lines, 1) if "np.asarray(v_limbs)" in ln)
    assert at(kept) == [(path, cpu)]
    assert at(kept, "host-sync") == [(path, upload)]
