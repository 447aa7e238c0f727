"""Lint gate of the PyTorch port: cesslint's four passes over cess_tpu_torch/.

The port's counterpart of `python -m tools.cesslint` (which walks only
cess_tpu/, tools/ and the root *.py).  Every cess_tpu_torch/**/*.py but
the build directory is parsed under the cess_tpu/ path it stands in for,
so the scoped rules reach their port files: the determinism scope
(chain/, consensus/, node/sync.py), node/rpc.py's lock and docs rules,
chain/checkpoint.py's migrations, the metrics-help rule over the port's
registries (so this gate also does tools/lint_metrics.py's job for the
port) and the reference's `host-sync` over the hot files.  Findings print
under their real cess_tpu_torch/ paths.  Pragmas work as in
tools/cesslint/core.py; there is no baseline: every suppression is a
pragma with its reason.

One rule is the port's own, `torch-host-sync`: the torch counterpart of
`host-sync`.  Inside a for/while body (a while's test included) in
proof/fused.py, ops/rs.py or parallel/verify.py, or in the element
or condition of a comprehension or generator expression there, it flags
`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")` (the device
given as the first argument or as `device=`, a string or
`torch.device("cpu")`), `torch.cuda.synchronize()` and any
`.synchronize()` of an event or a stream: each waits on the card per
iteration, so the next one is enqueued only after the previous has
finished.  `.item()` is also the reference rule's, so a deliberate one
names both rules in its pragma.

Run:  python tools/torch_lint.py    (exit 0 when every finding is
      suppressed, 1 otherwise; one summary line)

Imports neither jax nor any module of the JAX package: tools.cesslint is
pure AST.
"""

from __future__ import annotations

import argparse
import ast
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.cesslint import PASSES  # noqa: E402
from tools.cesslint.core import Finding, SourceFile, run_tree  # noqa: E402
from tools.cesslint.recompile import HOT_FILES  # noqa: E402

PORT, REF = "cess_tpu_torch/", "cess_tpu/"
RULE = "torch-host-sync"
PULLS = ("item", "tolist", "cpu", "numpy")


def as_ref(path: str) -> str:
    return REF + path[len(PORT):] if path.startswith(PORT) else path


def as_port(path: str) -> str:
    return PORT + path[len(REF):] if path.startswith(REF) else path


def load_port(root: Path | str = ROOT):
    """(files, docs): the port's sources, each parsed under its cess_tpu/
    path, and the docs/*.md corpus, as core.load_tree reads it."""
    root = Path(root)
    files = [
        SourceFile.from_text(as_ref(p.relative_to(root).as_posix()), p.read_text())
        for p in sorted((root / PORT).rglob("*.py"))
        if "_build" not in p.relative_to(root / PORT).parts
    ]
    docs = {
        p.relative_to(root).as_posix(): p.read_text()
        for p in sorted((root / "docs").glob("*.md"))
    }
    return files, docs


def _loop_bodies(tree: ast.AST):
    """Every node evaluated once per iteration of some loop or
    comprehension."""
    seen: set[int] = set()
    for loop in ast.walk(tree):
        if isinstance(loop, (ast.For, ast.AsyncFor)):
            roots = loop.body
        elif isinstance(loop, ast.While):
            roots = loop.body + [loop.test]
        elif isinstance(loop, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            roots = [loop.elt] + [c for g in loop.generators for c in g.ifs]
        elif isinstance(loop, ast.DictComp):
            roots = [loop.key, loop.value] + [c for g in loop.generators for c in g.ifs]
        else:
            continue
        for top in roots:
            for node in ast.walk(top):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield node


def _is_cpu(node: ast.expr) -> bool:
    """'cpu' or torch.device('cpu')."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "device" and node.args:
        node = node.args[0]
    return isinstance(node, ast.Constant) and node.value == "cpu"


def torch_host_sync(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        if sf.path not in HOT_FILES:
            continue
        for node in _loop_bodies(sf.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            f = node.func
            if f.attr in PULLS and not node.args:
                what = f".{f.attr}()"
            elif f.attr == "to" and any(
                _is_cpu(a) for a in node.args[:1]
                + [k.value for k in node.keywords if k.arg == "device"]
            ):
                what = '.to("cpu")'
            elif f.attr == "synchronize":
                cuda = (isinstance(f.value, ast.Attribute) and f.value.attr == "cuda"
                        and isinstance(f.value.value, ast.Name) and f.value.value.id == "torch")
                what = "torch.cuda.synchronize()" if cuda else ".synchronize() of an event or stream"
            else:
                continue
            out.append(Finding(
                RULE, sf.path, node.lineno,
                f"{what} inside a hot-section loop — the host waits on the "
                "card every iteration and the next one is enqueued only "
                "after it; keep results on the device and pull once after "
                "the loop",
            ))
    return out


def run_port(files: list[SourceFile], docs: dict[str, str]):
    """(kept, suppressed) over the port, under cess_tpu_torch/ paths.
    `torch-host-sync` is matched against the pragmas first and then
    taken out of them, so core.run_tree, which knows only the four
    passes' rules, applies its suppression and pragma hygiene to the rest
    (a pragma that names no other rule is then left alone by it).  The
    use of `torch-host-sync` is kept apart from `pragma.used`, so a
    pragma's other rules are still reported unused by run_tree when they
    suppress nothing."""
    kept, suppressed = [], []
    by_path = {sf.path: sf for sf in files}
    used: set[int] = set()
    for f in torch_host_sync(files):
        pragma = by_path[f.path].pragma_for(f.line)
        if pragma and RULE in pragma.rules:
            used.add(id(pragma))
            suppressed.append(f)
        else:
            kept.append(f)
    for sf in files:
        for pragma in {id(p): p for p in sf.pragmas.values()}.values():
            if RULE not in pragma.rules:
                continue
            if id(pragma) not in used:
                kept.append(Finding(
                    "pragma", sf.path, pragma.line,
                    f"unused allow[{RULE}] pragma — suppresses nothing on this line",
                ))
            pragma.rules = tuple(r for r in pragma.rules if r != RULE)
    k, s = run_tree(files, docs, passes=PASSES)
    kept = sorted(kept + k, key=lambda f: (f.path, f.line, f.rule))
    return ([replace(f, path=as_port(f.path)) for f in kept],
            [replace(f, path=as_port(f.path)) for f in suppressed + s])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose cess_tpu_torch/ to lint (default: this one)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    files, docs = load_port(args.root)
    kept, suppressed = run_port(files, docs)
    for f in kept:
        print(f.render())
    print(
        f"torch_lint: {'FAIL' if kept else 'ok'} — {len(files)} files under "
        f"{PORT}, {'/'.join(PASSES)}+{RULE}: {len(kept)} finding(s), "
        f"{len(suppressed)} suppressed (pragma), {time.perf_counter() - t0:.2f}s"
    )
    return 1 if kept else 0


if __name__ == "__main__":
    raise SystemExit(main())
