"""The offload tier's seam, held by a plain AST scan (the port's
counterpart of tests/test_offload_seam.py, without its lint framework).

Raw helper transport — importing tpubft_torch.offload.protocol or
tpubft_torch.offload.helper, or calling `.lease()`, `send_frame()` or
`recv_frame()` — is allowed only inside tpubft_torch/offload/. The tier
is safe only because every helper response funnels through the pool's
soundness checks; a call site outside the seam would get UNVERIFIED
bytes one hop from a verdict. chip_smoke.py starts helpers as processes
(`python -m tpubft_torch.offload.helper`), which is not an import.
"""
import ast
import os
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SEAM = os.path.join("tpubft_torch", "offload")
RAW_MODULES = ("tpubft_torch.offload.protocol", "tpubft_torch.offload.helper")
RAW_CALLS = ("lease", "send_frame", "recv_frame")


def _sources(root):
    files = []
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        files.append(smoke)
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(root, "tpubft_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(files)


def find_violations(root):
    """[(relative path, line, symbol, message)] outside the seam."""
    files = _sources(root)
    if not files:
        return [("", 0, "", f"scanned no file: wrong root {root!r}")]
    out = []
    for path in files:
        rel = os.path.relpath(path, root)
        if rel.startswith(SEAM + os.sep):
            continue
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in RAW_MODULES:
                        out.append((rel, node.lineno, a.name,
                                    f"imports {a.name}"))
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if node.module in RAW_MODULES:
                        out.append((rel, node.lineno, node.module,
                                    f"imports from {node.module}"))
                    elif full in RAW_MODULES:
                        out.append((rel, node.lineno, full,
                                    f"imports {full}"))
            elif isinstance(node, ast.Call):
                f = node.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else "")
                if name in RAW_CALLS:
                    sym = "." + name if isinstance(f, ast.Attribute) \
                        else name
                    out.append((rel, node.lineno, sym,
                                f"raw offload call {sym}()"))
    return out


def test_port_tree_is_clean():
    violations = find_violations(ROOT)
    assert violations == [], "\n".join(
        f"{p}:{ln}: {msg}" for p, ln, _s, msg in violations)


def test_scan_catches_every_forbidden_form(tmp_path):
    """Each seeded defect is a finding; the seam package itself is
    exempt; consumers of the verified wrappers are clean."""
    pkg = tmp_path / "tpubft_torch" / "consensus"
    pkg.mkdir(parents=True)
    (pkg / "rogue.py").write_text(textwrap.dedent("""\
        import tpubft_torch.offload.protocol as proto
        from tpubft_torch.offload import helper
        from tpubft_torch.offload.protocol import send_frame

        def a(pool, payload):
            return pool.lease(1, payload, 4)

        def b(sock, body):
            send_frame(sock, body)
            return proto.recv_frame(sock)

        def not_a_finding():
            from tpubft_torch.ops.dispatch import offload_pool
            from tpubft_torch.offload.pool import combine_via_offload
            return offload_pool, combine_via_offload
    """))
    seam = tmp_path / "tpubft_torch" / "offload"
    seam.mkdir(parents=True)
    (seam / "pool.py").write_text(textwrap.dedent("""\
        from tpubft_torch.offload import protocol as proto

        def lease_round(h, sock, body):
            proto.send_frame(sock, body)
            return proto.recv_frame(sock)
    """))
    violations = find_violations(str(tmp_path))
    rel = os.path.join("tpubft_torch", "consensus", "rogue.py")
    assert {p for p, _ln, _s, _m in violations} == {rel}, violations
    assert sorted(s for _p, _ln, s, _m in violations) == [
        ".lease", ".recv_frame", "send_frame",
        "tpubft_torch.offload.helper", "tpubft_torch.offload.protocol",
        "tpubft_torch.offload.protocol"]


def test_zero_scan_fails_loudly(tmp_path):
    violations = find_violations(str(tmp_path))
    assert violations and "wrong root" in violations[0][3]
