"""The port stands alone: tpubft_torch (the tuning and offload planes
among it) and chip_smoke.py import nothing of JAX or of the reference
package, and chip_smoke.py refuses to run without a card or without the
port beside it."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_WALK_AND_VERIFY = r"""
import importlib, pkgutil, sys
import tpubft_torch
from tpubft_torch import device
for info in pkgutil.walk_packages(tpubft_torch.__path__,
                                  prefix="tpubft_torch."):
    importlib.import_module(info.name)
device.set_default_device("cpu")
from tpubft_torch.crypto.cpu import Ed25519Signer
from tpubft_torch.ops import ed25519
s = Ed25519Signer.generate(seed=b"iso")
sig = s.sign(b"m")
v = ed25519.verify_batch([(b"m", sig, s.public_bytes()),
                          (b"n", sig, s.public_bytes())])
assert v.tolist() == [True, False], v
from tpubft_torch.offload.helper import HelperServer
from tpubft_torch.offload import protocol
srv = HelperServer("iso")
resp = srv.handle(protocol.encode_request(
    1, protocol.KIND_BLS_SUM, 100, protocol.encode_bls_segments([])))
assert protocol.decode_response(resp)[:2] == (1, protocol.ST_OK), resp
for mod in ("tpubft_torch.tuning.wiring", "tpubft_torch.tuning.controller",
            "tpubft_torch.offload.pool", "tpubft_torch.offload.soundness"):
    assert mod in sys.modules, mod
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tpubft" or m.startswith("tpubft."))
print("LEAKED:" + ",".join(bad))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _WALK_AND_VERIFY],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr
    assert "LEAKED:\n" in out.stdout + "\n", out.stdout


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "tpubft_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_static_import_of_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpubft"), (path, name)


def test_chip_smoke_alone_fails_without_output(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""), timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_without_a_card_fails_without_output():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no card" in out.stderr


def _all_port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "tpubft_torch")):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return sorted(files)


@pytest.mark.parametrize("path", _all_port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_port_source_names_the_reference_native_dir(path):
    with open(path, encoding="utf-8") as f:
        assert "tpubft/native" not in f.read(), path


def test_ctypes_loads_stay_inside_the_port():
    """ctypes.CDLL is called in ops/_build.py only, on libraries it built
    under the port's own ops/_build/ from sources under tpubft_torch/; the
    native BLS engine the port loads is one of them."""
    callers = [p for p in _all_port_files() if p.endswith(".py")
               and "CDLL(" in open(p, encoding="utf-8").read().replace(
                   "ctypes.CDLL:", "").replace("ctypes.CDLL]", "")]
    assert [os.path.relpath(p, ROOT) for p in callers] == [
        os.path.join("tpubft_torch", "ops", "_build.py")]
    from tpubft_torch.crypto import bls_native
    from tpubft_torch.ops import _build
    port = os.path.join(ROOT, "tpubft_torch") + os.sep
    for d in (_build.BUILD_DIR, _build.CSRC, _build.NATIVE):
        assert os.path.abspath(d).startswith(port), d
    if bls_native.available():
        assert os.path.abspath(bls_native._lib._name).startswith(
            os.path.join(port, "ops", "_build")), bls_native._lib._name
