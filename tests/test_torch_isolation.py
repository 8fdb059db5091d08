"""The port stands alone: tpubft_torch (the tuning and offload planes
among it) and chip_smoke.py import nothing of JAX, of the reference
package or of `cryptography` (the machine with the card has none; the
TLS material is written by comm/_der.py), the native libraries the port
loads (netio, the BLS engine, kvlog) are its own builds in ops/_build/,
the ledger engines, their tools, the read tier, pre-execution and the
read-only replica run alone (which without a card exits with NoDevice),
and chip_smoke.py refuses to run without a card or without the port
beside it."""
import ast
import os
import shutil
import subprocess
import sys
import time

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
            "tpubft_torch.offload.pool", "tpubft_torch.offload.soundness",
            "tpubft_torch.preprocessor.preprocessor"):
    assert mod in sys.modules, mod
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tpubft", "cryptography"))
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
        assert top not in ("jax", "jaxlib", "tpubft", "cryptography"), \
            (path, name)


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
    if shutil.which("g++") is not None:
        from tpubft_torch.storage import native
        kvlog = os.path.abspath(native._lib()._name)
        assert kvlog.startswith(os.path.join(port, "ops", "_build")), kvlog
        assert os.path.basename(kvlog).startswith("libkvlog-"), kvlog


_STORAGE_ALONE = r"""
import os, shutil, sys, tempfile
from tpubft_torch.kvbc.replica import open_db
from tpubft_torch.storage import WriteBatch, native, objectstore, s3
from tpubft_torch.storage.metadata import CONSENSUS_META_FAMILIES
from tpubft_torch.testing.s3server import S3TestServer
d = tempfile.mkdtemp()
db = open_db(os.path.join(d, "r", "replica-0.kvlog"),
             sync_families=CONSENSUS_META_FAMILIES)
db.write(WriteBatch().put(b"k", b"v", family=b"metadata"))
assert db.get(b"k", b"metadata") == b"v"
db.close()
with S3TestServer(access_key="a", secret_key="s") as srv:
    st = s3.S3ObjectStore(srv.endpoint, "b", access_key="a", secret_key="s")
    st.put("x", b"y")
    assert st.get("x") == b"y"
objectstore.FsObjectStore(os.path.join(d, "fs")).put("x", b"y")
shutil.rmtree(d)
maps = [line.split()[-1] for line in open("/proc/self/maps")
        if "kvlog" in line]
print("KVLOG:" + ",".join(sorted(set(maps))))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tpubft", "cryptography"))
print("LEAKED:" + ",".join(bad))
"""


_LEDGER_ALONE = r"""
import json, os, subprocess, sys, tempfile
from tpubft_torch import device
device.set_default_device("cpu")
from tpubft_torch.apps import ro_replica
from tpubft_torch.kvbc import BlockUpdates, create_blockchain
from tpubft_torch.kvbc import readonly, resources, snapshots
from tpubft_torch.kvbc.replica import open_db
from tpubft_torch.tools import migrate_v4, snapshot
d = tempfile.mkdtemp()
src = open_db(os.path.join(d, "src.kvlog"))
bc = create_blockchain(src, version="v1")
for i in range(70):
    bc.add_block(BlockUpdates().put("kv", b"k%d" % (i % 5), b"v%d" % i))
src.close()
sys.argv = ["migrate_v4", "--src", os.path.join(d, "src.kvlog"),
            "--dst", os.path.join(d, "v4.kvlog"), "--from", "v1", "--to", "v4"]
migrate_v4.main()
for argv in (["create", os.path.join(d, "v4.kvlog"), os.path.join(d, "s")],
             ["restore", os.path.join(d, "s"), os.path.join(d, "r.kvlog")]):
    sys.argv = ["snapshot"] + argv + ["--kvbc-version", "v4"]
    assert snapshot.main() == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tpubft", "cryptography"))
print("LEAKED:" + ",".join(bad))
"""


def test_ledger_engines_and_tools_import_nothing_of_the_reference():
    """The v4 and v1 engines, migrate_v4, the snapshot CLI, the resources
    manager and the read-only replica and its process module run in a
    process that imports nothing of JAX, of the reference or of
    `cryptography`: a v1 ledger migrated to v4 by the CLI, snapshotted
    and restored with digest_ok."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the engine is built from source at first use")
    out = subprocess.run([sys.executable, "-c", _LEDGER_ALONE],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"digest_ok": true' in out.stdout, out.stdout
    assert "LEAKED:\n" in out.stdout + "\n", out.stdout


def test_ro_replica_without_a_card_exits_with_no_device():
    """python -m tpubft_torch.apps.ro_replica without `--device cpu` on a
    host without a card exits non-zero with NoDevice before it serves."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "tpubft_torch.apps.ro_replica",
         "--replica", "4", "--base-port", "1", "--metrics-port", "0"],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode != 0
    assert "NoDevice" in out.stderr
    assert "up (" not in out.stdout


def test_storage_loads_only_the_ports_kvlog_and_no_reference():
    """storage/ (NativeDB through open_db, the S3 store and server, the
    filesystem store) runs in a process that imports nothing of JAX, of
    the reference or of `cryptography`, and the only kvlog library
    mapped into it is the port's lib<kvlog>-<hash>.so in ops/_build/
    (never the reference's native/_kvlog.so)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the engine is built from source at first use")
    out = subprocess.run([sys.executable, "-c", _STORAGE_ALONE],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED:\n" in out.stdout + "\n", out.stdout
    libs = [line[len("KVLOG:"):].split(",") for line in
            out.stdout.splitlines() if line.startswith("KVLOG:")][0]
    build = os.path.join(ROOT, "tpubft_torch", "ops", "_build") + os.sep
    assert libs and all(p.startswith(build)
                        and os.path.basename(p).startswith("libkvlog-")
                        for p in libs), libs


def test_udp_transport_loads_the_ports_own_netio():
    """The UDP transport's sendmmsg/recvmmsg library is built from the
    port's copy of the source, tpubft_torch/native/netio.cpp, into the
    port's ops/_build/ (never the reference's native library)."""
    from tpubft_torch.comm import udp
    from tpubft_torch.ops import _build
    src = os.path.join(ROOT, "tpubft_torch", "native", "netio.cpp")
    assert src in _all_port_files()
    assert os.path.abspath(os.path.join(_build.NATIVE, "netio.cpp")) == src
    if shutil.which("g++") is None:
        pytest.skip("no g++: the transport runs its scalar path")
    lib = udp._load_netio()
    assert lib is not None, udp.load_error
    assert os.path.abspath(lib._name).startswith(
        os.path.join(ROOT, "tpubft_torch", "ops", "_build") + os.sep)


_THIN_REPLICA_ALONE = r"""
import sys, time
import tpubft_torch.thinreplica
from tpubft_torch.thinreplica import client, messages, server
from tpubft_torch.consensus import messages as cm
from tpubft_torch.crypto.cpu import Ed25519Signer, Ed25519Verifier
from tpubft_torch.kvbc import BLOCK_MERKLE, BlockUpdates, KeyValueBlockchain
from tpubft_torch.storage import MemoryDB
bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
for i in range(4):
    bc.add_block(BlockUpdates().put("kv", b"k%d" % i, b"v%d" % i,
                                    cat_type=BLOCK_MERKLE))
signers = {i: Ed25519Signer.generate(seed=bytes([7 + i]) * 32)
           for i in range(2)}
certs = []
for i, s in signers.items():
    ck = cm.CheckpointMsg(sender_id=i, seq_num=8,
                          state_digest=bc.block_digest(4), is_stable=False,
                          res_pages_digest=b"", signature=b"")
    ck.signature = s.sign(ck.signed_payload())
    certs.append(ck.pack())
vs = {i: Ed25519Verifier(s.public_bytes()) for i, s in signers.items()}
srv = server.ThinReplicaServer(bc, anchor_fn=lambda: (8, 4, tuple(certs)))
srv.start()
trc = client.ThinReplicaClient(
    [("127.0.0.1", srv.port)], f_val=1,
    cert_verifier=lambda r, p, s: r in vs and vs[r].verify(p, s))
assert trc.fetch_anchor() == 4
assert trc.verified_read("kv", b"k2") == b"v2"
assert trc.verified_read("kv", b"k9") is None
got = []
trc.subscribe(lambda b, kv: got.append(b), start_block=1)
deadline = time.monotonic() + 30
while len(got) < 4 and time.monotonic() < deadline:
    time.sleep(0.02)
trc.stop()
srv.stop()
assert got == [1, 2, 3, 4], got
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tpubft", "cryptography"))
print("LEAKED:" + ",".join(bad))
"""


def test_thin_replica_modules_import_nothing_of_the_reference():
    """thinreplica/ (messages, server, client and the package) serves and
    verifies in a process that imports nothing of JAX, of the reference
    or of `cryptography`: an anchored verified read, an absent key and a
    subscription over a port ledger."""
    out = subprocess.run([sys.executable, "-c", _THIN_REPLICA_ALONE],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED:\n" in out.stdout + "\n", out.stdout


_PREEXECUTION_ALONE = r"""
import sys
import tpubft_torch.preprocessor
from tpubft_torch import device
device.set_default_device("cpu")
from tpubft_torch.apps.skvbc import SkvbcClient, SkvbcHandler
from tpubft_torch.kvbc import KeyValueBlockchain
from tpubft_torch.storage import MemoryDB
from tpubft_torch.testing import InProcessCluster
def hf(_r=None):
    return SkvbcHandler(KeyValueBlockchain(MemoryDB(),
                                           use_device_hashing=False))
with InProcessCluster(f=1, num_clients=1, handler_factory=hf,
                      cfg_overrides=dict(pre_execution_enabled=True,
                                         crypto_backend="cpu",
                                         autotune_enabled=False)) as cl:
    kv = SkvbcClient(cl.client(0))
    w = kv.write([(b"a", b"1")], pre_process=True, timeout_ms=30000)
    w2 = kv.write([(b"a", b"2")], readset=[b"a"], read_version=1,
                  pre_process=True, timeout_ms=30000)
    w3 = kv.write([(b"a", b"3")], readset=[b"a"], read_version=1,
                  pre_process=True, timeout_ms=30000)
    assert [w.success, w2.success, w3.success] == [True, True, False]
    assert kv.read([b"a"]) == {b"a": b"2"}
    assert cl.replicas[0].preprocessor.m_agreed.value == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tpubft", "cryptography"))
print("LEAKED:" + ",".join(bad))
"""


def test_preexecution_modules_import_nothing_of_the_reference():
    """preprocessor/ (the package and preprocessor.py) pre-executes in a
    process that imports nothing of JAX, of the reference or of
    `cryptography`: the conflict triple on a port cluster with
    pre-execution on."""
    out = subprocess.run([sys.executable, "-c", _PREEXECUTION_ALONE],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED:\n" in out.stdout + "\n", out.stdout


_TOOLS_WITHOUT_TORCH = r"""
import os, sys, tempfile
from tpubft_torch.kvbc import BlockUpdates, create_blockchain
from tpubft_torch.storage.factory import open_db
from tpubft_torch.tools import migrate_v4, snapshot
d = tempfile.mkdtemp()
src = open_db(os.path.join(d, "src.kvlog"))
bc = create_blockchain(src, version="v1")
for i in range(20):
    bc.add_block(BlockUpdates().put("kv", b"k%d" % (i % 3), b"v%d" % i))
src.close()
sys.argv = ["migrate_v4", "--src", os.path.join(d, "src.kvlog"),
            "--dst", os.path.join(d, "v4.kvlog"), "--from", "v1", "--to", "v4"]
migrate_v4.main()
for argv in (["create", os.path.join(d, "v4.kvlog"), os.path.join(d, "s")],
             ["verify", os.path.join(d, "s")],
             ["restore", os.path.join(d, "s"), os.path.join(d, "r.kvlog")]):
    sys.argv = ["snapshot"] + argv + ["--kvbc-version", "v4"]
    assert snapshot.main() == 0
print("TORCH:" + str("torch" in sys.modules))
"""


def test_snapshot_and_migration_tools_start_without_torch():
    """The snapshot CLI and migrate_v4 (open_db from storage/factory.py,
    the ledger engines on the host) create, verify and restore a snapshot
    and migrate a ledger in a process that never imports torch."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the engine is built from source at first use")
    out = subprocess.run([sys.executable, "-c", _TOOLS_WITHOUT_TORCH],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"digest_ok": true' in out.stdout, out.stdout
    assert "TORCH:False" in out.stdout, out.stdout


_WATCHDOG = r"""
import subprocess, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
print("CHILD:%d" % child.pid, flush=True)
w = chip_smoke.Watchdog(ceilings={{"quick": 30.0, "nap": 0.3}},
                        run_ceiling_s=60.0, poll_s=0.05).start()
w.timed("quick", time.sleep, 0.05)
w.timed("nap", time.sleep, 30)
print("WENT ON", flush=True)
"""


def test_chip_smoke_watchdog_ends_the_run_at_a_phase_ceiling():
    """chip_smoke.Watchdog: a phase that sleeps past its (tiny) ceiling
    ends the run there: the error line names the phase, its seconds and
    its ceiling, every thread's stack is dumped, the processes the run
    started are killed, it exits 1 and never runs what follows."""
    out = subprocess.run(
        [sys.executable, "-c", _WATCHDOG.format(root=ROOT)],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 1, (out.stdout, out.stderr)
    assert "WENT ON" not in out.stdout
    import json
    err = [json.loads(line) for line in out.stdout.splitlines()
           if line.startswith("{")]
    assert len(err) == 1 and err[0]["phase"] == "nap" \
        and err[0]["error"] == "over its ceiling", out.stdout
    assert err[0]["ceiling_s"] == 0.3 and err[0]["elapsed_s"] > 0.3
    assert "quick" in err[0]["phase_s"]
    # the watchdog's own thread and the main thread, asleep in the phase
    assert "Current thread 0x" in out.stderr and "Thread 0x" in out.stderr
    assert "in timed" in out.stderr
    assert "over its ceiling" in out.stderr
    pid = int(next(line for line in out.stdout.splitlines()
                   if line.startswith("CHILD:"))[6:])
    deadline = time.monotonic() + 10
    while os.path.exists(f"/proc/{pid}") and time.monotonic() < deadline:
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                break
        time.sleep(0.05)
    if os.path.exists(f"/proc/{pid}"):
        with open(f"/proc/{pid}/stat") as f:
            assert f.read().rsplit(")", 1)[1].split()[0] == "Z", pid
