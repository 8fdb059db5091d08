"""The port's state snapshots (tpubft_torch/kvbc/snapshots.py), their CLI
(tpubft_torch/tools/snapshot.py) and the resources manager
(tpubft_torch/kvbc/resources.py) against the reference's
(tpubft/kvbc/snapshots.py, tpubft/tools/snapshot.py,
tpubft/kvbc/resources.py): byte-equal snapshot files that each package
restores, the same refusals of corrupt files with the target left empty,
the CLI's JSON, and the same prune rates and targets for seeded
timestamps. The counterparts of tests/test_snapshots_resources.py are
here too."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import create_blockchain as rcreate
from tpubft.kvbc import resources as rres
from tpubft.kvbc import snapshots as rsnap
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft.tools import snapshot as rcli
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import BlockUpdates, create_blockchain, resources
from tpubft_torch.kvbc import snapshots as snap
from tpubft_torch.kvbc.replica import open_db
from tpubft_torch.storage import MemoryDB
from tpubft_torch.storage.native import NativeDB
from tpubft_torch.tools import snapshot as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ledger(db, version="categorized", blocks=12, seed=4):
    bc = create_blockchain(db, version=version, use_device_hashing=False)
    for r in testing.ledger_rows(blocks, seed):
        bc.add_block(convert.block_updates(r))
    return bc


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("version", ["categorized", "v4"])
def test_snapshot_files_equal_and_cross_restore(tmp_path, version):
    db = MemoryDB()
    bc = _ledger(db, version)
    db.put(b"obj-1", b"private-consensus-state", b"metadata")
    paths = {n: str(tmp_path / f"{n}.snap") for n in ("port", "ref")}
    kw = dict(head_block=bc.last_block_id, state_digest=bc.state_digest())
    man = snap.create_snapshot(db, paths["port"], **kw)
    assert rsnap.create_snapshot(db, paths["ref"], **kw) == man
    assert _read(paths["port"]) == _read(paths["ref"])
    assert snap.read_manifest(paths["ref"]) == rsnap.read_manifest(
        paths["port"]) == man
    for restore, path, mem in ((snap.restore_snapshot, paths["ref"],
                                MemoryDB),
                               (rsnap.restore_snapshot, paths["port"],
                                RMemoryDB)):
        dst = mem()
        assert restore(path, dst) == man
        assert list(dst.scan_all()) == [r for r in db.scan_all()
                                        if r[0] != b"metadata"]
    back = create_blockchain(dst, version=version, use_device_hashing=False)
    assert back.state_digest().hex() == man["state_digest"]
    assert man["entries"] > 0 and man["head_block"] == 12


def _corrupt(path, case):
    raw = bytearray(_read(path))
    if case == "truncated":
        raw = raw[:len(raw) - 40]
    elif case == "flipped":
        raw[len(raw) // 2] ^= 0x01
    else:       # a digest-consistent file whose manifest lies
        body = snap._rec(b"kv", b"k", b"v") + snap._rec(b"kv", b"k2", b"v2")
        header = snap.MAGIC + json.dumps(
            {"version": 1, "head_block": 1, "state_digest": "",
             "entries": 99}).encode() + b"\n"
        raw = header + body + hashlib.sha256(header + body).digest()
    with open(path, "wb") as f:
        f.write(bytes(raw))


@pytest.mark.parametrize("case", ["truncated", "flipped", "count_mismatch"])
def test_corrupt_snapshot_raises_and_leaves_the_store_empty(tmp_path, case):
    db = MemoryDB()
    _ledger(db)
    path = str(tmp_path / "s.snap")
    snap.create_snapshot(db, path)
    _corrupt(path, case)
    errs = []
    for mod, mem in ((snap, MemoryDB), (rsnap, RMemoryDB)):
        dst = mem()
        with pytest.raises(mod.SnapshotError) as err:
            mod.restore_snapshot(path, dst)
        assert list(dst.scan_all()) == []
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_snapshot_native_db_scan(tmp_path):
    src = NativeDB(str(tmp_path / "src.kvlog"))
    bc = _ledger(src, blocks=4)
    path = str(tmp_path / "state.snap")
    snap.create_snapshot(src, path, head_block=bc.last_block_id)
    dst = NativeDB(str(tmp_path / "dst.kvlog"))
    snap.restore_snapshot(path, dst)
    bc2 = create_blockchain(dst, use_device_hashing=False)
    assert bc2.last_block_id == 4
    assert bc2.state_digest() == bc.state_digest()
    src.close()
    dst.close()


def _run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["snapshot"] + argv)
    rc = module.main()
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("version", ["categorized", "v4"])
def test_cli_commands_print_the_reference_json(tmp_path, monkeypatch,
                                               capsys, version):
    """create / inspect / verify / restore through each package's CLI on
    one kvlog file: the same JSON but for the paths, and snapshot files
    and restored kvlog files that are byte-equal."""
    db_path = str(tmp_path / "db.kvlog")
    db = open_db(db_path)
    _ledger(db, version)
    db.close()
    got = {}
    for name, module in (("port", cli), ("ref", rcli)):
        d = tmp_path / name
        d.mkdir()
        s, r = str(d / "state.snap"), str(d / "restored.kvlog")
        runs = [_run_main(module, argv + ["--kvbc-version", version],
                          monkeypatch, capsys)
                for argv in (["create", db_path, s], ["inspect", s],
                             ["verify", s], ["restore", s, r])]
        assert [rc for rc, _ in runs] == [0, 0, 0, 0]
        outs = [o for _, o in runs]
        assert outs[0].pop("created") == s
        assert outs[3].pop("restored") == r
        got[name] = (outs, _read(s), _read(r))
    assert got["port"] == got["ref"]
    outs = got["port"][0]
    assert outs[2]["ok"] is True and outs[3]["digest_ok"] is True


def test_cli_refusals_and_module_entry(tmp_path, monkeypatch, capsys):
    """`restore` onto an existing path and `create` from a missing DB
    exit with the reference's messages; `verify` of a corrupt file prints
    {"ok": false, ...} and exits 1; the module runs as `python -m`."""
    existing = tmp_path / "exists.kvlog"
    existing.write_bytes(b"")
    for argv in (["restore", "x.snap", str(existing)],
                 ["create", str(tmp_path / "missing.kvlog"), "x.snap"]):
        msgs = []
        for module in (cli, rcli):
            monkeypatch.setattr(sys, "argv", ["snapshot"] + argv)
            with pytest.raises(SystemExit) as err:
                module.main()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    db = MemoryDB()
    _ledger(db)
    path = str(tmp_path / "bad.snap")
    snap.create_snapshot(db, path)
    _corrupt(path, "flipped")
    outs = [_run_main(m, ["verify", path], monkeypatch, capsys)
            for m in (cli, rcli)]
    assert outs[0] == outs[1] and outs[0][0] == 1
    assert outs[0][1]["ok"] is False
    out = subprocess.run(
        [sys.executable, "-m", "tpubft_torch.tools.snapshot", "inspect",
         path], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == snap.read_manifest(path)


# ---------------- resources manager ----------------

def _timestamps(seed, n=200):
    rng = np.random.default_rng(seed)
    return list(100.0 + np.cumsum(rng.exponential(0.05, n)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resource_manager_rates_and_targets_equal_reference(seed):
    kw = dict(retention_blocks=100, max_prune_rate=100.0, min_prune_rate=1.0,
              busy_add_rate=10.0, window_s=2.0)
    pm = resources.ResourceManager(resources.ResourceConfig(**kw))
    rm = rres.ResourceManager(rres.ResourceConfig(**kw))
    rng = np.random.default_rng(seed + 10)
    for i, t in enumerate(_timestamps(seed)):
        pm.on_block_added(now=t)
        rm.on_block_added(now=t)
        if i % 10:
            continue
        now = t + float(rng.uniform(0, 3))
        last = int(rng.integers(1, 400))
        assert pm.add_rate(now) == rm.add_rate(now)
        assert pm.prune_blocks_per_second(1, last, now) == \
            rm.prune_blocks_per_second(1, last, now)
        assert pm.recommended_prune_until(1, last, 5.0, now) == \
            rm.recommended_prune_until(1, last, 5.0, now)


def test_prune_rate_scales_with_backlog_and_business():
    rm = resources.ResourceManager(resources.ResourceConfig(
        retention_blocks=100, max_prune_rate=100.0, busy_add_rate=10.0,
        window_s=1.0))
    assert rm.prune_blocks_per_second(1, 50, now=100.0) == 0.0
    assert rm.prune_blocks_per_second(1, 300, now=100.0) == 100.0
    for i in range(10):
        rm.on_block_added(now=99.5 + i * 0.05)
    assert rm.prune_blocks_per_second(1, 300, now=100.0) < 10.0
    assert 40.0 <= rm.prune_blocks_per_second(1, 151, now=200.0) <= 60.0
    rm2 = resources.ResourceManager(resources.ResourceConfig(
        retention_blocks=10, max_prune_rate=1000.0))
    assert rm2.recommended_prune_until(1, 50, interval_s=60.0, now=1.0) == 40


@pytest.mark.parametrize("version", ["categorized", "v4"])
def test_attach_counts_commits(version):
    bc = create_blockchain(MemoryDB(), version=version,
                           use_device_hashing=False)
    rm = resources.attach(bc, resources.ResourceConfig(window_s=60.0))
    rbc = rcreate(RMemoryDB(), version=version, use_device_hashing=False)
    ref = rres.attach(rbc, rres.ResourceConfig(window_s=60.0))
    for i in range(5):
        bc.add_block(BlockUpdates().put("c", b"k", b"%d" % i))
        rbc.add_block(RBlockUpdates().put("c", b"k", b"%d" % i))
    assert len(rm._adds) == len(ref._adds) == 5
    assert rm.add_rate() > 0
