"""The port's replica wire and state plumbing against the reference.

On a seeded corpus (numpy), every consensus message packs to the
reference's bytes and unpacks the reference's bytes back; the in-memory
and file WAL, the reserved pages and the ClientsManager reply ring hold
the reference's bytes; and the view-change certificate checks give the
reference's verdicts on valid and tampered certificates.
"""
import dataclasses

import numpy as np
import pytest

from tpubft.consensus import clients_manager as ref_cm
from tpubft.consensus import messages as ref_m
from tpubft.consensus import persistent as ref_persist
from tpubft.consensus import reserved_pages as ref_rp
from tpubft.consensus import view_change as ref_vc
from tpubft.consensus.keys import ClusterKeys as RefKeys
from tpubft.storage.memorydb import MemoryDB as RefMemoryDB
from tpubft.utils import serialize as ref_ser
from tpubft.utils.config import ReplicaConfig as RefConfig
from tpubft_torch.consensus import clients_manager as port_cm
from tpubft_torch.consensus import messages as port_m
from tpubft_torch.consensus import persistent as port_persist
from tpubft_torch.consensus import reserved_pages as port_rp
from tpubft_torch.consensus import view_change as port_vc
from tpubft_torch.consensus.keys import ClusterKeys as PortKeys
from tpubft_torch.storage.memorydb import MemoryDB as PortMemoryDB
from tpubft_torch.utils import serialize as port_ser
from tpubft_torch.utils.config import ReplicaConfig as PortConfig

SEED = 20261017


# ---------------------------------------------------------------------
# a seeded value tree per message class, built from the class's SPEC
# ---------------------------------------------------------------------
def _value(rng, name, spec, module):
    if spec == "u8":
        return int(rng.integers(0, 2))          # kind/path/reason fields
    if spec == "u16":
        return int(rng.integers(0, 1 << 16))
    if spec == "u32":
        return int(rng.integers(0, 1 << 32))
    if spec in ("u64", "i64"):
        return int(rng.integers(0, 1 << 62))
    if spec == "bool":
        return bool(rng.integers(0, 2))
    if spec == "bytes":
        n = 56 if name == "agg" else 32          # AggregateShare's G1 sum
        return rng.bytes(n)
    if spec == "str":
        return rng.bytes(6).hex()
    tag = spec[0]
    if tag == "list":
        return [_value(rng, name, spec[1], module)
                for _ in range(int(rng.integers(1, 4)))]
    if tag == "pair":
        return (_value(rng, name, spec[1], module),
                _value(rng, name, spec[2], module))
    if tag == "msg":
        return _tree(rng, spec[1], module)
    raise AssertionError(spec)


def _tree(rng, cls, module):
    """{field: value} for `cls`, nested messages as ("msg", name, tree)."""
    out = {}
    for name, spec in cls.SPEC:
        out[name] = _value(rng, name, spec, module)
    if hasattr(cls, "compute_requests_digest"):
        out["requests_digest"] = cls.compute_requests_digest(
            out["requests"])
    return ("msg", cls.__name__, out)


def _build(tree, module):
    """Instantiate a value tree with `module`'s classes."""
    if isinstance(tree, tuple) and tree and tree[0] == "msg":
        cls = getattr(module, tree[1])
        return cls(**{k: _build(v, module) for k, v in tree[2].items()})
    if isinstance(tree, list):
        return [_build(v, module) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_build(v, module) for v in tree)
    return tree


def _wire_classes(module):
    return sorted((c for c in vars(module).values()
                   if isinstance(c, type) and dataclasses.is_dataclass(c)
                   and hasattr(c, "SPEC")), key=lambda c: c.__name__)


_CODES = [c.name for c in ref_m.MsgCode]


def test_msgcodes_and_classes_match():
    assert [(c.name, int(c)) for c in port_m.MsgCode] \
        == [(c.name, int(c)) for c in ref_m.MsgCode]
    assert sorted(port_m._REGISTRY) == sorted(ref_m._REGISTRY)
    assert ([c.__name__ for c in _wire_classes(port_m)]
            == [c.__name__ for c in _wire_classes(ref_m)])
    for code, cls in ref_m._REGISTRY.items():
        assert port_m._REGISTRY[code].__name__ == cls.__name__
        assert repr(port_m._REGISTRY[code].SPEC).replace(
            "tpubft_torch.", "tpubft.") == repr(cls.SPEC)


@pytest.mark.parametrize("code", _CODES)
def test_every_msgcode_packs_and_unpacks_like_the_reference(code):
    cls_ref = ref_m._REGISTRY[int(ref_m.MsgCode[code])]
    rng = np.random.default_rng([SEED, int(ref_m.MsgCode[code])])
    for _ in range(4):
        tree = _tree(rng, cls_ref, ref_m)
        ref = _build(tree, ref_m)
        port = _build(tree, port_m)
        raw = ref.pack()
        assert port.pack() == raw
        back = port_m.unpack(raw)
        assert type(back).__name__ == cls_ref.__name__
        assert back.pack() == raw
        assert ref_m.unpack(port.pack()).pack() == raw
        if "signature" in dict(cls_ref.SPEC) \
                and cls_ref.SPEC[-1][0] == "signature":
            assert port.signed_payload() == ref.signed_payload()
        for attr in ("digest", "matching_digest"):
            if hasattr(ref, attr) and callable(getattr(ref, attr)):
                assert getattr(port, attr)() == getattr(ref, attr)()
        # a truncated or a corrupted frame gets the reference's verdict
        for bad in (raw[:len(raw) // 2], raw[:2] + b"\xff" * 5, raw + b"x"):
            assert _verdict(port_m, bad) == _verdict(ref_m, bad)


def _verdict(module, raw):
    try:
        return ("ok", module.unpack(raw).pack())
    except module.MsgError:
        return ("error", None)


@pytest.mark.parametrize("name", ["PreProcessResult", "PreparedCertificate",
                                  "ReplicaDigest"])
def test_embedded_records_encode_like_the_reference(name):
    rng = np.random.default_rng([SEED, len(name)])
    cls_ref = getattr(ref_m, name)
    for _ in range(4):
        tree = _tree(rng, cls_ref, ref_m)
        raw = ref_ser.encode_msg(_build(tree, ref_m))
        port = _build(tree, port_m)
        assert port_ser.encode_msg(port) == raw
        assert port_ser.encode_msg(
            port_ser.decode_msg(raw, getattr(port_m, name))) == raw


def test_admission_gates_match_the_reference():
    """client_request_admissible and parse_batch_elements on a seeded mix
    of flags and principals."""
    ref_info, port_info = _infos()
    rng = np.random.default_rng(SEED)
    ids = [0, 3, 4, 5, ref_info.operator_id,
           ref_info.internal_client_of(0), ref_info.internal_client_of(3)]
    for _ in range(64):
        sender = int(rng.choice(ids))
        flags = int(rng.integers(0, 128))
        fields = dict(sender_id=sender, req_seq_num=int(rng.integers(1, 99)),
                      flags=flags, request=rng.bytes(9), cid="c",
                      signature=rng.bytes(64))
        assert port_m.client_request_admissible(
            port_m.ClientRequestMsg(**fields), port_info) \
            == ref_m.client_request_admissible(
                ref_m.ClientRequestMsg(**fields), ref_info)
    good = ref_m.ClientRequestMsg(sender_id=4, req_seq_num=1, flags=0,
                                  request=b"A", cid="", signature=b"s")
    other = dataclasses.replace(good, sender_id=5)
    for reqs in ([good.pack()], [good.pack(), other.pack()],
                 [good.pack(), b"\x01\x00junk"]):
        fields = dict(sender_id=4, cid="b", requests=reqs, signature=b"")
        ref_out = ref_m.parse_batch_elements(
            ref_m.ClientBatchRequestMsg(**fields))
        port_out = port_m.parse_batch_elements(
            port_m.ClientBatchRequestMsg(**fields))
        assert (None if port_out is None else [r.pack() for r in port_out]) \
            == (None if ref_out is None else [r.pack() for r in ref_out])


def _infos():
    from tpubft.consensus.replicas_info import ReplicasInfo as RefInfo
    from tpubft_torch.consensus.replicas_info import ReplicasInfo as PortInfo
    kw = dict(f_val=1, c_val=0, num_of_client_proxies=3)
    return (RefInfo.from_config(RefConfig(**kw)),
            PortInfo.from_config(PortConfig(**kw)))


def test_replicas_info_matches_the_reference():
    ref, port = _infos()
    for attr in ("n", "f", "c", "operator_id", "complaint_quorum",
                 "view_change_quorum"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert list(port.all_client_ids()) == list(ref.all_client_ids())
    for p in range(0, 40):
        assert port.is_replica(p) == ref.is_replica(p)
        assert port.is_internal_client(p) == ref.is_internal_client(p)


def test_config_fields_match_the_reference():
    """The full ReplicaConfig: every reference field with its default,
    apart from the crypto backend, whose values are the port's."""
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    port = {f.name: f.default for f in dataclasses.fields(PortConfig)}
    assert port.keys() == ref.keys()
    diff = {k for k in ref if ref[k] != port[k]
            and ref[k] is not dataclasses.MISSING}
    assert diff == {"crypto_backend"}
    assert ref["crypto_backend"] == "auto"
    assert port["crypto_backend"] == "cuda"
    cfg = PortConfig(crypto_backend="auto")
    cfg.validate()
    with pytest.raises(ValueError, match="cuda|cpu|auto"):
        PortConfig(crypto_backend="tpu").validate()
    assert PortConfig.from_json(cfg.to_json()) == cfg


# ---------------------------------------------------------------------
# WAL records
# ---------------------------------------------------------------------
def _fill(module, m, st, rng):
    """Apply one seeded transaction to a PersistedState."""
    st.last_view = int(rng.integers(0, 4))
    st.last_executed_seq = int(rng.integers(0, 300))
    st.last_stable_seq = int(rng.integers(0, 150))
    st.in_view_change = bool(rng.integers(0, 2))
    st.pending_view = int(rng.integers(0, 5))
    for _ in range(3):
        seq = int(rng.integers(1, 20))
        if rng.integers(0, 4) == 0 and seq in st.seq_states:
            del st.seq_states[seq]
            continue
        s = st.seq(seq)
        s.pre_prepare = m.PrePrepareMsg(
            sender_id=0, view=st.last_view, seq_num=seq, first_path=2,
            time=int(rng.integers(0, 1 << 40)), requests_digest=b"",
            requests=[rng.bytes(8)], signature=rng.bytes(64)).pack()
        s.prepare_full = rng.bytes(40) if rng.integers(0, 2) else None
        s.commit_full = rng.bytes(40) if rng.integers(0, 2) else None
        s.slow_started = bool(rng.integers(0, 2))
    st.restrictions = [rng.bytes(20) for _ in range(int(rng.integers(0, 3)))]
    st.carried_certs = [rng.bytes(20)
                        for _ in range(int(rng.integers(0, 3)))]
    st.carried_bodies = [rng.bytes(20)
                         for _ in range(int(rng.integers(0, 2)))]


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_wal_records_match_the_reference(kind, tmp_path):
    stores = []
    for name, module, m in (("ref", ref_persist, ref_m),
                            ("port", port_persist, port_m)):
        if kind == "memory":
            store = module.InMemoryPersistentStorage()
        else:
            store = module.FilePersistentStorage(
                str(tmp_path / f"{name}.wal"), compact_bytes=6000)
        rng = np.random.default_rng(SEED)
        for _ in range(12):
            st = store.begin_write_tran()
            _fill(module, m, st, rng)
            store.end_write_tran()
        stores.append((module, store))
    (ref_mod, ref_store), (port_mod, port_store) = stores
    ref_rec = ref_mod.FilePersistentStorage._encode(ref_store.load())
    assert port_mod.FilePersistentStorage._encode(port_store.load()) \
        == ref_rec
    if kind == "file":
        ref_store.close()
        port_store.close()
        ref_bytes = (tmp_path / "ref.wal").read_bytes()
        assert (tmp_path / "port.wal").read_bytes() == ref_bytes
        # each package recovers the other's log (a torn tail included)
        (tmp_path / "torn.wal").write_bytes(ref_bytes + b'{"v":')
        back = port_mod.FilePersistentStorage(str(tmp_path / "torn.wal"))
        assert port_mod.FilePersistentStorage._encode(back.load()) \
            == ref_rec
        back.close()
    ref_st, ref_rows = ref_mod.restore_replica_state(ref_store)
    port_st, port_rows = port_mod.restore_replica_state(port_store)
    assert sorted(port_rows) == sorted(ref_rows)
    for seq, row in ref_rows.items():
        for name, msg in row.items():
            got = port_rows[seq][name]
            if hasattr(msg, "pack"):
                assert got.pack() == msg.pack()
            else:
                assert got == msg


# ---------------------------------------------------------------------
# reserved pages and the client reply ring
# ---------------------------------------------------------------------
def test_reserved_pages_match_the_reference():
    pages = [(ref_rp.ReservedPages(RefMemoryDB()), RefMemoryDB),
             (port_rp.ReservedPages(PortMemoryDB()), PortMemoryDB)]
    assert port_rp.PAGE_SIZE == ref_rp.PAGE_SIZE
    for rp, _db in pages:
        rng = np.random.default_rng(SEED)
        wb_cls = (ref_rp if rp.__class__ is ref_rp.ReservedPages
                  else port_rp).WriteBatch
        for _ in range(200):
            cat = ["clients", "clientreplies", "keyexchange", "cron"][
                int(rng.integers(0, 4))]
            idx = int(rng.integers(0, 40))
            op = int(rng.integers(0, 5))
            if op == 0:
                rp.delete(cat, idx)
            elif op == 1:
                wb = wb_cls()
                rp.stage_save(wb, cat, idx,
                              rng.bytes(int(rng.integers(1, 64))))
                rp.write_batch(wb)
            else:
                rp.save(cat, idx, rng.bytes(int(rng.integers(1, 64))))
    (ref, _), (port, _) = pages
    assert port.all_pages() == ref.all_pages()
    assert port.digest() == ref.digest()
    assert list(port.scan("clientreplies", 3, 30)) \
        == list(ref.scan("clientreplies", 3, 30))
    fresh = port_rp.ReservedPages(PortMemoryDB())
    fresh.replace_all(ref.all_pages())
    assert fresh.digest() == ref.digest()


def test_clients_manager_reply_ring_matches_the_reference():
    """Replies beyond the per-client ring evict the oldest; cached
    replies, at-most-once verdicts and the restore seal agree."""
    assert port_cm.REPLY_CACHE_PER_CLIENT == ref_cm.REPLY_CACHE_PER_CLIENT
    ring = ref_cm.REPLY_CACHE_PER_CLIENT
    clients = list(range(4, 9))
    mgrs = [(ref_cm.ClientsManager(clients), ref_m),
            (port_cm.ClientsManager(clients), port_m)]
    rng = np.random.default_rng(SEED)
    ops = []
    for _ in range(3 * ring):
        c = int(rng.choice(clients))
        ops.append((c, int(rng.integers(1, 4 * ring)), rng.bytes(12),
                    bool(rng.integers(0, 8) == 0)))
    for mgr, m in mgrs:
        for c, seq, payload, oversize in ops:
            mgr.add_pending(c, seq)
            if oversize:
                mgr.note_executed(c, seq)
            else:
                mgr.on_request_executed(c, seq, m.ClientReplyMsg(
                    sender_id=1, req_seq_num=seq, current_primary=0,
                    reply=payload, replica_specific_info=b""))
        mgr.seal_restore(clients[0])
    (ref, _), (port, _) = mgrs
    for c in clients + [99]:
        assert port.is_valid_client(c) == ref.is_valid_client(c)
        assert port.has_pending(c) == ref.has_pending(c)
        for seq in range(0, 4 * ring + 2):
            assert port.was_executed(c, seq) == ref.was_executed(c, seq)
            assert port.can_become_pending(c, seq) \
                == ref.can_become_pending(c, seq)
            r, p = ref.cached_reply(c, seq), port.cached_reply(c, seq)
            assert (None if p is None else p.pack()) \
                == (None if r is None else r.pack())


# ---------------------------------------------------------------------
# view-change certificate checks
# ---------------------------------------------------------------------
_PATHS = {ref_vc.CERT_PREPARE: "slow_path_system",
          ref_vc.CERT_COMMIT: "slow_path_system",
          ref_vc.CERT_FAST_OPT: "optimistic_system",
          ref_vc.CERT_FAST_THR: "commit_path_system"}


def _share_digest(tag, view, seq, pp_digest):
    from tpubft.crypto.digest import digest
    return digest(b"%s|%d|%d|" % (tag.encode(), view, seq) + pp_digest)


def _certs(rng):
    """Valid, tampered and signed-report certificates over the
    reference's keys (a tree of fields both packages build)."""
    cfg = RefConfig(f_val=1, c_val=0, num_of_client_proxies=1)
    keys = RefKeys.generate(cfg, 1, seed=b"vc-parity")
    out = []
    for seq in range(1, 7):
        kind = int(rng.choice(sorted(_PATHS)))
        view = int(rng.integers(0, 3))
        ppd = rng.bytes(32)
        system = getattr(keys, _PATHS[kind])
        tag = ref_vc._CERT_TAG[kind]
        d = _share_digest(tag, view, seq, ppd)
        verifier = system.create_threshold_verifier()
        acc = verifier.new_accumulator(False)
        acc.set_expected_digest(d)
        for r in range(system.num_signers):
            acc.add(r + 1, keys.threshold_signer(system, r).sign_share(d))
        sig = acc.get_full_signed_data()
        out.append(dict(seq_num=seq, view=view, kind=kind, pp_digest=ppd,
                        combined_sig=sig))
        out.append(dict(seq_num=seq, view=view, kind=kind, pp_digest=ppd,
                        combined_sig=sig[:-1] + bytes([sig[-1] ^ 1])))
        out.append(dict(seq_num=seq, view=view + 1, kind=kind,
                        pp_digest=ppd, combined_sig=sig))
        out.append(dict(seq_num=seq, view=view, kind=ref_vc.CERT_SIGNED,
                        pp_digest=ppd, combined_sig=b""))
        out.append(dict(seq_num=seq, view=view, kind=9, pp_digest=ppd,
                        combined_sig=sig))
    return out


def _verifiers(keys_cls, cfg_cls):
    keys = keys_cls.generate(cfg_cls(f_val=1, c_val=0,
                                     num_of_client_proxies=1), 1,
                             seed=b"vc-parity")
    table = {k: keys.threshold_verifier(getattr(keys, v), "cpu")
             for k, v in _PATHS.items()}
    return table.get


def test_view_change_quorum_checks_each_certificate_once():
    """compute_restrictions validates each distinct certificate of the
    quorum once, in one verify_batch_certs call a verifier (no per-cert
    verify), and gives the restrictions of the reference's per-cert
    loop, the quorum's messages carrying the same certificates."""
    certs = _certs(np.random.default_rng(SEED))
    port_for = _verifiers(PortKeys, PortConfig)
    calls = {"batch": [], "single": 0}

    class Counting:
        def __init__(self, inner):
            self.inner = inner

        def verify(self, d, s):
            calls["single"] += 1
            return self.inner.verify(d, s)

        def verify_batch_certs(self, items):
            calls["batch"].append(len(items))
            return self.inner.verify_batch_certs(items)
    wrapped = {}

    def counted_for(kind):
        v = port_for(kind)
        if v is None:
            return None
        return wrapped.setdefault(id(v), Counting(v))
    msgs = [dict(sender_id=s, new_view=3, last_stable_seq=0,
                 prepared=certs, signature=b"s") for s in range(3)]

    def vcs(mod):
        return [mod.ViewChangeMsg(**dict(
            v, prepared=[mod.PreparedCertificate(**c)
                         for c in v["prepared"]])) for v in msgs]
    port_out = port_vc.compute_restrictions(vcs(port_m), _share_digest,
                                            counted_for, report_quorum=2)
    ref_out = ref_vc.compute_restrictions(vcs(ref_m), _share_digest,
                                          _verifiers(RefKeys, RefConfig),
                                          report_quorum=2)
    assert {s: port_vc.pack_restriction(r) for s, r in port_out.items()} \
        == {s: ref_vc.pack_restriction(r) for s, r in ref_out.items()}
    distinct = {(c["kind"], c["view"], c["seq_num"], c["pp_digest"],
                 c["combined_sig"]) for c in certs
                if c["kind"] in _PATHS}
    assert calls["single"] == 0
    assert len(calls["batch"]) == len(wrapped)
    assert sum(calls["batch"]) == len(distinct)


def test_view_change_certificate_checks_match_the_reference():
    rng = np.random.default_rng(SEED)
    certs = _certs(rng)
    ref_for = _verifiers(RefKeys, RefConfig)
    port_for = _verifiers(PortKeys, PortConfig)

    def restr(r):
        return None if r is None else ref_ser.encode_msg(r)

    verdicts = []
    for fields in certs:
        ref_r = ref_vc.validate_certificate(
            ref_m.PreparedCertificate(**fields), _share_digest, ref_for)
        port_r = port_vc.validate_certificate(
            port_m.PreparedCertificate(**fields), _share_digest, port_for)
        assert (None if port_r is None else port_ser.encode_msg(port_r)) \
            == restr(ref_r)
        verdicts.append(ref_r is not None)
    assert any(verdicts) and not all(verdicts)
    # view-change quorums: each sender reports a seeded subset
    for trial in range(6):
        sub = np.random.default_rng([SEED, trial])
        msgs = []
        for sender in range(4):
            picks = [c for c in certs if sub.integers(0, 3) == 0]
            msgs.append(dict(sender_id=sender, new_view=3,
                             last_stable_seq=0, prepared=picks,
                             signature=b"s"))

        def vcs(m):
            return [m.ViewChangeMsg(**dict(
                v, prepared=[m.PreparedCertificate(**c)
                             for c in v["prepared"]])) for v in msgs]

        ref_out = ref_vc.compute_restrictions(vcs(ref_m), _share_digest,
                                              ref_for, report_quorum=2)
        port_out = port_vc.compute_restrictions(vcs(port_m), _share_digest,
                                                port_for, report_quorum=2)
        assert {s: port_vc.pack_restriction(r)
                for s, r in port_out.items()} \
            == {s: ref_vc.pack_restriction(r) for s, r in ref_out.items()}
    # a restriction resolves against the same bodies on both sides
    pp_fields = dict(sender_id=1, view=2, seq_num=5, first_path=2, time=7,
                     requests=[b"r1", b"r2"], signature=b"x")
    ref_pp = ref_m.PrePrepareMsg(requests_digest=ref_m.PrePrepareMsg
                                 .compute_requests_digest(
                                     pp_fields["requests"]), **pp_fields)
    port_pp = port_m.unpack(ref_pp.pack())
    for body in (ref_pp.pack(), ref_pp.pack()[:-1] + b"y", b"junk"):
        r_ref = ref_vc.Restriction(5, 2, ref_pp.digest(), b"", b"")
        r_port = port_vc.Restriction(5, 2, port_pp.digest(), b"", b"")
        assert r_port.resolve(body) == r_ref.resolve(body)
        assert port_vc.pack_restriction(r_port) \
            == ref_vc.pack_restriction(r_ref)

