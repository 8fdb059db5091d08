"""View change: complaints, view-change/new-view certificates, safety.

Rebuild of the reference's ViewsManager
(concord-bft bftengine/src/bftengine/ViewsManager.hpp:41 —
`tryToEnterView` :131, `computeCorrectRelevantViewNumbers` :100) and
ViewChangeSafetyLogic (ViewChangeSafetyLogic.cpp): when the primary of
view v stops making progress, replicas broadcast signed complaints
(ReplicaAsksToLeaveViewMsg, ReplicaImp.cpp:3771); f+1 complaints move
everyone to a view change; each replica broadcasts a ViewChangeMsg
carrying its prepared certificates (threshold-signed evidence that a
seqnum may have committed); the new primary assembles >= 2f+2c+1 of them
into a NewViewMsg and re-proposes every certified seqnum so no committed
request can be lost (the PBFT quorum-intersection argument: any slow-path
commit quorum of 2f+c+1 intersects any view-change quorum of 2f+2c+1 in
at least f+1 replicas, hence in one honest replica carrying the cert).

Fast-path safety needs a second mechanism (the reference's ViewChangeMsg
elements carry the PrePrepare digest even without a prepared proof): a
fast-path commit leaves no threshold certificate at the SIGNERS, only at
the collector. So every replica also reports a SIGNED element — "I signed
shares for this PrePrepare" — for each in-flight seqnum. If a seqnum
committed on the fast path, all n (or 3f+c+1) replicas signed it, so any
view-change quorum contains >= f+c+1 honest reporters; conversely <=f
byzantine replicas cannot fabricate f+c+1 reports. Hence the report rule:
f+c+1 matching SIGNED elements restrict the new view like a certificate.

The safety computation (`compute_restrictions`) is deterministic over the
set of ViewChangeMsgs fixed by the NewViewMsg digests, so every honest
replica derives the identical restriction map.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpubft_torch.consensus import messages as m
from tpubft_torch.crypto.digest import digest as sha256
from tpubft_torch.utils import serialize as ser

# PreparedCertificate.kind values: which threshold system signed the cert.
CERT_PREPARE = 0        # slow-path PrepareFull (2f+c+1)
CERT_COMMIT = 1         # slow-path CommitFull (2f+c+1)
CERT_FAST_OPT = 2       # optimistic fast path FullCommitProof (n)
CERT_FAST_THR = 3       # fast-with-threshold FullCommitProof (3f+c+1)
CERT_SIGNED = 4         # no combined proof — "I signed shares for this PP"

_CERT_TAG = {CERT_PREPARE: "prepare", CERT_COMMIT: "commit",
             CERT_FAST_OPT: "fast0", CERT_FAST_THR: "fast1"}


@dataclass
class Restriction:
    """What the new primary MUST re-propose for one seqnum.

    Born digest-only from the view-change evidence (certificates carry no
    batch bodies); `resolve` fills the body once the original PrePrepare
    is found locally or fetched (ReqViewPrePrepareMsg). Only the certified
    pp_digest is trusted: requests_digest/pre_prepare are derived from a
    body that hashes to it, never from a peer's claim."""
    seq_num: int
    view: int                     # view of the strongest certificate
    pp_digest: bytes              # certified digest of the original PP
    requests_digest: bytes        # filled by resolve(); b"" = unresolved
    pre_prepare: bytes            # packed original PP; b"" = unresolved
    SPEC = [("seq_num", "u64"), ("view", "u64"), ("pp_digest", "bytes"),
            ("requests_digest", "bytes"), ("pre_prepare", "bytes")]

    @property
    def resolved(self) -> bool:
        return bool(self.pre_prepare)

    def resolve(self, packed_pp: bytes) -> bool:
        """Adopt a candidate body iff it is structurally a PrePrepare for
        this (seq, view) hashing to the certified digest."""
        pp = _parse_pp(packed_pp, self.seq_num, self.view, self.pp_digest)
        if pp is None:
            return False
        self.requests_digest = pp.requests_digest
        self.pre_prepare = packed_pp
        return True


def pack_restriction(r: Restriction) -> bytes:
    return ser.encode_msg(r)


def unpack_restriction(data: bytes) -> Restriction:
    return ser.decode_msg(data, Restriction)


def pack_cert(c: m.PreparedCertificate) -> bytes:
    return ser.encode_msg(c)


def unpack_cert(data: bytes) -> m.PreparedCertificate:
    return ser.decode_msg(data, m.PreparedCertificate)


def build_certificates(window_items, last_stable: int, fast_path_of
                       ) -> Tuple[List[m.PreparedCertificate], Dict[bytes, bytes]]:
    """Collect evidence from the in-flight window (what the reference's
    ViewsManager harvests from SeqNumInfo before emitting a
    ViewChangeMsg): a threshold certificate where one exists, plus a
    SIGNED element for every PrePrepare we signed shares over.

    Returns (certs, bodies): certs are digest-only (the wire form);
    bodies maps pp_digest -> packed PrePrepare, retained LOCALLY so this
    replica can resolve its own restrictions and serve peers' fetches."""
    certs: List[m.PreparedCertificate] = []
    bodies: Dict[bytes, bytes] = {}
    for seq, info in window_items:
        if seq <= last_stable or info.pre_prepare is None:
            continue
        pp = info.pre_prepare
        bodies[pp.digest()] = pp.pack()
        if info.full_commit_proof is not None:
            path = fast_path_of(pp)
            kind = CERT_FAST_OPT if path == int(m.CommitPath.OPTIMISTIC_FAST) \
                else CERT_FAST_THR
            certs.append(m.PreparedCertificate(
                seq_num=seq, view=pp.view, kind=kind, pp_digest=pp.digest(),
                combined_sig=info.full_commit_proof.sig))
        elif info.commit_full is not None:
            certs.append(m.PreparedCertificate(
                seq_num=seq, view=pp.view, kind=CERT_COMMIT,
                pp_digest=pp.digest(), combined_sig=info.commit_full.sig))
        elif info.prepare_full is not None:
            certs.append(m.PreparedCertificate(
                seq_num=seq, view=pp.view, kind=CERT_PREPARE,
                pp_digest=pp.digest(), combined_sig=info.prepare_full.sig))
        # always also report that we signed this PrePrepare — fast-path
        # commits are only provable by counting these reports
        certs.append(m.PreparedCertificate(
            seq_num=seq, view=pp.view, kind=CERT_SIGNED,
            pp_digest=pp.digest(), combined_sig=b""))
    return certs, bodies


def _parse_pp(packed: bytes, seq_num: int, view: int,
              pp_digest: bytes) -> Optional[m.PrePrepareMsg]:
    """Structural consistency of a candidate PrePrepare body against the
    certified (seq, view, digest) triple."""
    try:
        pp = m.unpack(packed)
    except m.MsgError:
        return None
    if not isinstance(pp, m.PrePrepareMsg):
        return None
    if pp.seq_num != seq_num or pp.view != view:
        return None
    if pp.digest() != pp_digest:
        return None
    return pp


def validate_certificate(cert: m.PreparedCertificate, share_digest_fn,
                         verifier_for_kind) -> Optional[Restriction]:
    """Check a threshold-backed PreparedCertificate; returns the
    (unresolved, digest-only) Restriction it proves, or None if bogus.
    SIGNED elements carry no proof and are handled by the report rule in
    compute_restrictions.

    `share_digest_fn(tag, view, seq, pp_digest)` must be the replica's
    share-digest derivation — in production Replica._share_digest, which
    additionally binds the replica's current reconfiguration epoch, so a
    certificate assembled from dead-era shares cannot validate here;
    `verifier_for_kind(kind)` returns the IThresholdVerifier whose
    combined signature the cert carries.
    """
    tag = _CERT_TAG.get(cert.kind)
    if tag is None:
        return None
    verifier = verifier_for_kind(cert.kind)
    if verifier is None:
        return None
    d = share_digest_fn(tag, cert.view, cert.seq_num, cert.pp_digest)
    if not verifier.verify(d, cert.combined_sig):
        return None
    return Restriction(seq_num=cert.seq_num, view=cert.view,
                       pp_digest=cert.pp_digest,
                       requests_digest=b"", pre_prepare=b"")


def _validate_certificates(certs, share_digest_fn, verifier_for_kind
                           ) -> Dict[tuple, Optional[Restriction]]:
    """validate_certificate for each distinct threshold certificate among
    `certs`, keyed by (kind, view, seq_num, pp_digest, combined_sig): one
    `verify_batch_certs` call a verifier (per-cert verdicts, the
    aggregated BLS check with its per-cert loop on failure) in place of
    one `verify` a certificate."""
    out: Dict[tuple, Optional[Restriction]] = {}
    rows: Dict[object, List[Tuple[tuple, bytes, m.PreparedCertificate]]] = {}
    for cert in certs:
        key = (cert.kind, cert.view, cert.seq_num, cert.pp_digest,
               cert.combined_sig)
        if key in out:
            continue
        tag = _CERT_TAG.get(cert.kind)
        verifier = verifier_for_kind(cert.kind) if tag is not None else None
        out[key] = None
        if verifier is not None:
            rows.setdefault(verifier, []).append((key, share_digest_fn(
                tag, cert.view, cert.seq_num, cert.pp_digest), cert))
    for verifier, group in rows.items():
        verdicts = verifier.verify_batch_certs(
            [(d, cert.combined_sig) for _, d, cert in group])
        for (key, _, cert), ok in zip(group, verdicts):
            if ok:
                out[key] = Restriction(seq_num=cert.seq_num, view=cert.view,
                                       pp_digest=cert.pp_digest,
                                       requests_digest=b"", pre_prepare=b"")
    return out


def compute_restrictions(vc_msgs: List[m.ViewChangeMsg], share_digest_fn,
                         verifier_for_kind,
                         report_quorum: int) -> Dict[int, Restriction]:
    """ViewChangeSafetyLogic equivalent. Two sources of restrictions:

    1. threshold certificates — self-certifying, highest view wins;
    2. SIGNED reports — `report_quorum` (= f+c+1) matching reports of the
       same (view, pp_digest) prove at least one honest replica accepted
       that PrePrepare, and a fast-path commit guarantees that many
       reporters exist in any view-change quorum.

    Per seqnum the higher-view evidence wins (certificate on ties).
    Deterministic for a fixed vc_msgs set.
    """
    certs: Dict[int, Restriction] = {}
    # reports[seq][(view, pp_digest)] = (set of reporters, restriction)
    reports: Dict[int, Dict[Tuple[int, bytes], Tuple[set, Restriction]]] = {}
    # Port divergence (reference view_change.py:213, one verify a
    # certificate a message): the quorum's certificates are checked
    # once each and in one aggregated check a verifier, with the same
    # verdicts. An n=4 quorum's three messages carry the same ones, up
    # to a checkpoint window each, and a pairing check apiece held the
    # dispatcher about 3 s a view change on the card (PERF.md §6, PR 17)
    valid = _validate_certificates(
        [c for vc in vc_msgs for c in vc.prepared if c.kind != CERT_SIGNED],
        share_digest_fn, verifier_for_kind)
    for vc in vc_msgs:
        for cert in vc.prepared:
            if cert.kind == CERT_SIGNED:
                slot = reports.setdefault(cert.seq_num, {})
                key = (cert.view, cert.pp_digest)
                if key not in slot:
                    slot[key] = (set(), Restriction(
                        seq_num=cert.seq_num, view=cert.view,
                        pp_digest=cert.pp_digest,
                        requests_digest=b"", pre_prepare=b""))
                slot[key][0].add(vc.sender_id)
                continue
            r = valid[(cert.kind, cert.view, cert.seq_num, cert.pp_digest,
                       cert.combined_sig)]
            if r is None:
                continue
            cur = certs.get(r.seq_num)
            if cur is None or r.view > cur.view:
                certs[r.seq_num] = r
    out: Dict[int, Restriction] = {}
    for seq in set(certs) | set(reports):
        cert_r = certs.get(seq)
        report_r = None
        for (view, ppd), (who, r) in sorted(
                reports.get(seq, {}).items(),
                key=lambda kv: (-kv[0][0], kv[0][1])):
            if len(who) >= report_quorum:
                report_r = r        # highest view; lowest digest on ties
                break
        if cert_r is not None and (report_r is None
                                   or cert_r.view >= report_r.view):
            out[seq] = cert_r
        elif report_r is not None:
            out[seq] = report_r
    return out


class ViewChangeState:
    """Bookkeeping shared by all replicas during a view change: complaint
    sets per view, ViewChangeMsg sets per target view, and the pending
    NewViewMsg awaiting its referenced ViewChangeMsgs. Memory is bounded
    to one complaint and one ViewChangeMsg per sender (the latest-view
    one wins), so a byzantine replica cannot grow state without bound."""

    def __init__(self, complaint_quorum: int, view_change_quorum: int):
        self.complaint_quorum = complaint_quorum
        self.view_change_quorum = view_change_quorum
        self.complaints: Dict[int, Dict[int, m.ReplicaAsksToLeaveViewMsg]] = {}
        self.vc_msgs: Dict[int, Dict[int, m.ViewChangeMsg]] = {}
        self.pending_new_view: Optional[m.NewViewMsg] = None

    @staticmethod
    def _put_latest(store: Dict[int, Dict[int, object]], view: int,
                    sender: int, msg) -> None:
        for v in list(store):
            if sender in store[v]:
                if v > view:
                    return                      # stale: sender moved on
                if v < view:
                    del store[v][sender]
                    if not store[v]:
                        del store[v]
        store.setdefault(view, {})[sender] = msg

    # ---- complaints ----
    def add_complaint(self, msg: m.ReplicaAsksToLeaveViewMsg) -> None:
        self._put_latest(self.complaints, msg.view, msg.sender_id, msg)

    def complaint_count(self, view: int) -> int:
        return len(self.complaints.get(view, {}))

    def has_complaint_quorum(self, view: int) -> bool:
        return self.complaint_count(view) >= self.complaint_quorum

    # ---- view change msgs ----
    def add_view_change(self, msg: m.ViewChangeMsg) -> None:
        self._put_latest(self.vc_msgs, msg.new_view, msg.sender_id, msg)

    def view_change_count(self, new_view: int) -> int:
        return len(self.vc_msgs.get(new_view, {}))

    def has_view_change_quorum(self, new_view: int) -> bool:
        return self.view_change_count(new_view) >= self.view_change_quorum

    def quorum_for_new_view(self, new_view: int) -> List[m.ViewChangeMsg]:
        """ALL ViewChangeMsgs held for new_view (>= the quorum) — using
        every available message maximizes the certificate evidence the
        restriction computation sees."""
        msgs = self.vc_msgs.get(new_view, {})
        return [msgs[r] for r in sorted(msgs)]

    def match_new_view(self, nv: m.NewViewMsg) -> Optional[List[m.ViewChangeMsg]]:
        """Resolve a NewViewMsg's digests against stored ViewChangeMsgs;
        None if any referenced msg is missing or digest-mismatched."""
        have = self.vc_msgs.get(nv.new_view, {})
        out = {}
        for ref in nv.view_change_digests:
            vc = have.get(ref.replica)
            if vc is None or vc.digest() != ref.digest:
                return None
            out[ref.replica] = vc
        # DISTINCT senders must reach the quorum — a byzantine primary
        # repeating one digest to hide fast-path evidence must fail here
        if len(out) < self.view_change_quorum:
            return None
        return [out[r] for r in sorted(out)]

    def gc_below(self, view: int) -> None:
        """Drop state for views below the one just entered."""
        for d in (self.complaints, self.vc_msgs):
            for v in [v for v in d if v < view]:
                del d[v]
        self.pending_new_view = None
