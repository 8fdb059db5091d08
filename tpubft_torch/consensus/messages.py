"""Consensus wire messages.

Rebuild of concord-bft bftengine/src/bftengine/messages/ (MsgCode.hpp:24,
MessageBase.hpp, PrePrepareMsg.hpp:33-53, SignedShareMsgs.hpp,
FullCommitProofMsg.hpp, CheckpointMsg.hpp, ViewChangeMsg.hpp, …).

Instead of hand-packed C structs, every message is a dataclass serialized
with the canonical codec (tpubft_torch.utils.serialize); the wire envelope is
  u16 msg_code | body
Signed messages carry their signature as the last field; `signed_payload()`
is the canonical encoding of everything before it, so signing and verifying
never disagree about byte layout.

`sender_id` is part of the body (as in the reference's MessageBase header,
MessageBase.hpp senderId) — receivers must check it against the transport's
reported sender before trusting it.
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple, Type

from tpubft_torch.crypto.digest import calc_combination, digest as sha256
from tpubft_torch.utils import serialize as ser


class MsgCode(enum.IntEnum):
    """Wire discriminants (reference MsgCode.hpp:24-; values are ours)."""
    ClientRequest = 1
    ClientReply = 2
    PrePrepare = 3
    StartSlowCommit = 4
    PreparePartial = 5
    PrepareFull = 6
    CommitPartial = 7
    CommitFull = 8
    PartialCommitProof = 9
    FullCommitProof = 10
    Checkpoint = 11
    SimpleAck = 12
    ViewChange = 13
    NewView = 14
    ReqMissingData = 15
    ReplicaStatus = 16
    ReplicaAsksToLeaveView = 17
    StateTransfer = 18
    ReplicaRestartReady = 19
    RestartProof = 20
    PreProcessRequest = 21
    PreProcessReply = 22
    ReqViewPrePrepare = 23
    ClientBatchRequest = 24
    PreProcessBatchRequest = 25
    PreProcessBatchReply = 26
    AskForCheckpoint = 27
    TimeOpinion = 28
    AggregateShare = 29


class RequestFlag(enum.IntFlag):
    """ClientRequestMsg flags (reference ClientMsgs.hpp)."""
    EMPTY = 0
    READ_ONLY = 1
    PRE_PROCESS = 2
    HAS_PRE_PROCESSED = 4
    KEY_EXCHANGE = 8
    INTERNAL = 16
    RECONFIG = 32
    TICK = 64


class CommitPath(enum.IntEnum):
    """The three commit paths (reference ReplicaConfig / PrePrepareMsg
    firstPath): OPTIMISTIC_FAST needs n sigs, FAST_WITH_THRESHOLD needs
    3f+c+1, SLOW is two PBFT-like rounds of 2f+c+1."""
    OPTIMISTIC_FAST = 0
    FAST_WITH_THRESHOLD = 1
    SLOW = 2


_REGISTRY: Dict[int, Type["ConsensusMsg"]] = {}


def register(cls: Type["ConsensusMsg"]) -> Type["ConsensusMsg"]:
    assert cls.CODE not in _REGISTRY, cls
    _REGISTRY[int(cls.CODE)] = cls
    return cls


class MsgError(Exception):
    """Structurally invalid message (reference throws from validate())."""


class ConsensusMsg:
    """Mixin for dataclass messages; subclasses set CODE and SPEC."""
    CODE: ClassVar[MsgCode]
    SPEC: ClassVar[list]

    def pack(self) -> bytes:
        buf = bytearray(struct.pack("<H", int(self.CODE)))
        ser.encode_msg_into(buf, self)
        return bytes(buf)

    def signed_payload(self) -> bytes:
        """Canonical bytes covered by this message's signature: the msg
        code + every field before the trailing `signature`."""
        assert self.SPEC and self.SPEC[-1][0] == "signature", type(self)
        buf = bytearray(struct.pack("<H", int(self.CODE)))
        for name, spec in self.SPEC[:-1]:
            ser.encode_value(buf, spec, getattr(self, name))
        return bytes(buf)

    def validate(self) -> None:
        """Structural checks; raises MsgError. Signature checks live in
        SigManager/collector paths where keys are known."""


def unpack(data: bytes) -> ConsensusMsg:
    if len(data) < 2:
        raise MsgError("short message")
    (code,) = struct.unpack_from("<H", data)
    cls = _REGISTRY.get(code)
    if cls is None:
        raise MsgError(f"unknown msg code {code}")
    try:
        msg = ser.decode_msg(data[2:], cls)
    except MsgError:
        raise
    except Exception as e:  # noqa: BLE001 — untrusted bytes: any decode
        # failure (SerializeError, UnicodeDecodeError, …) is a bad message,
        # never an exception that may kill the receive path
        raise MsgError(f"{cls.__name__}: {e}") from e
    msg.validate()
    return msg


# ---------------- client <-> replica ----------------

@register
@dataclass
class ClientRequestMsg(ConsensusMsg):
    """Reference ClientRequestMsg.hpp: client-signed command submission."""
    CODE = MsgCode.ClientRequest
    sender_id: int
    req_seq_num: int
    flags: int
    request: bytes
    cid: str                      # correlation id (reference spanContext/cid)
    signature: bytes
    SPEC = [("sender_id", "u32"), ("req_seq_num", "u64"), ("flags", "u32"),
            ("request", "bytes"), ("cid", "str"), ("signature", "bytes")]

    def digest(self) -> bytes:
        return sha256(self.signed_payload())

    def validate(self) -> None:
        if not self.request and not self.flags & RequestFlag.READ_ONLY:
            raise MsgError("empty write request")


@register
@dataclass
class ClientBatchRequestMsg(ConsensusMsg):
    """Reference preprocessor/messages/ClientBatchRequestMsg.hpp: several
    individually-signed ClientRequestMsgs from ONE client ride a single
    wire message. The replica unpacks and admits each element; their
    signatures then verify as one cross-request device batch in the
    admission plane, so client batching composes with the device seam."""
    CODE = MsgCode.ClientBatchRequest
    sender_id: int
    cid: str
    requests: list                # packed ClientRequestMsg frames
    signature: bytes              # unused — authenticity is per element
    SPEC = [("sender_id", "u32"), ("cid", "str"),
            ("requests", ("list", "bytes")), ("signature", "bytes")]

    # also sizes the per-client reply cache (clients_manager) — every
    # element of an executed batch must stay regenerable for
    # retransmission recovery, so the cache covers one full batch
    MAX_BATCH: ClassVar[int] = 64

    def validate(self) -> None:
        if not self.requests:
            raise MsgError("empty client batch")
        if len(self.requests) > self.MAX_BATCH:
            raise MsgError(
                f"client batch of {len(self.requests)} > {self.MAX_BATCH}")


@register
@dataclass
class ClientReplyMsg(ConsensusMsg):
    """Reference ClientReplyMsg.hpp: execution result returned to client."""
    CODE = MsgCode.ClientReply
    sender_id: int                # replying replica
    req_seq_num: int
    current_primary: int
    reply: bytes
    replica_specific_info: bytes  # RSI — differs per replica, excluded from
                                  # quorum matching (reference rsiLength)
    # per-replica signature over the preceding fields (trailing, so
    # signed_payload() covers everything before it). Empty on the
    # certificate-backed path; populated under optimistic replies
    # (ReplicaConfig.optimistic_replies), where the client's f+1
    # matching quorum rests on these individual signatures instead of
    # the threshold certificate (arXiv 2407.12172). The canonical
    # persisted reply-ring form always zeroes it, so ledger/page bytes
    # are identical with the mode on or off.
    signature: bytes = b""
    SPEC = [("sender_id", "u32"), ("req_seq_num", "u64"),
            ("current_primary", "u32"), ("reply", "bytes"),
            ("replica_specific_info", "bytes"), ("signature", "bytes")]

    def matching_digest(self) -> bytes:
        """Digest over the parts that must match across replicas (the
        per-replica signature and RSI are excluded)."""
        return sha256(struct.pack("<Q", self.req_seq_num) + self.reply)


# ---------------- ordering ----------------

@register
@dataclass
class PrePrepareMsg(ConsensusMsg):
    """Reference PrePrepareMsg.hpp:33-53: the primary's batch proposal.

    `requests` holds packed ClientRequestMsgs; `requests_digest` commits to
    them; `time` is the primary's timestamp voted on by the time service.
    """
    CODE = MsgCode.PrePrepare
    sender_id: int
    view: int
    seq_num: int
    first_path: int               # CommitPath the primary starts on
    time: int                     # microseconds since epoch
    requests_digest: bytes
    requests: List[bytes]
    signature: bytes
    # reconfiguration era (reference PrePrepareMsg epochNum, stamped from
    # EpochManager); inside the signed payload, rejected on mismatch
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("seq_num", "u64"),
            ("first_path", "u8"), ("time", "u64"),
            ("requests_digest", "bytes"), ("requests", ("list", "bytes")),
            ("epoch", "u64"), ("signature", "bytes")]

    @staticmethod
    def compute_requests_digest(requests: List[bytes]) -> bytes:
        h = bytearray()
        for r in requests:
            h += sha256(r)
        return sha256(bytes(h))

    def digest(self) -> bytes:
        """Digest of the proposal identity (digestOfRequests + seq/view),
        the value threshold signatures commit to."""
        return calc_combination(self.requests_digest, self.view, self.seq_num)

    def validate(self) -> None:
        if self.first_path not in (0, 1, 2):
            raise MsgError("bad commit path")
        if self.requests_digest != self.compute_requests_digest(self.requests):
            raise MsgError("requests digest mismatch")

    def client_requests(self) -> List[ClientRequestMsg]:
        # memoized: the batch is parsed once (by the admission plane when
        # it is on, by the first handler otherwise) and every later
        # consumer — structural checks, barrier classification, execution
        # — reuses the same objects. Safe because `requests` is never
        # mutated after construction/decode.
        cached = getattr(self, "_reqs_cache", None)
        if cached is not None:
            return cached
        out = []
        for raw in self.requests:
            m = unpack(raw)
            if not isinstance(m, ClientRequestMsg):
                raise MsgError("non-request in PrePrepare batch")
            out.append(m)
        self._reqs_cache = out
        return out


def commit_digest(view: int, seq_num: int, pp_digest: bytes) -> bytes:
    """Digest::calcCombination(ppDigest, view, seq) equivalent
    (reference ReplicaImp.cpp:1344): the value signed by commit-path
    threshold shares."""
    return calc_combination(pp_digest, view, seq_num)


@register
@dataclass
class StartSlowCommitMsg(ConsensusMsg):
    """Reference StartSlowCommitMsg.hpp: primary demotes seq to slow path."""
    CODE = MsgCode.StartSlowCommit
    sender_id: int
    view: int
    seq_num: int
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("seq_num", "u64"),
            ("epoch", "u64")]


@dataclass
class _SignedShareBase(ConsensusMsg):
    """Reference SignedShareMsgs.hpp SignedShareBase: a threshold-signature
    share (or combined signature) over the commit digest for (view, seq)."""
    sender_id: int
    view: int
    seq_num: int
    digest: bytes                 # share_digest(kind, epoch, view, seq, ppD)
    sig: bytes                    # share (Partial) or combined (Full)
    epoch: int = 0                # reconfiguration era (SignedShareMsgs
                                  # carry epochNum in the reference too).
                                  # The era is ALSO bound inside `digest`
                                  # (replica.share_digest), so the gate on
                                  # these messages is authenticated — this
                                  # wire field is a fast-drop hint only
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("seq_num", "u64"),
            ("digest", "bytes"), ("sig", "bytes"), ("epoch", "u64")]

    def validate(self) -> None:
        if len(self.digest) != 32:
            raise MsgError("bad digest length")
        if not self.sig:
            raise MsgError("empty signature share")


@register
@dataclass
class PreparePartialMsg(_SignedShareBase):
    CODE = MsgCode.PreparePartial


@register
@dataclass
class PrepareFullMsg(_SignedShareBase):
    CODE = MsgCode.PrepareFull


@register
@dataclass
class CommitPartialMsg(_SignedShareBase):
    CODE = MsgCode.CommitPartial


@register
@dataclass
class CommitFullMsg(_SignedShareBase):
    CODE = MsgCode.CommitFull


@register
@dataclass
class PartialCommitProofMsg(_SignedShareBase):
    """Fast-path share (reference PartialCommitProofMsg.hpp); `path` tells
    the collector which quorum size applies."""
    CODE = MsgCode.PartialCommitProof
    path: int = int(CommitPath.OPTIMISTIC_FAST)
    SPEC = _SignedShareBase.SPEC + [("path", "u8")]

    def validate(self) -> None:
        super().validate()
        if self.path not in (0, 1):
            raise MsgError("bad fast path")


@register
@dataclass
class FullCommitProofMsg(_SignedShareBase):
    """Fast-path combined proof (reference FullCommitProofMsg.hpp) —
    possession is a commit certificate."""
    CODE = MsgCode.FullCommitProof


@register
@dataclass
class AggregateShareMsg(ConsensusMsg):
    """A PARTIAL AGGREGATE climbing the share-aggregation overlay
    (arXiv 1911.04698): an interior node's sum of its
    subtree's Prepare/Commit shares, self-authenticating via the
    contributor bitmap inside `agg` (crypto/systems.pack_agg_cert —
    the root verifies it against the bitmap's aggregate public key, so
    a forged partial indicts exactly the forwarding subtree). `kind`
    is the share family ("prepare"=0 / "commit"=1); fast-path shares
    never aggregate (they are already one datagram to the collector).
    NOT relay-safe: the transport sender is the accountable forwarder
    for retransmission/ack and bad-subtree isolation."""
    CODE = MsgCode.AggregateShare
    sender_id: int
    view: int
    seq_num: int
    kind: int                     # 0 = prepare share family, 1 = commit
    digest: bytes                 # share_digest(kind, epoch, view, seq, ppD)
    agg: bytes                    # pack_agg_cert: u64 bitmap + 48B G1 sum
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("seq_num", "u64"),
            ("kind", "u8"), ("digest", "bytes"), ("agg", "bytes"),
            ("epoch", "u64")]

    def validate(self) -> None:
        if self.kind not in (0, 1):
            raise MsgError("bad aggregate share kind")
        if len(self.digest) != 32:
            raise MsgError("bad digest length")
        if len(self.agg) != 56:
            raise MsgError("bad partial aggregate length")


# ---------------- checkpointing ----------------

@register
@dataclass
class AskForCheckpointMsg(ConsensusMsg):
    """Any node → a replica: please (re)send your latest self
    CheckpointMsg (reference AskForCheckpointMsg.hpp — sent periodically
    by read-only replicas so a late joiner doesn't wait a whole
    checkpoint window for the next broadcast). Unsigned: the reply is
    bounded, already-signed traffic."""
    CODE = MsgCode.AskForCheckpoint
    sender_id: int
    SPEC = [("sender_id", "u32")]


@register
@dataclass
class CheckpointMsg(ConsensusMsg):
    """Reference CheckpointMsg.hpp: signed app-state digest at a checkpoint
    seqnum (every checkpointWindowSize=150); f+1 matching ⇒ stable."""
    CODE = MsgCode.Checkpoint
    sender_id: int
    seq_num: int
    state_digest: bytes
    is_stable: bool
    # reserved-pages digest is part of the signed certificate (reference
    # CheckpointMsg carries stateDigest + reservedPagesDigest + rvbDigest)
    res_pages_digest: bytes = b""
    signature: bytes = b""
    # era of the certifying replica: lower-epoch checkpoints are stale
    # and dropped; higher-epoch ones are evidence this replica lags a
    # reconfiguration and feed state-transfer catch-up
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("seq_num", "u64"),
            ("state_digest", "bytes"), ("is_stable", "bool"),
            ("res_pages_digest", "bytes"), ("epoch", "u64"),
            ("signature", "bytes")]


@register
@dataclass
class SimpleAckMsg(ConsensusMsg):
    """Reference SimpleAckMsg.hpp: ack for retransmittable msgs."""
    CODE = MsgCode.SimpleAck
    sender_id: int
    seq_num: int
    view: int
    acked_msg_code: int
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("seq_num", "u64"), ("view", "u64"),
            ("acked_msg_code", "u16"), ("epoch", "u64")]


@register
@dataclass
class TimeOpinionMsg(ConsensusMsg):
    """A replica's signed clock reading (time-service voting extension of
    the reference TimeServiceManager.hpp model, where each replica only
    bounds the primary's stamp against its LOCAL clock): collecting f+1
    fresh opinions lets every replica bound the primary against the
    CLUSTER's median clock, so one fast primary + one fast backup clock
    cannot drift the agreed time."""
    CODE = MsgCode.TimeOpinion
    sender_id: int
    t_ms: int                     # sender's clock, ms since epoch
    signature: bytes
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("t_ms", "u64"), ("epoch", "u64"),
            ("signature", "bytes")]


# ---------------- pre-execution (reference src/preprocessor/messages) ----

@register
@dataclass
class PreProcessRequestMsg(ConsensusMsg):
    """Primary → all replicas: speculatively execute this client request
    (reference PreProcessRequestMsg.hpp)."""
    CODE = MsgCode.PreProcessRequest
    sender_id: int              # the primary
    client_id: int
    req_seq_num: int
    retry_id: int
    request: bytes              # packed original ClientRequestMsg
    SPEC = [("sender_id", "u32"), ("client_id", "u32"),
            ("req_seq_num", "u64"), ("retry_id", "u64"),
            ("request", "bytes")]


@register
@dataclass
class PreProcessBatchRequestMsg(ConsensusMsg):
    """Primary → all replicas: a GROUP of PreProcessRequestMsgs for one
    client, one wire message (reference PreProcessBatchRequestMsg.hpp —
    the wire-level half of client batching: per-element sessions,
    grouped transport)."""
    CODE = MsgCode.PreProcessBatchRequest
    sender_id: int              # the primary
    client_id: int
    batch_id: int               # primary-local group id for reply folding
    requests: list              # packed PreProcessRequestMsg frames
    SPEC = [("sender_id", "u32"), ("client_id", "u32"),
            ("batch_id", "u64"), ("requests", ("list", "bytes"))]

    def validate(self) -> None:
        if not self.requests:
            raise MsgError("empty preprocess batch")
        if len(self.requests) > ClientBatchRequestMsg.MAX_BATCH:
            raise MsgError("preprocess batch too large")


@register
@dataclass
class PreProcessBatchReplyMsg(ConsensusMsg):
    """Replica → primary: all of a batch's speculative-result replies
    folded into one wire message (reference PreProcessBatchReplyMsg.hpp)."""
    CODE = MsgCode.PreProcessBatchReply
    sender_id: int
    client_id: int
    batch_id: int
    replies: list               # packed PreProcessReplyMsg frames
    SPEC = [("sender_id", "u32"), ("client_id", "u32"),
            ("batch_id", "u64"), ("replies", ("list", "bytes"))]

    def validate(self) -> None:
        if not self.replies:
            raise MsgError("empty preprocess batch reply")
        if len(self.replies) > ClientBatchRequestMsg.MAX_BATCH:
            raise MsgError("preprocess batch reply too large")


@register
@dataclass
class PreProcessReplyMsg(ConsensusMsg):
    """Replica → primary: signed digest of its speculative result
    (reference PreProcessReplyMsg.hpp)."""
    CODE = MsgCode.PreProcessReply
    sender_id: int
    client_id: int
    req_seq_num: int
    retry_id: int
    result_digest: bytes
    status: int                 # 0 = ok, 1 = rejected/unsupported
    signature: bytes            # over preexec_digest binding below
    SPEC = [("sender_id", "u32"), ("client_id", "u32"),
            ("req_seq_num", "u64"), ("retry_id", "u64"),
            ("result_digest", "bytes"), ("status", "u8"),
            ("signature", "bytes")]


@dataclass
class PreProcessResult:
    """The ordered artifact replacing the raw request: original request +
    agreed speculative result + f+1 replica signatures (reference
    PreProcessResultMsg.hpp — a ClientRequestMsg subclass on the wire;
    here it is the wrapper request's payload)."""
    original: bytes             # packed original ClientRequestMsg
    result: bytes
    signatures: list            # [(replica_id, sig)]
    SPEC = [("original", "bytes"), ("result", "bytes"),
            ("signatures", ("list", ("pair", "u32", "bytes")))]


def preexec_digest(client_id: int, req_seq: int, original: bytes,
                   result: bytes) -> bytes:
    """What PreProcessReply signatures cover: the binding of a concrete
    request to its speculative result."""
    return sha256(b"preexec" + struct.pack("<IQ", client_id, req_seq)
                  + sha256(original) + sha256(result))


# ---------------- view change ----------------

@dataclass
class PreparedCertificate:
    """Evidence inside ViewChangeMsg that a seqnum may have committed in an
    earlier view (reference ViewChangeMsg element + PrepareFull proof).

    Carries only the PrePrepare DIGEST, not the batch body — the reference
    ships digests and fetches missing PrePrepares during view entry
    (ReplicaImp.cpp:1078 addPotentiallyMissingPP); embedding bodies made a
    ViewChangeMsg O(batch x window) bytes."""
    seq_num: int
    view: int                     # view in which it was prepared
    kind: int                     # which threshold system signed it
                                  # (view_change.CERT_* constants)
    pp_digest: bytes
    combined_sig: bytes           # PrepareFull/FullCommitProof combined sig
    SPEC = [("seq_num", "u64"), ("view", "u64"), ("kind", "u8"),
            ("pp_digest", "bytes"), ("combined_sig", "bytes")]


@register
@dataclass
class ViewChangeMsg(ConsensusMsg):
    """Reference ViewChangeMsg.hpp: replica's signed statement entering a
    new view: last stable checkpoint + prepared certificates in-flight."""
    CODE = MsgCode.ViewChange
    sender_id: int
    new_view: int
    last_stable_seq: int
    prepared: List[PreparedCertificate]
    signature: bytes
    # a dead-era ViewChangeMsg must not count toward a live-era f+1
    # view-change threshold — epoch rides the signed payload like the
    # other ordering messages
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("new_view", "u64"),
            ("last_stable_seq", "u64"),
            ("prepared", ("list", ("msg", PreparedCertificate))),
            ("epoch", "u64"), ("signature", "bytes")]

    def digest(self) -> bytes:
        return sha256(self.signed_payload())


@dataclass
class ReplicaDigest:
    """(replica id, digest-or-signature bytes) pair used in certificates."""
    replica: int
    digest: bytes
    SPEC = [("replica", "u32"), ("digest", "bytes")]


@register
@dataclass
class NewViewMsg(ConsensusMsg):
    """Reference NewViewMsg.hpp: new primary's certificate — digests of the
    2f+2c+1 ViewChangeMsgs it built the new view from."""
    CODE = MsgCode.NewView
    sender_id: int
    new_view: int
    view_change_digests: List[ReplicaDigest]
    signature: bytes
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("new_view", "u64"),
            ("view_change_digests", ("list", ("msg", ReplicaDigest))),
            ("epoch", "u64"), ("signature", "bytes")]


@register
@dataclass
class ReplicaAsksToLeaveViewMsg(ConsensusMsg):
    """Reference ReplicaAsksToLeaveViewMsg.hpp: signed view-change
    complaint; f+1 of these start an actual view change."""
    CODE = MsgCode.ReplicaAsksToLeaveView
    sender_id: int
    view: int
    reason: int                   # enum: timeout=0, primary-misbehavior=1…
    signature: bytes
    epoch: int = 0                # dead-era complaints must not count
                                  # toward a live-era f+1 threshold
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("reason", "u8"),
            ("epoch", "u64"), ("signature", "bytes")]


# ---------------- recovery / status ----------------

@register
@dataclass
class ReqMissingDataMsg(ConsensusMsg):
    """Reference ReqMissingDataMsg.hpp: ask a peer for missing protocol
    msgs for a seqnum (bitmask of what's needed)."""
    CODE = MsgCode.ReqMissingData
    sender_id: int
    view: int
    seq_num: int
    missing: int                  # bitmask: 1=PrePrepare, 2=PrepareFull,
                                  # 4=CommitFull, 8=FullCommitProof
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("seq_num", "u64"),
            ("missing", "u32")]


@register
@dataclass
class ReqViewPrePrepareMsg(ConsensusMsg):
    """Fetch an old-view PrePrepare body referenced (by digest) from a
    view-change restriction (reference addPotentiallyMissingPP,
    ReplicaImp.cpp:1078): ViewChangeMsgs carry digests only, so a replica
    entering `new_view` must obtain any batch body it lacks before it can
    re-propose or validate re-proposals. Unsigned like ReqMissingData —
    a spoofed request costs a bounded resend. The response is the raw
    packed original PrePrepareMsg; the requester authenticates it by
    digest, which the threshold certificate already certifies."""
    CODE = MsgCode.ReqViewPrePrepare
    sender_id: int
    new_view: int                 # view being entered (routing/context)
    seq_num: int
    pp_digest: bytes
    SPEC = [("sender_id", "u32"), ("new_view", "u64"), ("seq_num", "u64"),
            ("pp_digest", "bytes")]


# Capability bits advertised in ReplicaStatusMsg.capabilities:
# a wire-visible declaration of optional planes so
# mixed clusters are DETECTABLE — peers record what each replica
# advertises (surfaced via `status get health`), clients infer the
# optimistic plane from signed replies. No negotiation logic rides
# these bits yet; they are observability, not protocol.
CAP_OPT_REPLIES = 1 << 0     # optimistic reply plane active
CAP_OFFLOAD = 1 << 1         # verified crypto-offload tier configured


@register
@dataclass
class ReplicaStatusMsg(ConsensusMsg):
    """Reference ReplicaStatusMsg.hpp: periodic gap-detection beacon.
    Carries the sender's capability bitmap (see CAP_*): status beacons
    reach every peer on a timer, making them the natural place to
    advertise optional planes without a new message type."""
    CODE = MsgCode.ReplicaStatus
    sender_id: int
    view: int
    last_stable_seq: int
    last_executed_seq: int
    in_view_change: bool
    capabilities: int = 0
    SPEC = [("sender_id", "u32"), ("view", "u64"), ("last_stable_seq", "u64"),
            ("last_executed_seq", "u64"), ("in_view_change", "bool"),
            ("capabilities", "u32")]


@register
@dataclass
class StateTransferMsg(ConsensusMsg):
    """Opaque envelope for the state-transfer module's own messages
    (reference StateTransferMsg.hpp → BCStateTran wire msgs)."""
    CODE = MsgCode.StateTransfer
    sender_id: int
    payload: bytes
    SPEC = [("sender_id", "u32"), ("payload", "bytes")]


@register
@dataclass
class ReplicaRestartReadyMsg(ConsensusMsg):
    """Reference ReplicaRestartReadyMsg.hpp: signed 'ready to restart' vote
    (n/n super-stable wedge for upgrades)."""
    CODE = MsgCode.ReplicaRestartReady
    sender_id: int
    seq_num: int
    reason: int
    signature: bytes
    epoch: int = 0
    SPEC = [("sender_id", "u32"), ("seq_num", "u64"), ("reason", "u8"),
            ("epoch", "u64"), ("signature", "bytes")]


@register
@dataclass
class RestartProofMsg(ConsensusMsg):
    """Reference RestartProofMsg: n ReplicaRestartReady sigs combined."""
    CODE = MsgCode.RestartProof
    sender_id: int
    seq_num: int
    signatures: List[ReplicaDigest]
    SPEC = [("sender_id", "u32"), ("seq_num", "u64"),
            ("signatures", ("list", ("msg", ReplicaDigest)))]


# Messages carrying their own end-to-end signature (replica sig or
# threshold combined sig, verified in their handlers): relay-safe — the
# transport sender may legitimately differ from sender_id (gap-resend +
# ReqMissingData flows forward them on the original's behalf). Shared by
# the dispatcher's anti-spoofing gate and the admission plane's
# stateless pre-drop, so the two can never disagree.
RELAY_SAFE = (PrePrepareMsg, PrepareFullMsg, CommitFullMsg,
              FullCommitProofMsg, ViewChangeMsg, NewViewMsg, CheckpointMsg)


def known_code(code: int) -> bool:
    """True iff `code` is a registered wire discriminant (the admission
    plane's cheapest pre-parse drop for garbage datagrams)."""
    return code in _REGISTRY


def client_request_admissible(req: ClientRequestMsg, info) -> bool:
    """Topology-static flag gates for a wire client request: the
    INTERNAL flag and internal-client principals must correspond
    (external clients can't smuggle internal ops and vice versa),
    ordered (non-READ_ONLY) RECONFIG commands only from the operator,
    and HAS_PRE_PROCESSED may only be minted by the preprocessor (it
    enters via _admit_request, never from the wire). Shared by the
    dispatcher's client-request handler and the admission plane's
    pre-verify drop so the two can never disagree — an admission-side
    drop is final, so drift between copies would silently lose
    messages only when admission is on."""
    if bool(req.flags & RequestFlag.INTERNAL) \
            != info.is_internal_client(req.sender_id):
        return False
    if req.flags & RequestFlag.RECONFIG \
            and not req.flags & RequestFlag.READ_ONLY \
            and req.sender_id != info.operator_id:
        return False
    if req.flags & RequestFlag.HAS_PRE_PROCESSED:
        return False
    return True


def parse_batch_elements(batch: ClientBatchRequestMsg):
    """Structural element checks for a client batch (reference
    ClientBatchRequestMsg::checkElements): every element must decode to
    a ClientRequestMsg from the SAME principal; a malformed element
    rejects the whole batch. Returns the parsed elements, or None.
    Shared by the admission plane and the dispatcher's legacy inline
    path so the two can never disagree about batch structure."""
    inners = []
    for raw in batch.requests:
        try:
            inner = unpack(raw)
        except MsgError:
            return None
        if not isinstance(inner, ClientRequestMsg) \
                or inner.sender_id != batch.sender_id:
            return None
        inners.append(inner)
    return inners
