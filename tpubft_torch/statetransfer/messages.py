"""State-transfer wire messages (a copy of tpubft/statetransfer/messages.py),
carried inside the consensus-level
StateTransferMsg envelope (reference: bcstatetransfer/Messages.hpp —
AskForCheckpointSummariesMsg, CheckpointSummaryMsg, FetchBlocksMsg,
ItemDataMsg, RejectFetchingMsg).

Concurrency contract: the destination may keep SEVERAL FetchBlocks
ranges outstanding at once, each under its own `msg_id` and each against
a different source (the pipelined fetch window). `reply_to` is therefore
the range identity — a source answers with the msg_id it was asked
under, and late/stray ItemData for a range that was re-assigned simply
misses the window and is dropped. Sources need no new state: each
FetchBlocks is still served independently."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from tpubft_torch.statetransfer.rvt import RvtProof
from tpubft_torch.utils import serialize as ser


@dataclass
class AskForCheckpointSummaries:
    ID = 1
    msg_id: int = 0              # nonce echoed in replies
    min_checkpoint_seq: int = 0
    SPEC = [("msg_id", "u64"), ("min_checkpoint_seq", "u64")]


@dataclass
class CheckpointSummary:
    ID = 2
    reply_to: int = 0
    checkpoint_seq: int = 0
    state_digest: bytes = b""
    last_block: int = 0
    rvt_root: bytes = b""
    res_pages_digest: bytes = b""
    SPEC = [("reply_to", "u64"), ("checkpoint_seq", "u64"),
            ("state_digest", "bytes"), ("last_block", "u64"),
            ("rvt_root", "bytes"), ("res_pages_digest", "bytes")]

    def key(self):
        return (self.checkpoint_seq, self.state_digest, self.last_block,
                self.rvt_root, self.res_pages_digest)


@dataclass
class FetchBlocks:
    """Block-range fetch. `target_last_block` is the AGREED summary's last
    block: the source must build RVT proofs at that historical leaf count
    (the append-only MMR supports old sizes), not its own — its stable
    checkpoint may advance mid-transfer, and proofs built at the newer size
    would never verify against the agreed root (destination pins the
    agreed (root, n) for the whole transfer)."""
    ID = 3
    msg_id: int = 0
    from_block: int = 0
    to_block: int = 0
    target_last_block: int = 0
    SPEC = [("msg_id", "u64"), ("from_block", "u64"), ("to_block", "u64"),
            ("target_last_block", "u64")]


@dataclass
class ItemData:
    """One chunk of one block. INVARIANT (enforced by the destination):
    every chunk of the same block must carry the same `total_chunks` and
    the same `proof` — a source flipping either mid-block is malformed
    and is punished, so byzantine metadata can never confuse reassembly
    or smuggle a second proof past the window verification."""
    ID = 4
    reply_to: int = 0
    block_id: int = 0
    chunk_idx: int = 0
    total_chunks: int = 1
    payload: bytes = b""
    # membership proof of the whole block's digest at the agreed rvt size
    proof: RvtProof = field(default_factory=RvtProof)
    last_in_response: bool = False
    SPEC = [("reply_to", "u64"), ("block_id", "u64"), ("chunk_idx", "u32"),
            ("total_chunks", "u32"), ("payload", "bytes"),
            ("proof", ("msg", RvtProof)), ("last_in_response", "bool")]


@dataclass
class RejectFetching:
    ID = 5
    reply_to: int = 0
    reason: str = ""
    SPEC = [("reply_to", "u64"), ("reason", "str")]


@dataclass
class FetchResPages:
    """Reserved-pages fetch, after blocks are linked (reference
    FetchResPagesMsg)."""
    ID = 6
    msg_id: int = 0
    SPEC = [("msg_id", "u64")]


@dataclass
class ResPagesData:
    ID = 7
    reply_to: int = 0
    chunk_idx: int = 0
    total_chunks: int = 1
    pages: List = field(default_factory=list)  # [(page_key, page_bytes)]
    SPEC = [("reply_to", "u64"), ("chunk_idx", "u32"),
            ("total_chunks", "u32"),
            ("pages", ("list", ("pair", "bytes", "bytes")))]


_TYPES = {cls.ID: cls for cls in
          (AskForCheckpointSummaries, CheckpointSummary, FetchBlocks,
           ItemData, RejectFetching, FetchResPages, ResPagesData)}


def pack(msg) -> bytes:
    return bytes([msg.ID]) + ser.encode_msg(msg)


def unpack(data: bytes):
    if not data or data[0] not in _TYPES:
        raise ser.SerializeError(f"unknown ST msg id {data[:1]!r}")
    return ser.decode_msg(data[1:], _TYPES[data[0]])
