"""State transfer — bringing lagging/new replicas to the cluster's state
(port of tpubft/statetransfer/).

Rebuild of concord-bft bftengine/src/bcstatetransfer/ (BCStateTran,
RVBManager + RangeValidationTree, SourceSelector): checkpoint-summary
agreement (f+1 matching), sourced block fetching with chunking, and
per-block integrity proofs against an append-only digest tree so a
Byzantine source is caught on the first bad block, not at the end. A
completed window's leaf digests go through statetransfer/digests.py, the
batched SHA-256 kernel at 16 blocks and more.
"""
from tpubft_torch.statetransfer.manager import StateTransferManager
from tpubft_torch.statetransfer.rvt import RangeValidationTree

__all__ = ["StateTransferManager", "RangeValidationTree"]
