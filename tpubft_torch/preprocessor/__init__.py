"""Pre-execution — optimistic parallel execution before ordering (port of
tpubft/preprocessor/__init__.py).

Rebuild of concord-bft bftengine/src/preprocessor/ (PreProcessor.hpp:126,
PreProcessor.cpp: sendPreProcessRequestToAllReplicas :1690,
launchAsyncReqPreProcessingJob :1008): a PRE_PROCESS-flagged client
request is speculatively executed on all replicas BEFORE ordering; the
primary collects f+1 matching signed result digests, then orders a
PreProcessResult wrapper (original request + result + signatures) instead
of the raw request. At commit, the handler applies the pre-executed
result with conflict detection — execution cost is off the ordering
critical path.

Speculative execution runs on a thread pool (the reference's preprocessor
pool); all protocol state lives on the consensus dispatcher thread, with
completions re-entering through the internal message queue.
"""
from tpubft_torch.preprocessor.preprocessor import PreProcessor

__all__ = ["PreProcessor"]
