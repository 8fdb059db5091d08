"""Thin replica — streaming committed updates to untrusted clients (port of
tpubft/thinreplica/__init__.py).

Rebuild of concord-bft thin-replica-server/ (ThinReplicaImpl,
thin_replica_impl.hpp:98; proto/thin_replica.proto:26-47 — ReadState,
ReadStateHash, SubscribeToUpdates, SubscribeToUpdateHashes, Unsubscribe)
and concord-bft client/thin-replica-client/: a client obtains the
full update stream from ONE server and matching update HASHES from f
other servers, so no single untrusted server can forge state. gRPC is
replaced by a length-framed TCP protocol over the same message-codec
machinery as the rest of the framework; live updates are fed from the
blockchain commit path through per-subscriber buffers (SubUpdateBuffer),
with history served from the chain for catch-up.

The kvbc_app_filter role (client-visible event filtering + hashing) is
FilterSpec: category + key-prefix selection with a canonical per-block
update hash.
"""
from tpubft_torch.thinreplica.client import ThinReplicaClient, keys_cert_verifier
from tpubft_torch.thinreplica.server import FilterSpec, ThinReplicaServer

__all__ = ["ThinReplicaServer", "ThinReplicaClient", "FilterSpec",
           "keys_cert_verifier"]
