"""Cluster key material generation and per-replica key views (port of
tpubft/consensus/keys.py).

Rebuild of concord-bft's key tooling (tools/GenerateConcordKeys.cpp +
KeyfileIOUtils.cpp) and CryptoManager's per-path threshold systems
(bftengine/include/bftengine/CryptoManager.hpp:109-111: slow path signs
with threshold 2f+c+1, fast-with-threshold 3f+c+1, optimistic n).

Deterministic from a seed so tests and multi-process harnesses can derive
identical key material without shipping files; real deployments serialize
`ClusterKeys.to_json()` per replica (private material included only in each
replica's own view).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpubft_torch.crypto.cpu import make_signer, make_verifier
from tpubft_torch.crypto.interfaces import (Cryptosystem, ISigner,
                                            IThresholdSigner,
                                            IThresholdVerifier, IVerifier)
from tpubft_torch.utils.config import ReplicaConfig


def _derive_seed(root: bytes, *labels) -> bytes:
    h = hashlib.sha256(root)
    for lab in labels:
        h.update(str(lab).encode())
        h.update(b"|")
    return h.digest()


@dataclass
class ClusterKeys:
    """All public material + this node's private material."""
    n: int
    f: int
    c: int
    threshold_scheme: str
    # per-principal-class signature schemes (reference SigManager builds a
    # scheme-specific verifier per principal from the keyfile — RSA/EdDSA
    # for replicas, optionally ECDSA-secp256k1 for clients, the BASELINE
    # config-3/5 mix): replicas sign consensus msgs with one scheme,
    # external clients (and the operator) may use another
    replica_sig_scheme: str = "ed25519"
    client_sig_scheme: str = "ed25519"
    # per-message signing (SigManager principals)
    replica_pubkeys: Dict[int, bytes] = field(default_factory=dict)
    client_pubkeys: Dict[int, bytes] = field(default_factory=dict)
    # private: only for this node
    my_id: Optional[int] = None
    my_sign_seed: Optional[bytes] = None
    operator_id: Optional[int] = None
    # threshold cryptosystems per commit path (shared public material;
    # secret shares live inside — prune for untrusted serialization)
    slow_path_system: Optional[Cryptosystem] = None
    commit_path_system: Optional[Cryptosystem] = None
    optimistic_system: Optional[Cryptosystem] = None

    @classmethod
    def generate(cls, cfg: ReplicaConfig, num_clients: int,
                 seed: bytes = b"tpubft-test-cluster") -> "ClusterKeys":
        """Generate the full cluster's material (test/keygen-tool path —
        the reference's GenerateConcordKeys writes one file per replica)."""
        n, f, c = cfg.n_val, cfg.f_val, cfg.c_val
        # "adaptive" resolves HERE, once, from cluster size: the scheme
        # is baked into the generated key material, so every replica and
        # every carried certificate (view change, state transfer) agrees
        # by construction (crypto/systems.resolve_threshold_scheme)
        from tpubft_torch.crypto.systems import resolve_threshold_scheme
        scheme = resolve_threshold_scheme(
            cfg.threshold_scheme, n,
            getattr(cfg, "threshold_scheme_crossover_n", 0),
            aggregation=getattr(cfg, "share_aggregation", "off"))
        ck = cls(n=n, f=f, c=c, threshold_scheme=scheme,
                 replica_sig_scheme=cfg.replica_sig_scheme,
                 client_sig_scheme=cfg.client_sig_scheme)
        for r in range(n):
            s = make_signer(ck.replica_sig_scheme,
                            seed=_derive_seed(seed, "replica", r))
            ck.replica_pubkeys[r] = s.public_bytes()
        first_client = n + cfg.num_ro_replicas
        for cl in range(first_client, first_client + num_clients):
            s = make_signer(ck.client_sig_scheme,
                            seed=_derive_seed(seed, "client", cl))
            ck.client_pubkeys[cl] = s.public_bytes()
        # operator principal (reconfiguration commands): its id must match
        # ReplicasInfo.operator_id, which derives from the CONFIG's client
        # count — not this function's num_clients parameter (callers may
        # generate extra client keys). Distinct seed label so no client
        # enumeration can ever mint the operator's keypair.
        operator_id = first_client + cfg.num_of_client_proxies + n
        s = make_signer(ck.client_sig_scheme,
                        seed=_derive_seed(seed, "operator", operator_id))
        ck.client_pubkeys[operator_id] = s.public_bytes()
        ck.operator_id = operator_id
        ck.slow_path_system = Cryptosystem(
            scheme, 2 * f + c + 1, n, seed=_derive_seed(seed, "slow"))
        ck.commit_path_system = Cryptosystem(
            scheme, 3 * f + c + 1, n, seed=_derive_seed(seed, "fastthresh"))
        ck.optimistic_system = Cryptosystem(
            scheme, n, n, seed=_derive_seed(seed, "optimistic"))
        ck._seed = seed
        return ck

    def for_node(self, node_id: int) -> "ClusterKeys":
        """This node's private view (sign seed derivation)."""
        if node_id == self.operator_id:
            kind = "operator"
        elif node_id < self.n:
            kind = "replica"
        else:
            kind = "client"
        me = ClusterKeys(
            n=self.n, f=self.f, c=self.c,
            threshold_scheme=self.threshold_scheme,
            replica_sig_scheme=self.replica_sig_scheme,
            client_sig_scheme=self.client_sig_scheme,
            replica_pubkeys=self.replica_pubkeys,
            client_pubkeys=self.client_pubkeys,
            my_id=node_id, operator_id=self.operator_id,
            my_sign_seed=_derive_seed(self._seed, kind, node_id),
            slow_path_system=self.slow_path_system,
            commit_path_system=self.commit_path_system,
            optimistic_system=self.optimistic_system)
        me._seed = self._seed
        return me

    # ---- accessors ----
    def scheme_of(self, node: int) -> str:
        """Signature scheme for a principal: replicas (incl. read-only ids
        below the first client) sign with the replica scheme, every client
        principal (operator included) with the client scheme."""
        return (self.replica_sig_scheme if node in self.replica_pubkeys
                else self.client_sig_scheme)

    def my_signer(self) -> ISigner:
        assert self.my_sign_seed is not None
        return make_signer(self.scheme_of(self.my_id)
                           if self.my_id is not None
                           else self.replica_sig_scheme,
                           seed=self.my_sign_seed)

    def verifier_of(self, node: int) -> IVerifier:
        pk = self.replica_pubkeys.get(node) or self.client_pubkeys.get(node)
        if pk is None:
            raise KeyError(f"no public key for node {node}")
        return make_verifier(self.scheme_of(node), pk)

    def threshold_signer(self, system: Cryptosystem,
                         replica_id: int) -> IThresholdSigner:
        """Threshold signer ids are 1-based in the reference."""
        return system.create_threshold_signer(replica_id + 1)

    def threshold_verifier(self, system: Cryptosystem,
                           backend: str = "cpu",
                           min_device_batch: int = 1) -> IThresholdVerifier:
        """Backend-selected threshold verifier over the same key material
        (concord-bft: Cryptosystem::createThresholdVerifier,
        ThresholdSignaturesTypes.cpp:183 — the CUDA backend slots in
        behind the identical boundary)."""
        if backend == "cuda":
            from tpubft_torch.crypto import cuda as cuda_backend
            return cuda_backend.make_threshold_verifier(
                system.type_name, system.threshold_, system.num_signers,
                system.public_key, system.share_public_keys,
                min_device_batch)
        return system.create_threshold_verifier()
