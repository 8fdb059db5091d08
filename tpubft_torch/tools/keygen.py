"""Key generation + validation tool (port of tpubft/tools/keygen.py,
the same keyfiles).

Rebuild of concord-bft tools/GenerateConcordKeys.cpp +
TestGeneratedKeys.cpp + KeyfileIOUtils.cpp: writes one keyfile per
principal (replicas, clients, operator) containing the cluster's public
material plus that principal's private seed — optionally encrypted at
rest with the secrets manager.

Usage:
  python -m tpubft_torch.tools.keygen generate -f 1 --clients 4 -o keys/ \
      [--seed S] [--password PW]
  python -m tpubft_torch.tools.keygen verify keys/replica-0.keys [--password PW]
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import sys
from typing import Optional

from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.utils.config import ReplicaConfig


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def keyfile_dict(keys: ClusterKeys) -> dict:
    """Serialized per-node view (private seed included — encrypt!)."""
    return {
        "n": keys.n, "f": keys.f, "c": keys.c,
        "threshold_scheme": keys.threshold_scheme,
        "replica_sig_scheme": keys.replica_sig_scheme,
        "client_sig_scheme": keys.client_sig_scheme,
        "my_id": keys.my_id,
        "my_sign_seed": _b64(keys.my_sign_seed),
        "operator_id": keys.operator_id,
        "replica_pubkeys": {str(k): _b64(v)
                            for k, v in keys.replica_pubkeys.items()},
        "client_pubkeys": {str(k): _b64(v)
                           for k, v in keys.client_pubkeys.items()},
    }


def _manager(password: Optional[str]):
    if password:
        from tpubft_torch.secrets import SecretsManagerEnc
        return SecretsManagerEnc(password.encode())
    from tpubft_torch.secrets import SecretsManagerPlain
    return SecretsManagerPlain()


def generate(args) -> int:
    cfg = ReplicaConfig(f_val=args.f, c_val=args.c,
                        num_ro_replicas=args.ro,
                        num_of_client_proxies=args.clients)
    cluster = ClusterKeys.generate(cfg, args.clients,
                                   seed=args.seed.encode())
    os.makedirs(args.out, exist_ok=True)
    sm = _manager(args.password)
    names = {}
    for r in range(cfg.n_val):
        names[cluster.for_node(r).my_id] = f"replica-{r}.keys"
    for ro in range(cfg.n_val, cfg.n_val + args.ro):
        names[ro] = f"ro-replica-{ro}.keys"
    first_client = cfg.n_val + cfg.num_ro_replicas
    for cl in range(first_client, first_client + args.clients):
        names[cl] = f"client-{cl}.keys"
    names[cluster.operator_id] = "operator.keys"
    for node_id, fname in names.items():
        view = cluster.for_node(node_id)
        raw = json.dumps(keyfile_dict(view), indent=1).encode()
        sm.encrypt_file(os.path.join(args.out, fname), raw)
    if args.tls_certs:
        # per-node TLS material for the pinned-cert transport (concord-bft
        # GenerateConcordKeys' cert emission for TlsTCPCommunication).
        # ALWAYS random keys: a TLS certificate is public (any handshake
        # reveals it), so a seed-derivable private key would let anyone
        # knowing the seed impersonate every node
        from tpubft_torch.comm.tls import generate_tls_material
        generate_tls_material(args.out, sorted(names), seed=None,
                              password=args.password)
        print(f"wrote TLS certs for {len(names)} nodes to {args.out}")
    print(f"wrote {len(names)} keyfiles to {args.out}")
    return 0


def load_keyfile(path: str, password: Optional[str] = None) -> ClusterKeys:
    sm = _manager(password)
    d = json.loads(sm.decrypt_file(path).decode())
    keys = ClusterKeys(
        n=d["n"], f=d["f"], c=d["c"],
        threshold_scheme=d["threshold_scheme"], my_id=d["my_id"],
        replica_sig_scheme=d.get("replica_sig_scheme", "ed25519"),
        client_sig_scheme=d.get("client_sig_scheme", "ed25519"),
        my_sign_seed=base64.b64decode(d["my_sign_seed"]),
        operator_id=d.get("operator_id"),
        replica_pubkeys={int(k): base64.b64decode(v)
                         for k, v in d["replica_pubkeys"].items()},
        client_pubkeys={int(k): base64.b64decode(v)
                        for k, v in d["client_pubkeys"].items()})
    # NOTE: threshold systems are seed-derived at runtime by the replica
    # from its configured cluster seed; keyfiles carry the signing layer.
    return keys


def verify(args) -> int:
    """TestGeneratedKeys role: the private seed must produce the public
    key the file claims for this principal."""
    keys = load_keyfile(args.keyfile, args.password)
    signer = keys.my_signer()
    expect = (keys.replica_pubkeys.get(keys.my_id)
              or keys.client_pubkeys.get(keys.my_id))
    if signer.public_bytes() != expect:
        print("MISMATCH: private seed does not produce the claimed pubkey")
        return 1
    payload = b"keygen-selftest"
    from tpubft_torch.crypto.cpu import make_verifier
    if not make_verifier(keys.scheme_of(keys.my_id),
                         expect).verify(payload, signer.sign(payload)):
        print("MISMATCH: sign/verify roundtrip failed")
        return 1
    print(f"keyfile OK (principal {keys.my_id}, n={keys.n}, f={keys.f})")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("-f", type=int, default=1)
    g.add_argument("-c", type=int, default=0)
    g.add_argument("--ro", type=int, default=0,
                   help="read-only replicas in the topology")
    g.add_argument("--clients", type=int, default=4)
    g.add_argument("-o", "--out", required=True)
    g.add_argument("--seed", default="tpubft-cluster")
    g.add_argument("--password", default=None)
    g.add_argument("--tls-certs", action="store_true",
                   help="also emit per-node TLS keys/certs")
    g.set_defaults(fn=generate)
    v = sub.add_parser("verify")
    v.add_argument("keyfile")
    v.add_argument("--password", default=None)
    v.set_defaults(fn=verify)
    args = p.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
