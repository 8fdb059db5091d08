"""Carry state across from the JAX package.

This system has no weights: the state the port takes over is key
material and the kernel's inputs. Both arrive as plain data (numpy
arrays, bytes, ints), so this module needs nothing of the reference:

  * `prepared_from_numpy` turns the reference's prepared verify arrays
    (its PreparedBatch fields: s_win, h_win, a_y, a_sign, r_y, r_sign)
    into the port's kernel inputs on a device;
  * `cluster_keys_from_public` builds the port's ClusterKeys from the
    reference's public material (replica and client public keys, the
    threshold systems' public keys);
  * `block_updates` builds a block's updates for either package from
    plain (category, key, value, type) rows;
  * `memorydb_from_rows` carries a ledger across: the port's MemoryDB
    holding the (family, key, value) rows of a reference DB's
    `scan_all()`, byte for byte.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

from tpubft_torch import device as _device
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.crypto.interfaces import Cryptosystem
from tpubft_torch.kvbc.categories import BlockUpdates
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.storage import MemoryDB, WriteBatch


def prepared_from_numpy(s_win, h_win, a_y, a_sign, r_y, r_sign,
                        device: Optional[torch.device] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The reference's prepared arrays -> contiguous int32 tensors on
    `device` (default: the card), in verify_kernel's argument order."""
    return ops.to_tensors((s_win, h_win, a_y, a_sign, r_y, r_sign),
                          _device.resolve(device))


def public_cryptosystem(type_name: str, threshold: int, num_signers: int,
                        public_key, share_public_keys: Sequence[bytes]
                        ) -> Cryptosystem:
    """A verify-only Cryptosystem carrying another package's public
    material (no secret shares: signing raises)."""
    cs = Cryptosystem.__new__(Cryptosystem)
    cs.type_name = type_name
    cs.threshold_ = threshold
    cs.num_signers = num_signers
    cs.public_key = public_key
    cs.share_public_keys = list(share_public_keys)
    cs.secret_shares = None
    cs._factory = Cryptosystem.factory(type_name)
    return cs


def cluster_keys_from_public(
        n: int, f: int, c: int, threshold_scheme: str,
        replica_pubkeys: Mapping[int, bytes],
        client_pubkeys: Mapping[int, bytes],
        systems: Dict[str, Tuple[int, Sequence[bytes]]],
        operator_id: Optional[int] = None,
        replica_sig_scheme: str = "ed25519",
        client_sig_scheme: str = "ed25519") -> ClusterKeys:
    """The port's ClusterKeys over public material. `systems` maps
    "slow_path_system" / "commit_path_system" / "optimistic_system" to
    (threshold, share public keys) of the resolved `threshold_scheme`."""
    ck = ClusterKeys(n=n, f=f, c=c, threshold_scheme=threshold_scheme,
                     replica_sig_scheme=replica_sig_scheme,
                     client_sig_scheme=client_sig_scheme,
                     replica_pubkeys=dict(replica_pubkeys),
                     client_pubkeys=dict(client_pubkeys),
                     operator_id=operator_id)
    for attr, (threshold, share_pks) in systems.items():
        setattr(ck, attr, public_cryptosystem(
            threshold_scheme, threshold, n, list(share_pks), share_pks))
    return ck


def block_updates(rows: Iterable[Tuple[str, bytes, bytes, str]],
                  cls=BlockUpdates):
    """One block's updates from (category, key, value, category type)
    rows; `cls` is the BlockUpdates class of either package (their
    category type names are the same strings)."""
    bu = cls()
    for category, key, value, cat_type in rows:
        bu.put(category, key, value, cat_type)
    return bu


def memorydb_from_rows(rows: Iterable[Tuple[bytes, bytes, bytes]]
                       ) -> MemoryDB:
    """A port MemoryDB holding every (family, key, value) row."""
    db = MemoryDB()
    wb = WriteBatch()
    for family, key, value in rows:
        wb.put(key, value, family)
    db.write(wb)
    return db
