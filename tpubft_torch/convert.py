"""Carry state across from the JAX package.

This system has no weights: the state the port takes over is key
material and the kernel's inputs. Both arrive as plain data (numpy
arrays, bytes, ints), so this module needs nothing of the reference:

  * `prepared_from_numpy` turns the reference's prepared verify arrays
    (its PreparedBatch fields: s_win, h_win, a_y, a_sign, r_y, r_sign)
    into the port's kernel inputs on a device;
  * `msm_inputs_from_numpy` turns the reference's G1 MSM inputs (its
    (255, S, K) scalar bit matrix, (36, S, K) 11-bit Montgomery point
    limbs and (S, K) identity mask) into the port's MSM kernel inputs;
  * `rlc_inputs_from_numpy` turns the reference's prepared ECDSA RLC
    batch (its PreparedRlcBatch: (256, B) scalar bit matrices and
    25-limb 11-bit Montgomery words at R = 2^275) into the port's RLC
    kernel inputs ((8, B) words of the canonical integers);
  * `cryptosystem_from_keys` carries a threshold system's key material
    across (master key, share keys, secret shares: ints, bytes and
    int-tuple points in both packages), and `public_cryptosystem` its
    public half;
  * `cluster_keys_from_public` builds the port's ClusterKeys from the
    reference's public material (replica and client public keys, the
    threshold systems' public keys and, for threshold-bls, master
    keys; client keys of any scheme, 65-byte SEC1 points for ECDSA);
  * `block_updates` builds a block's updates for either package from
    plain (category, key, value, type) rows;
  * `memorydb_from_rows` carries an in-memory ledger across: the port's
    MemoryDB holding the (family, key, value) rows of a reference DB's
    `scan_all()`, byte for byte.

A persistent ledger needs no function here: the kvlog file itself is
the state carried across. The port's NativeDB (storage/native.py, over
its own copy of native/kvlog.cpp) writes the reference's files byte for
byte for the same batches, after compaction and checkpoint too, and
each package opens the other's files (tests/test_torch_storage.py); a
port replica started with `--db-dir` on a reference replica's
`replica-<id>.kvlog` takes it up as it is
(tests/test_torch_processes.py).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubft_torch import device as _device
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.crypto.interfaces import Cryptosystem
from tpubft_torch.kvbc.categories import BlockUpdates
from tpubft_torch.ops import bls12_381 as bls_ops
from tpubft_torch.ops import ecdsa as ecdsa_ops
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.storage import MemoryDB, WriteBatch


def prepared_from_numpy(s_win, h_win, a_y, a_sign, r_y, r_sign,
                        device: Optional[torch.device] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The reference's prepared arrays -> contiguous int32 tensors on
    `device` (default: the card), in verify_kernel's argument order."""
    return ops.to_tensors((s_win, h_win, a_y, a_sign, r_y, r_sign),
                          _device.resolve(device))


# the reference's G1 limbs: radix 2^11, 36 limbs, Montgomery R = 2^396
_REF_LIMB_BITS = 11
_REF_R = 1 << (_REF_LIMB_BITS * 36)


def msm_inputs_from_numpy(bits, px, py, infinity,
                          device: Optional[torch.device] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """The reference's msm_batch_kernel inputs -> the port's MSM kernel
    inputs on `device` (default: the card): bits (255, S, K) msb-first,
    px/py (36, S, K) 11-bit Montgomery limbs, infinity (S, K) -> scalar
    words (8, S, K), Montgomery words (12, S, K) x 2 (R = 2^384) and the
    mask. A (255, B) / (36, B) / (B,) single MSM works the same way."""
    bits = np.asarray(bits)
    px, py = np.asarray(px), np.asarray(py)
    lanes = bits.shape[1:]
    flat_bits = bits.reshape(bits.shape[0], -1)
    weights = [1 << (bits.shape[0] - 1 - i) for i in range(bits.shape[0])]
    scalars = [sum(w for w, b in zip(weights, flat_bits[:, j].tolist()) if b)
               for j in range(flat_bits.shape[1])]
    p = bls_ops.ref.P
    back = pow(_REF_R, -1, p)

    def ints(limbs):
        flat = limbs.reshape(limbs.shape[0], -1)
        return [sum(int(v) << (_REF_LIMB_BITS * i)
                    for i, v in enumerate(flat[:, j].tolist())) * back % p
                for j in range(flat.shape[1])]
    words = bls_ops._scalar_words(scalars)
    qx, qy = bls_ops._affine_words(list(zip(ints(px), ints(py))))
    return bls_ops.to_tensors(
        tuple(a.reshape((a.shape[0],) + lanes) for a in (words, qx, qy))
        + (np.asarray(infinity, dtype=bool).reshape(lanes),),
        _device.resolve(device))


def _bits_to_ints(bits) -> list:
    """(nbits, B) msb-first bit matrix -> B ints."""
    flat = np.asarray(bits).reshape(np.asarray(bits).shape[0], -1)
    return [int("".join(map(str, flat[:, j].tolist())), 2)
            for j in range(flat.shape[1])]


def rlc_inputs_from_numpy(curve_name: str, u1_bits, u2_bits, qx_m, qy_m,
                          xr_m, xrpn_m, wrap_ok, a_m, host_valid,
                          device: Optional[torch.device] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """The reference's PreparedRlcBatch fields (ops/ecdsa.py:86-95) ->
    the port's RLC kernel inputs on `device` (default: the card), in
    ops/ecdsa.rlc_fold_kernel's argument order (u1, u2, qx, qy, xr, xrpn,
    wrap_ok, active, a): the bit matrices become (8, B) words, the
    Montgomery limbs (radix 2^11, 25 limbs for a 256-bit p, R = 2^275)
    the canonical integers' words."""
    p = ecdsa_ops.CURVES[curve_name]["p"]
    nl = np.asarray(qx_m).shape[0]
    back = pow(1 << (_REF_LIMB_BITS * nl), -1, p)

    def ints(limbs):
        flat = np.asarray(limbs)
        return [sum(int(v) << (_REF_LIMB_BITS * i)
                    for i, v in enumerate(flat[:, j].tolist())) * back % p
                for j in range(flat.shape[1])]
    words = ecdsa_ops.words_of
    return ecdsa_ops.to_tensors(
        (words(_bits_to_ints(u1_bits)), words(_bits_to_ints(u2_bits)),
         words(ints(qx_m)), words(ints(qy_m)), words(ints(xr_m)),
         words(ints(xrpn_m)), np.asarray(wrap_ok, dtype=bool),
         np.asarray(host_valid, dtype=bool), words(ints(a_m))),
        _device.resolve(device))


def cryptosystem_from_keys(type_name: str, threshold: int, num_signers: int,
                           public_key, share_public_keys,
                           secret_shares=None) -> Cryptosystem:
    """A port Cryptosystem over another package's key material, e.g. a
    reference Cryptosystem's `public_key`, `share_public_keys` and
    `secret_shares` (threshold-bls: the master G2 key, the share G2 keys
    and the Shamir shares; multisig-bls: the G2 key list twice and the
    secret keys; multisig-ed25519: key bytes). Without `secret_shares`
    signing raises."""
    cs = Cryptosystem.__new__(Cryptosystem)
    cs.type_name = type_name
    cs.threshold_ = threshold
    cs.num_signers = num_signers
    cs.public_key = public_key
    cs.share_public_keys = list(share_public_keys)
    cs.secret_shares = (None if secret_shares is None
                        else list(secret_shares))
    cs._factory = Cryptosystem.factory(type_name)
    return cs


def public_cryptosystem(type_name: str, threshold: int, num_signers: int,
                        public_key, share_public_keys: Sequence
                        ) -> Cryptosystem:
    """A verify-only Cryptosystem carrying another package's public
    material (no secret shares: signing raises)."""
    return cryptosystem_from_keys(type_name, threshold, num_signers,
                                  public_key, share_public_keys)


def cluster_keys_from_public(
        n: int, f: int, c: int, threshold_scheme: str,
        replica_pubkeys: Mapping[int, bytes],
        client_pubkeys: Mapping[int, bytes],
        systems: Dict[str, Tuple],
        operator_id: Optional[int] = None,
        replica_sig_scheme: str = "ed25519",
        client_sig_scheme: str = "ed25519") -> ClusterKeys:
    """The port's ClusterKeys over public material. `systems` maps
    "slow_path_system" / "commit_path_system" / "optimistic_system" to
    (threshold, share public keys) of the resolved `threshold_scheme`, or
    to (threshold, share public keys, master public key) for
    threshold-bls (the multisig schemes' public key is the key list)."""
    ck = ClusterKeys(n=n, f=f, c=c, threshold_scheme=threshold_scheme,
                     replica_sig_scheme=replica_sig_scheme,
                     client_sig_scheme=client_sig_scheme,
                     replica_pubkeys=dict(replica_pubkeys),
                     client_pubkeys=dict(client_pubkeys),
                     operator_id=operator_id)
    for attr, (threshold, share_pks, *master) in systems.items():
        public_key = master[0] if master else list(share_pks)
        setattr(ck, attr, public_cryptosystem(
            threshold_scheme, threshold, n, public_key, share_pks))
    return ck


def block_updates(rows: Iterable[tuple], cls=BlockUpdates):
    """One block's updates from (category, key, value, category type)
    rows, each with its tags as an optional fifth element; a value of
    None deletes the key. `cls` is the BlockUpdates class of either
    package (their category type names are the same strings)."""
    bu = cls()
    for category, key, value, cat_type, *tags in rows:
        if value is None:
            bu.delete(category, key, cat_type)
        else:
            bu.put(category, key, value, cat_type,
                   tags=tags[0] if tags else None)
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
