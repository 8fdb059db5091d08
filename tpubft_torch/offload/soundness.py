"""On-replica soundness checks for leased crypto work (the "2G2T"
constant-size MSM-outsourcing verification, arXiv 2602.23464; port of
tpubft/offload/soundness.py over the port's host BLS engine and RLC
kernel).

The helper is UNTRUSTED: nothing it returns may influence a verdict
until it survives one of these checks. All three checks share the same
shape — fold the whole lease into ONE aggregate statement with
Fiat-Shamir coefficients drawn AFTER the helper committed to its
answer, then verify the aggregate at constant pairing/launch cost:

  * BLS threshold combine: the returned per-segment points C_s must be
    valid signatures on their slot digests under the MASTER public key
    (BLS uniqueness: for each digest there is exactly one valid
    signature, so check-pass ⟹ C_s is byte-identical to what an honest
    local combine over good shares produces). One 128-bit RLC over the
    segments → two G1 MSMs + ONE 2-pairing check, regardless of how
    many shares the helper combined.

  * multisig-BLS sum: same fold, but each segment verifies against the
    sum of its CONTRIBUTORS' G2 keys, so the H(d)-side cannot collapse
    to a single pairing — it is one Miller batch of 1+nsegs pairings,
    still constant per segment and independent of share count.

  * ECDSA RLC: the helper returns per-item verdict bits; the replica
    re-folds the ACCEPTED subset with its OWN Fiat-Shamir coefficients
    in one `_rlc_launch` (2^-128 soundness), and re-checks the
    rejected-but-plausible items on the batched host engine. A helper
    lying in either direction (accepting a forgery, rejecting a valid
    signature) is caught.

Check-failure is AMBIGUOUS for the BLS shapes — the shares themselves
may be Byzantine (then even an honest helper's combine fails the
pairing). The pool layer disambiguates by re-running locally once and
comparing: equal ⟹ helper honest, the shares are bad (the local result
flows to the normal bad-share identification path, byte-identical to
offload-off); different ⟹ the helper lied.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from tpubft_torch.crypto import bls12381 as bls

DOMAIN_COMBINE = b"offload-2g2t-combine"
DOMAIN_SUM = b"offload-2g2t-sum"


def decompress_points(pts: Sequence[bytes]) -> Optional[List[object]]:
    """Helper-returned compressed points -> affine points; None when
    any point is undecodable or outside the G1 subgroup (a helper that
    returns such bytes is lying, not merely wrong)."""
    out = []
    for p in pts:
        try:
            pt = bls.g1_decompress(p)
        except ValueError:
            return None
        if pt is None:      # infinity is never a valid combined sig
            return None
        out.append(pt)
    return out


def check_bls_combine(master_pk, digests: Sequence[bytes],
                      points: Sequence[object]) -> bool:
    """e(Σ z_s·C_s, −g2) · e(Σ z_s·H(d_s), master_pk) == 1 with the
    coefficients bound to the helper's RETURNED points (it committed
    before the draw — a cancellation between wrong points survives with
    probability ~2^-128)."""
    if not points:
        return True
    if len(points) != len(digests):
        return False
    ctx = (DOMAIN_COMBINE + bls.g2_compress(master_pk)
           + b"".join(d + bls.g1_compress(pt)
                      for d, pt in zip(digests, points)))
    zs = bls._rlc_scalars(len(points), ctx)
    agg_sig = bls.g1_msm(list(points), zs)
    agg_h = bls.g1_msm([bls.hash_to_g1(d) for d in digests], zs)
    return bls.pairing_check([(agg_sig, bls.g2_neg(bls.G2_GEN)),
                              (agg_h, master_pk)])


def check_bls_sum(meta: Sequence[Tuple[bytes, object]],
                  points: Sequence[object]) -> bool:
    """meta = [(digest, agg_pk_g2)] per segment: one Miller batch of
    e(Σ z_s·S_s, −g2) · Π e(z_s·H(d_s), apk_s) == 1."""
    if not points:
        return True
    if len(points) != len(meta):
        return False
    ctx = (DOMAIN_SUM
           + b"".join(d + bls.g2_compress(apk) + bls.g1_compress(pt)
                      for (d, apk), pt in zip(meta, points)))
    zs = bls._rlc_scalars(len(points), ctx)
    agg_sig = bls.g1_msm(list(points), zs)
    pairs = [(agg_sig, bls.g2_neg(bls.G2_GEN))]
    for z, (d, apk) in zip(zs, meta):
        pairs.append((bls.g1_mul(bls.hash_to_g1(d), z), apk))
    return bls.pairing_check(pairs)


def check_ecdsa_verdicts(curve: str, items, prep, bits: Sequence[bool]
                         ) -> Optional[List[bool]]:
    """Verify helper verdict bits against one local RLC fold; returns
    the confirmed verdict list (byte-identical to a full local
    `rlc_verify_batch`) or None when the helper LIED. `prep` is the
    replica's own PreparedRlcBatch over `items` — the helper never
    chooses the fold coefficients."""
    from tpubft_torch import device as _device
    from tpubft_torch.crypto import scalar as _scalar
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    accepted = [i for i, b in enumerate(bits) if b]
    # an honest helper never accepts an item the host prechecks already
    # reject (malformed sig/point): accepting one is a lie, full stop
    if any(not prep.host_valid[i] for i in accepted):
        return None
    if accepted:
        # ONE aggregate launch over the accepted subset with OUR
        # coefficients: passes iff every accepted item verifies. Port
        # divergence (reference soundness.py:122): the port's launch
        # takes the device, the default one (the card, or the CPU where
        # the caller asked for it; no card raises device.NoDevice)
        if not ops_ecdsa._rlc_launch(curve, prep, accepted,
                                     _device.resolve(None)):
            return None
    rejected = [i for i, b in enumerate(bits)
                if not b and prep.host_valid[i]]
    if rejected:
        # a lying-REJECT starves liveness instead of forging — re-check
        # the plausible rejects on the batched host engine (under
        # honest helpers this subset is exactly the genuinely-bad
        # traffic, which local-only verification would also pay for)
        redo = _scalar.ecdsa_verify_batch(
            [(items[i][2], items[i][0], items[i][1]) for i in rejected],
            curve)
        if any(redo):
            return None
    return [bool(b) and bool(prep.host_valid[i])
            for i, b in enumerate(bits)]
