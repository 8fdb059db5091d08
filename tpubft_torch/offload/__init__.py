"""Verified crypto-offload tier (port of tpubft/offload/).

Replicas lease their hottest launches — the BLS Lagrange/MSM combine,
the multisig-BLS share sums, and the ECDSA RLC fold — to a pool of
NON-VOTING helper processes (a crypto sidecar fleet that scales
independently of the replica set), and re-verify every returned result
on-replica with a constant-size soundness check ("2G2T", arXiv
2602.23464) before it can influence a verdict:

  * a helper that lies (wrong point, wrong-but-on-curve point, stale
    lease replay, garbage bytes) fails the check, is breaker-evicted
    as BYZANTINE (quarantined — no cooldown re-admission without an
    operator reset), and its lease re-runs locally inside the same
    flush;
  * a helper that times out or drops the connection is SICK: the
    per-helper `helper.<id>` breaker applies the same cooldown + probe
    re-admission discipline the device breaker uses;
  * with offload on or off, the verdict-producing code paths
    (`combine_batch` / `rlc_verify_batch`) return byte-identical
    results — helpers only ever donate work, never trust.

Layout: `protocol` (length-prefixed lease frames), `soundness` (the
on-replica checks), `pool` (leasing, breakers, quarantine, metrics),
`helper` (the daemon + the ByzantineHelper test strategies).
"""
