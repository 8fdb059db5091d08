"""Entry points of the port (counterpart of the reference's
__graft_entry__.py).

entry()             — the verify kernel (the framework's hot path) and a
                      64-item batch on the default device: `fn(*args)`
                      gives the verdicts.
dryrun_multichip(n) — the sharded crypto step over n slots: the real
                      cards when the host has n, otherwise n virtual
                      slots on the default device
                      (parallel/sharding.set_virtual_devices). Checks a
                      256-item sharded verify, every 37th item forged,
                      against its verdicts, and a 1000-point sharded MSM
                      (config 4's combine) against the host engine's
                      golden g1_msm.

    python -c "from tpubft_torch import graft_entry as g; g.dryrun_multichip(4)"
"""
from __future__ import annotations

import numpy as np
import torch

from tpubft_torch import device as _device


def entry():
    from tpubft_torch.crypto import cpu
    from tpubft_torch.ops import ed25519 as ops

    signer = cpu.Ed25519Signer.generate(seed=b"graft-entry")
    pk = signer.public_bytes()
    items = []
    for i in range(64):
        m = f"graft-{i}".encode()
        items.append((m, signer.sign(m), pk))
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, 64, 64),
                          _device.default_device())
    return ops.verify_kernel, args


def dryrun_multichip(n_devices: int) -> None:
    from tpubft_torch.crypto import bls12381 as ref
    from tpubft_torch.crypto import cpu
    from tpubft_torch.ops import ed25519 as ed_ops
    from tpubft_torch.parallel import sharding

    dev = _device.default_device()
    real = dev.type == "cuda" and torch.cuda.device_count() >= n_devices
    previous = sharding._virtual
    if not real:
        sharding.set_virtual_devices(n_devices, dev)
    try:
        plan = sharding.make_mesh(n_devices)
        assert plan.n == n_devices, \
            f"the plan has {plan.n} slots, wanted {n_devices}"

        # data-parallel verify across the slots at a real batch size,
        # with forged entries checked lane by lane
        signer = cpu.Ed25519Signer.generate(seed=b"dryrun")
        pk = signer.public_bytes()
        batch = max(256, 2 * n_devices)
        batch = -(-batch // n_devices) * n_devices
        items, expect = [], np.ones(batch, bool)
        for i in range(batch):
            msg = f"dry-{i}".encode()
            sig = signer.sign(msg)
            if i % 37 == 5:
                sig = sig[:32] + bytes(32)
                expect[i] = False
            items.append((msg, sig, pk))
        prep = ed_ops.prepare_batch(items)
        verify = sharding.sharded_verify_ed25519(plan.mesh)
        out = verify(prep.s_win, prep.h_win, prep.a_y, prep.a_sign,
                     prep.r_y, prep.r_sign) & prep.host_valid
        assert (out == expect).all(), \
            "sharded ed25519 verdicts disagree with ground truth"

        # the sharded G1 MSM at combine scale (config 4's 1000 shares)
        n_pts = 1000
        pts = [ref.g1_mul(ref.G1_GEN, 3 + i) for i in range(n_pts)]
        ks = [(11 + 7 * i) % ref.R for i in range(n_pts)]
        got = sharding.sharded_msm(pts, ks, plan)
        want = ref.g1_msm(pts, ks)
        assert got == want, \
            "sharded 1000-point MSM disagrees with the golden model"
    finally:
        if not real:
            sharding.set_virtual_devices(*(previous or (None,)))
