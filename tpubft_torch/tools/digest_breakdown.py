"""Where a state-transfer window digest call spends its time.

    python -m tpubft_torch.tools.digest_breakdown [--reps 30]

Builds raw kvbcbench ledger blocks (testing.kvbcbench_rows), then, on the
card, for windows of 16, 32, 64, 128 and 256 blocks and for one 64-block
window of mixed sizes (every 8th block big):

  - the whole call, statetransfer/digests.window_digests, against hashlib
    over the same blocks: median, min and max of --reps calls each, the
    process's first device call reported apart;
  - the steps of the call's own path (ops/sha256._hash on the card): the
    host pack (`pack_ms`) and the copy into the pinned staging buffer
    (`stage_ms`), by the host's clock; then the device round trip issued
    as the C call `sha256_raw_roundtrip` issues it, on one stream, behind
    a spin of the card long enough that the host has issued it all
    before the card starts (`issue_ms`, the host's time to issue;
    `spin_covered_issue`): the host-to-device copy, the kernel and the
    device-to-host copy each between two CUDA events (`h2d_ms`,
    `kernel_ms`, `d2h_ms`: the card's time for each); medians over
    --reps, with the bytes each way and the whole of `_roundtrip`
    (staging and the C call, `roundtrip_ms`);
  - the kernel alone by device time (`kernel_graph_ms`: a CUDA graph of
    20 launches replayed under CUDA events), here and on Merkle levels of
    1024 and 16384 two-block nodes.

Prints one JSON line. `chip_smoke.py` takes its digest-phase numbers from
the functions here.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from tpubft_torch.tools.timing import graph_ms

SWEEP_BLOCKS = (16, 32, 64, 128, 256)
# about a millisecond of the card spinning (torch.cuda._sleep), longer
# than the host takes to issue a round trip's three steps
SPIN_CYCLES = 2_000_000


def ledger_raws(blocks: int, big_every: int = 0) -> List[bytes]:
    """The raw blocks of a kvbcbench ledger of `blocks` blocks."""
    from tpubft_torch import convert, testing
    from tpubft_torch.kvbc import create_blockchain
    from tpubft_torch.storage import MemoryDB
    kw = {"big_every": big_every} if big_every else {}
    bc = create_blockchain(MemoryDB(), use_device_hashing=False)
    bc.add_blocks([convert.block_updates(rows)
                   for rows in testing.kvbcbench_rows(blocks, **kw)])
    return [bc.get_raw_block(b) for b in range(1, blocks + 1)]


def spread(values: Sequence[float]) -> Dict[str, float]:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


def kernel_graph_ms(raws: Sequence[bytes], dev: torch.device) -> float:
    """The SHA-256 kernel alone on these messages, by device time."""
    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    blob, offsets = sha.pack(raws)
    data, offs = sha.to_device(blob, offsets, dev)
    return graph_ms(lambda: sha256_cuda.sha256_raw(data, offs, offsets), 20)


def steps(raws: Sequence[bytes], dev: torch.device) -> Dict[str, float]:
    """One digest call's path on the card split into its steps (ms), with
    the bytes copied each way; the device steps are issued on one stream
    as the round-trip C call issues them, between CUDA events."""
    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    want = b"".join(hashlib.sha256(r).digest() for r in raws)
    t0 = time.perf_counter()
    blob, offsets = sha.pack(raws)
    t1 = time.perf_counter()
    head, b = offsets.nbytes, len(raws)
    stage = sha._h2d.take(head + len(blob))
    host = stage.numpy()
    host[:head] = offsets.view(np.uint8)
    host[head:] = np.frombuffer(blob, np.uint8)
    t2 = time.perf_counter()
    out = sha._d2h.take(32 * b)
    dev_in = torch.empty(stage.numel(), dtype=torch.uint8, device=dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    # the card spins while the host issues the three steps, so the events
    # between them time the card's work, not the host's gaps
    events[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    t3 = time.perf_counter()
    events[1].record()
    dev_in.copy_(stage, non_blocking=True)
    events[2].record()
    digests = sha256_cuda.sha256_raw(dev_in[head:],
                                     dev_in[:head].view(torch.int64),
                                     offsets)
    events[3].record()
    out.copy_(digests.view(-1), non_blocking=True)
    events[4].record()
    t4 = time.perf_counter()
    events[4].synchronize()
    if out.numpy().tobytes() != want:
        raise AssertionError("window digests differ from hashlib")
    copies = dict(sha.COPIES)
    t5 = time.perf_counter()
    got = sha._roundtrip(blob, offsets, dev)
    t6 = time.perf_counter()
    if got != want:
        raise AssertionError("window digests differ from hashlib")
    return {"pack_ms": (t1 - t0) * 1e3, "stage_ms": (t2 - t1) * 1e3,
            "issue_ms": (t4 - t3) * 1e3,
            "spin_covered_issue": (t4 - t3) * 1e3
            < events[0].elapsed_time(events[1]),
            "h2d_ms": events[1].elapsed_time(events[2]),
            "kernel_ms": events[2].elapsed_time(events[3]),
            "d2h_ms": events[3].elapsed_time(events[4]),
            "roundtrip_ms": (t6 - t5) * 1e3,
            "h2d_bytes": sha.COPIES["h2d_bytes"] - copies["h2d_bytes"],
            "d2h_bytes": sha.COPIES["d2h_bytes"] - copies["d2h_bytes"]}


def window_row(raws: Sequence[bytes], dev: torch.device, reps: int) -> dict:
    """The whole call against hashlib, and its steps, over `reps` calls."""
    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.statetransfer import digests
    want = [hashlib.sha256(r).digest() for r in raws]
    call, host = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = digests.window_digests(raws, use_device=True, device=dev)
        call.append((time.perf_counter() - t0) * 1e3)
        if got != want:
            raise AssertionError("window digests differ from hashlib")
        t0 = time.perf_counter()
        [hashlib.sha256(r).digest() for r in raws]
        host.append((time.perf_counter() - t0) * 1e3)
    parts = [steps(raws, dev) for _ in range(reps)]
    row = {"blocks": len(raws), "bytes": sum(map(len, raws)),
           "block_counts": sorted({sha.blocks_needed(len(r))
                                   for r in raws}),
           "call_ms": spread(call), "hashlib_ms": spread(host)}
    for key in parts[0]:
        row[key] = (all(p[key] for p in parts)
                    if isinstance(parts[0][key], bool)
                    else statistics.median(p[key] for p in parts))
    row["kernel_graph_ms"] = kernel_graph_ms(raws, dev)
    return row


def sweep(raws: Sequence[bytes], mixed: Sequence[bytes], dev: torch.device,
          reps: int, sizes: Sequence[int] = SWEEP_BLOCKS) -> dict:
    """window_row at each of `sizes` leading blocks of `raws`, and on the
    mixed window; the device call wins where its median is below
    hashlib's."""
    rows = [window_row(raws[:n], dev, reps) for n in sizes]
    rng = np.random.default_rng(5)
    merkle = [{"batch": b, "kernel_graph_ms": kernel_graph_ms(
        [b"\x01" + rng.bytes(64) for _ in range(b)], dev)}
        for b in (1024, 16384)]
    return {"windows": rows, "mixed": window_row(mixed, dev, reps),
            "merkle": merkle,
            "device_faster_at": [r["blocks"] for r in rows
                                 if r["call_ms"]["median"]
                                 < r["hashlib_ms"]["median"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("digest_breakdown: needs a CUDA card")
        return 1
    dev = torch.device("cuda", 0)
    raws = ledger_raws(max(SWEEP_BLOCKS))
    mixed = ledger_raws(64, big_every=8)
    from tpubft_torch.statetransfer import digests
    t0 = time.perf_counter()
    digests.window_digests(raws[:64], use_device=True, device=dev)
    first = (time.perf_counter() - t0) * 1e3
    out = {"first_call_ms": first, **sweep(raws, mixed, dev, args.reps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
