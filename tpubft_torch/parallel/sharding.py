"""The crypto mesh: sharded launches over slots, and the mesh's control
plane (port of tpubft/parallel/sharding.py).

A slot is one shard's device, `Slot(id, torch.device)`. The default
inventory is one slot a visible card (`cuda:0..k-1`) when the default
device is the card, and one slot of the default device when the caller
asked for the CPU. `set_virtual_devices(n, device)` gives n slots on one
device instead, the port's counterpart of the reference's
`--xla_force_host_platform_device_count` (tests/conftest.py:13-14,
__graft_entry__.py:40-46): several slots may share a card, so the whole
sharded path (per-slot launches, the cross-shard combine, eviction,
rebalance and readmission) runs on one H100 against the real kernels.

Launch patterns, each a launch a slot and a gather on the host, with no
collective library (the reference's shard_map programs over ICI):
  * data-parallel batch verify and digest: each slot runs the
    single-device kernel on its rows (`sharded_verify_ed25519`,
    `sharded_sha256_kernel`, `sharded_sha256_masked_kernel`);
  * sharded MSM: each slot runs the MSM kernel on its K-shard, then the
    D partial points a segment are copied to the plan's first slot and
    summed there by ops/bls12_381.combine_kernel (the reference's
    all_gather + msm_reduce, :80-85, :219-223);
  * sharded ECDSA RLC: each slot folds its own columns with the full
    batch's coefficients and gives one verdict bit; a failing shard is
    bisected alone (ops/ecdsa.rlc_verify_batch).

Every slot's launch is issued on that slot's own CUDA stream (one a slot
a plan, made at first use) before any result is read back, so the shards
of a host with several cards overlap; the slot streams first wait for
the device's current stream, and the current stream waits for them
before the read-back. Inputs are made inside the slot's stream context,
so the caching allocator ties them to that stream; outputs read on the
current stream are marked with `record_stream`.

`CryptoMesh` is the control plane: the slot inventory, one breaker a
slot (`device.chip<N>`, threshold 1), cooldown readmission probes, the
autotuner's `crypto_shard_count` cap and the per-plan launch state. Ops
modules reach it only through ops/dispatch.py (`mesh_plan`,
`mesh_launch`).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from tpubft_torch import device as _device
from tpubft_torch.utils.breaker import BreakerOpen, CircuitBreaker, get_breaker
from tpubft_torch.utils.racecheck import make_lock


class Slot(NamedTuple):
    """One shard's device. `id` names its breaker (`device.chip<id>`)."""
    id: int
    device: torch.device


def pad_pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def shard_rows(n: int, d: int, multiple: int = 1) -> int:
    """Rows a shard for an n-item batch over d shards (reference
    :298-307): a power of two, rounded up to `multiple`."""
    rows = pad_pow2(max(1, math.ceil(n / max(1, d))))
    if multiple > 1:
        rows = ((rows + multiple - 1) // multiple) * multiple
    return rows


# ---------------------------------------------------------------------
# the slots of one plan, and their launch state
# ---------------------------------------------------------------------

def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class Mesh:
    """The port's counterpart of jax.sharding.Mesh: the slots a sharded
    launch runs on, and one CUDA stream a card slot (made at first
    use, kept for the life of the plan)."""

    def __init__(self, slots: Sequence[Slot]) -> None:
        self.slots = tuple(slots)
        self._streams: Optional[List[Optional[torch.cuda.Stream]]] = None

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def first(self) -> torch.device:
        """Where the cross-shard combine runs."""
        return self.slots[0].device

    def streams(self) -> List[Optional["torch.cuda.Stream"]]:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=s.device)
                             if s.device.type == "cuda" else None
                             for s in self.slots]
        return self._streams

    def run(self, launch: Callable[[int, Slot], object]) -> List[object]:
        """launch(j, slot) for every slot, each inside its slot's stream
        on a card; every launch is issued before any is waited on. The
        results (tensors on each slot's device) are ready to read on the
        device's current stream when this returns."""
        streams = self.streams()
        for dev in {s.device for s in self.slots if s.device.type == "cuda"}:
            cur = torch.cuda.current_stream(dev)
            for st, s in zip(streams, self.slots):
                if s.device == dev:
                    st.wait_stream(cur)
        outs = []
        for j, (slot, st) in enumerate(zip(self.slots, streams)):
            if st is None:
                outs.append(launch(j, slot))
                continue
            with torch.cuda.stream(st):
                outs.append(launch(j, slot))
        for out, slot, st in zip(outs, self.slots, streams):
            if st is None:
                continue
            cur = torch.cuda.current_stream(slot.device)
            cur.wait_stream(st)
            for t in _tensors(out):
                t.record_stream(cur)
        return outs


def _cols(a: np.ndarray, axis: int, d: int, j: int) -> np.ndarray:
    """Shard j of d equal blocks of `a` along `axis`, contiguous."""
    rows = a.shape[axis] // d
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(j * rows, (j + 1) * rows)
    return np.ascontiguousarray(a[tuple(idx)])


def _check_split(n: int, mesh: Mesh) -> None:
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size} slots")


def make_mesh(n_devices: Optional[int] = None) -> "MeshPlan":
    """A plan over the first n slots of the inventory (all by default),
    whatever their health: the reference's make_mesh (:63-66) for
    callers that shard by hand (graft_entry.dryrun_multichip)."""
    slots = mesh_manager().slots()
    n = n_devices or len(slots)
    if n > len(slots):
        raise ValueError(f"{n} slots asked for, the inventory has "
                         f"{len(slots)}")
    return MeshPlan(0, slots[:n], Mesh(slots[:n]) if n > 1 else None)


# ---------------------------------------------------------------------
# sharded launchers: each takes the single-device route's host arrays,
# padded to a multiple of the mesh size, and returns host results
# ---------------------------------------------------------------------

def sharded_verify_ed25519(mesh: Mesh):
    """Data-parallel Ed25519 verify (reference :95-115): the batch axis
    of (s_win, h_win, a_y, a_sign, r_y, r_sign), host arrays of B lanes
    (B a multiple of the mesh size), split into equal shards; each slot
    runs ops/ed25519.verify_kernel (the CUDA kernel on a card) on its
    shard. -> (B,) bool."""
    from tpubft_torch.ops import ed25519 as ops
    axes = (1, 1, 1, 0, 1, 0)

    def fn(*arrays) -> np.ndarray:
        _check_split(arrays[3].shape[0], mesh)

        def launch(j, slot):
            shard = [_cols(a, ax, mesh.size, j)
                     for a, ax in zip(arrays, axes)]
            return ops.verify_kernel(*ops.to_tensors(shard, slot.device))
        return np.concatenate([o.cpu().numpy() for o in mesh.run(launch)])

    return fn


def sharded_sha256_kernel(mesh: Mesh):
    """Data-parallel SHA-256 (reference :179-187): B messages (B a
    multiple of the mesh size) in equal shards, each slot hashing its
    own through ops/sha256.sha256_kernel (the CUDA kernel on a card).
    -> the B digests joined, 32 bytes each."""
    from tpubft_torch.ops import sha256 as sha

    def fn(messages: Sequence[bytes]) -> bytes:
        _check_split(len(messages), mesh)
        rows = len(messages) // mesh.size

        def launch(j, slot):
            blob, offsets = sha.pack(messages[j * rows:(j + 1) * rows])
            data, offs = sha.to_device(blob, offsets, slot.device)
            return sha.sha256_kernel(data, offs, offsets)
        return b"".join(sha.from_device(o) for o in mesh.run(launch))

    return fn


def sharded_sha256_masked_kernel(mesh: Mesh):
    """Mixed-size digest batch (reference :190-196). The port's one
    kernel takes every message at its own block count (ops/sha256.py),
    so this is the uniform launcher."""
    return sharded_sha256_kernel(mesh)


def sharded_msm_batch_kernel(mesh: Mesh):
    """Segmented multi-MSM with the share axis K sharded (reference
    :203-230): words (8, S, K), px/py (12, S, K), infinity (S, K) host
    arrays, K a multiple of the mesh size. Each slot runs
    ops/bls12_381.msm_batch_kernel on its K-shard -> (12, S) x 3; the D
    partials are copied to the first slot, stacked to (12, S, D) and
    summed by ops/bls12_381.combine_kernel. -> (X, Y, Z), each (12, S)
    canonical Montgomery words on the host."""
    from tpubft_torch.ops import bls12_381 as bops

    def fn(words, px, py, infinity) -> List[np.ndarray]:
        _check_split(infinity.shape[-1], mesh)

        def launch(j, slot):
            shard = [_cols(a, a.ndim - 1, mesh.size, j)
                     for a in (words, px, py, infinity)]
            return bops.msm_batch_kernel(*bops.to_tensors(shard,
                                                          slot.device))
        parts = mesh.run(launch)
        first = mesh.first
        x, y, z = (torch.stack([p[c].to(first) for p in parts], -1)
                   for c in range(3))
        return [c.cpu().numpy() for c in bops.combine_kernel(x, y, z)]

    return fn


def sharded_msm_kernel(mesh: Mesh):
    """One MSM with its points sharded (reference :69-92): words (8, K),
    px/py (12, K), infinity (K,) -> (X, Y, Z), each (12,)."""
    batch = sharded_msm_batch_kernel(mesh)

    def fn(words, px, py, infinity) -> List[np.ndarray]:
        out = batch(words[:, None], px[:, None], py[:, None],
                    infinity[None])
        return [c[:, 0] for c in out]

    return fn


def sharded_rlc_kernel(curve_name: str, mesh: Mesh):
    """The RLC aggregate with the batch axis sharded (reference
    :238-259): the columns of ops/ecdsa.rlc_columns (u1, u2, qx, qy, xr,
    xrpn, wrap_ok, active, a), B a multiple of the mesh size. Each slot
    folds its own columns, with the coefficients of the full batch,
    through ops/ecdsa.rlc_fold_kernel (the CUDA kernel on a card). ->
    (D,) bool, one verdict a shard: True where its fold is zero."""
    from tpubft_torch.ops import ecdsa as eops

    def fn(*cols) -> np.ndarray:
        _check_split(cols[6].shape[0], mesh)
        if any(s.device.type == "cuda" for s in mesh.slots):
            from tpubft_torch.ops import ecdsa_cuda
            # G's table is made once a device: make it on the current
            # stream, before the slot streams (which wait for it) read it
            for dev in {s.device for s in mesh.slots
                        if s.device.type == "cuda"}:
                ecdsa_cuda.g_table(curve_name, dev)

        def launch(j, slot):
            shard = [_cols(a, a.ndim - 1, mesh.size, j) for a in cols]
            return eops.rlc_fold_kernel(curve_name,
                                        *eops.to_tensors(shard, slot.device))
        return np.array([not bool(o.cpu().any()) for o in mesh.run(launch)])

    return fn


def sharded_msm(points: Sequence, scalars: Sequence[int],
                plan: Optional["MeshPlan"] = None):
    """Host-facing sharded MSM over G1 affine int points (reference
    :129-162): the batch padded with identity lanes to a multiple of the
    plan's slots. -> the affine point, None for the identity."""
    from tpubft_torch.crypto import bls12381 as ref
    from tpubft_torch.ops import bls12_381 as bops
    plan = plan or make_mesh()
    n = len(points)
    if n == 0:
        return None
    if plan.mesh is None:
        return bops.msm(points, scalars, plan.devices[0].device)
    d = plan.n
    m = max(pad_pow2(n), d)
    m = ((m + d - 1) // d) * d
    words, px, py, infinity = bops._prep_msm(
        points, [k % ref.R for k in scalars], m)
    x, y, z = sharded_msm_kernel(plan.mesh)(words, px, py, infinity)
    return bops._to_affine_host(x, y, z)


# ---------------------------------------------------------------------
# CryptoMesh: the control plane (health, eviction, shard cap)
# ---------------------------------------------------------------------

# test/chaos fault injection: slot ids whose devices are "dead" — a
# launch over a plan containing one raises and its readmission probes
# fail until cleared
_chip_faults: Set[int] = set()

# (n, device) while virtual slots are set, else None
_virtual: Optional[Tuple[int, Optional[torch.device]]] = None


def inject_chip_fault(device_id: int) -> None:
    """Mark one slot dead: mesh launches touching it fail and its
    probes fail."""
    _chip_faults.add(device_id)


def clear_chip_faults() -> None:
    _chip_faults.clear()


def set_virtual_devices(n: Optional[int],
                        device: Optional[_device.DeviceLike] = None
                        ) -> None:
    """n slots, ids 0..n-1, all on one device (`device`, by default the
    default device); n = None restores the default inventory. The
    manager takes the new inventory at its next plan; its breakers are
    closed and its cap dropped."""
    global _virtual
    if n is not None and int(n) < 1:
        raise ValueError("set_virtual_devices needs n >= 1 (or None)")
    _virtual = None if n is None else (
        int(n), None if device is None else torch.device(device))
    if _MESH_MGR is not None:
        _MESH_MGR.forget_inventory()


@dataclass(frozen=True)
class MeshPlan:
    """One routing decision: the slots a launch may use. `mesh` is None
    for a single slot — callers take their single-device route, byte for
    byte the code path without a mesh."""
    epoch: int
    devices: Tuple[Slot, ...]
    mesh: Optional[Mesh]

    @property
    def n(self) -> int:
        """Shards this plan routes across (1 = single device)."""
        return len(self.devices) if self.mesh is not None else 1


def _probe_fn(x: torch.Tensor) -> torch.Tensor:
    """The liveness probe (reference :310-312), a torch expression: not a
    crypto program, and no kernel of the port."""
    return (x * x + 1).sum()


class CryptoMesh:
    """Process-wide mesh control plane (reference :315-523). One breaker
    a slot (`device.chip<N>`) in the process-wide registry: a slot whose
    probe fails after a mesh launch failed trips its own breaker and is
    evicted — the plan is rebuilt over the survivors and the launch
    retried there, so the global `device` breaker (and the host fallback
    behind it) only sees a failure when no healthy subset can run the
    work. Readmission rides the breaker's HALF_OPEN protocol: `plan()`
    probes a cooled-down slot once; success closes its breaker and the
    slot rejoins (epoch bump -> a new plan).

    A probe failure counts once (threshold 1): it ran on that slot alone
    right after a launch over it failed, and a false eviction costs
    little (the slot readmits itself after the cooldown). An OPEN slot
    breaker makes `utils.breaker.any_degraded()` true, so the health
    plane reports the plane degraded and the autotuner's degraded rule
    resets every unpinned knob, `crypto_shard_count` among them."""

    CHIP_PREFIX = "device.chip"

    def __init__(self) -> None:
        self._mu = make_lock("crypto_mesh", reentrant=True)
        self._devices: Optional[Tuple[Slot, ...]] = None
        self._inv_key = None
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._cap = 0                   # 0 = use every healthy slot
        self._epoch = 0
        self._meshes: Dict[Tuple[int, ...], Mesh] = {}
        self._kernels: Dict[Tuple, object] = {}
        # telemetry (read by health/status; plain ints under _mu)
        self.evictions = 0
        self.readmits = 0
        self.last_rebalance_ms = 0.0

    # -- inventory ----------------------------------------------------
    @staticmethod
    def _default_inventory() -> Tuple[Tuple[Slot, ...], object]:
        """-> (slots, the key they were taken under). A missing card with
        no request for the CPU raises device.NoDevice: it is not a host
        without chips (the reference's catch-all `()`, :359-360)."""
        if _virtual is not None:
            n, dev = _virtual
            dev = _device.default_device() if dev is None else dev
            return tuple(Slot(i, dev) for i in range(n)), ("virtual", n, dev)
        dev = _device.default_device()
        if dev.type == "cuda":
            slots = tuple(Slot(i, torch.device("cuda", i))
                          for i in range(torch.cuda.device_count()))
        else:
            slots = (Slot(0, dev),)
        return slots, ("default", dev)

    def _inventory(self) -> Tuple[Slot, ...]:
        with self._mu:                    # reentrant: plan() re-enters
            slots, key = self._default_inventory()
            if self._devices is None or key != self._inv_key:
                self._devices, self._inv_key = slots, key
                self._breakers = {}
                self._meshes, self._kernels = {}, {}
                if len(slots) > 1:
                    for s in slots:
                        self._breakers[s.id] = get_breaker(
                            f"{self.CHIP_PREFIX}{s.id}",
                            failure_threshold=1, cooldown_s=2.0,
                            max_cooldown_s=30.0)
            return self._devices

    def forget_inventory(self) -> None:
        """Take the inventory anew at the next plan (set_virtual_devices),
        with every slot breaker closed and the cap dropped."""
        with self._mu:
            for b in self._breakers.values():
                b.reset()
            self._devices, self._inv_key = None, None
            self._cap = 0

    def slots(self) -> Tuple[Slot, ...]:
        return self._inventory()

    def device_count(self) -> int:
        return len(self._inventory())

    def chip_breaker(self, device_id: int) -> Optional[CircuitBreaker]:
        self._inventory()
        return self._breakers.get(device_id)

    # -- knob actuator (tuning/wiring.py: crypto_shard_count) ---------
    def set_shard_count(self, v: int) -> None:
        """Cap the shard fan-out (the autotuner's actuator). 0 or at
        least the slot count means every healthy slot."""
        v = max(0, int(v))
        with self._mu:
            if v != self._cap:
                self._cap = v
                self._epoch += 1

    # -- probes -------------------------------------------------------
    def _probe(self, slot: Slot) -> None:
        """A tiny computation on ONE slot's device, read back. Runs
        outside device_section on purpose: probes must work while the
        global breaker is OPEN, and a slot's probe must never be
        attributed to the shared device."""
        if slot.id in _chip_faults:
            raise RuntimeError(f"injected chip fault on slot {slot.id}")
        x = torch.arange(16, dtype=torch.int32, device=slot.device)
        int(_probe_fn(x))

    # -- planning -----------------------------------------------------
    def plan(self) -> MeshPlan:
        """The current routing decision. Cooled-down evicted slots are
        probed for readmission here (one probe a cooldown expiry: the
        breaker's HALF_OPEN slot accounting limits it)."""
        devices = self._inventory()
        if len(devices) <= 1:
            return MeshPlan(0, devices, None)
        with self._mu:
            healthy: List[Slot] = []
            for s in devices:
                b = self._breakers[s.id]
                state = b.state
                if state == "half_open":
                    try:
                        with b.attempt("mesh_probe"):
                            self._probe(s)
                        state = b.state
                        if state == "closed":
                            self.readmits += 1
                            self._epoch += 1
                    except BreakerOpen:
                        continue        # probe slot taken / re-opened
                    except Exception:  # noqa: BLE001 — probe verdict
                        continue        # recorded by the attempt
                if state == "closed":
                    healthy.append(s)
            if self._cap:
                healthy = healthy[:self._cap]
            if len(healthy) <= 1:
                return MeshPlan(self._epoch,
                                tuple(healthy) or devices[:1], None)
            key = tuple(s.id for s in healthy)
            mesh = self._meshes.get(key)
            if mesh is None:
                mesh = self._meshes[key] = Mesh(healthy)
            return MeshPlan(self._epoch, tuple(healthy), mesh)

    def raise_if_faulted(self, plan: MeshPlan) -> None:
        """Surface an injected slot fault as the launch failure a dead
        device produces. Called by dispatch.mesh_launch inside its try."""
        if not _chip_faults:
            return
        bad = [s.id for s in plan.devices if s.id in _chip_faults]
        if bad:
            raise RuntimeError(
                f"injected chip fault: slot(s) {bad} in the plan")

    # -- failure handling --------------------------------------------
    def on_launch_failure(self, plan: MeshPlan, kind: str) -> bool:
        """A sharded launch raised: probe every slot it used, record each
        verdict on that slot's breaker (a failed probe evicts), rebuild
        the plan. True when the healthy set changed (the caller retries
        on the survivors); False when no slot could be blamed — the
        error is not a sick slot, and the caller re-raises it."""
        if plan.mesh is None:
            return False
        t0 = time.perf_counter()
        evicted = 0
        for s in plan.devices:
            b = self._breakers.get(s.id)
            if b is None:
                continue
            before = b.state
            try:
                with b.attempt(kind or "mesh"):
                    self._probe(s)
            except BreakerOpen:
                continue
            except Exception:  # noqa: BLE001 — the verdict is recorded
                pass
            if before == "closed" and b.state != "closed":
                evicted += 1
        if not evicted:
            return False
        with self._mu:
            self._epoch += 1
            self.evictions += evicted
        self.plan()     # rebuild now: the rebalance time includes it
        with self._mu:
            self.last_rebalance_ms = (time.perf_counter() - t0) * 1e3
        return True

    # -- per-plan launch state ----------------------------------------
    def cached_kernel(self, name: str, plan: MeshPlan,
                      builder: Callable[[Mesh], object]) -> object:
        """builder(plan.mesh), made once a name and slot set: the
        launcher closes over the plan's Mesh and its slot streams."""
        key = (name,) + tuple(s.id for s in plan.devices)
        with self._mu:
            kern = self._kernels.get(key)
            if kern is None:
                kern = self._kernels[key] = builder(plan.mesh)
            return kern

    # -- visibility / test isolation ---------------------------------
    def snapshot(self) -> Dict:
        """The inventory the last plan was made from (not taken anew: a
        health poll must not ask for the device)."""
        with self._mu:
            devices = self._devices or ()
            evicted = sorted(s.id for s in devices
                             if s.id in self._breakers
                             and self._breakers[s.id].state != "closed")
            return {"devices": len(devices),
                    "healthy": len(devices) - len(evicted),
                    "evicted": evicted,
                    "shard_count_cap": self._cap,
                    "epoch": self._epoch,
                    "evictions": self.evictions,
                    "readmits": self.readmits,
                    "last_rebalance_ms": round(self.last_rebalance_ms, 3)}

    def reset(self) -> None:
        """Test isolation: close every slot breaker, drop the cap."""
        with self._mu:
            for b in self._breakers.values():
                b.reset()
            self._cap = 0
            self._epoch += 1


_MESH_MGR: Optional[CryptoMesh] = None
_mesh_mgr_mu = make_lock("crypto_mesh_init")


def mesh_manager() -> CryptoMesh:
    """The process-wide CryptoMesh (all replicas of one process share one
    device pool, as they share the device breaker). Kernel call sites
    route through ops/dispatch.py's mesh tier, never here."""
    global _MESH_MGR
    if _MESH_MGR is None:
        with _mesh_mgr_mu:
            if _MESH_MGR is None:
                _MESH_MGR = CryptoMesh()
    return _MESH_MGR
