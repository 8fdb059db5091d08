"""Slot parallelism for the crypto data plane (port of tpubft/parallel):
sharded launches over the slots of a plan, one launch a slot and a
gather on the host, and the mesh's control plane (sharding.py)."""
from tpubft_torch.parallel.sharding import (  # noqa: F401
    make_mesh, set_virtual_devices, sharded_msm_kernel,
    sharded_verify_ed25519)
