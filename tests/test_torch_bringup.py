"""The port's bring-up ladder (tpubft_torch/tools/bringup.py) and the plain
versions of its new kernels (ops/bringup_cuda.py) against the reference:
JAX's f25519.normalize, the reference ladder's own Python-int checks
(tools/pallas_bringup.py:136-194) and its Pallas rung bodies under the
Pallas interpreter. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubft.ops import f25519 as RF
from tpubft_torch.ops import bringup_cuda as bu
from tpubft_torch.ops import f25519 as F
from tpubft_torch.tools import bringup

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = torch.device("cpu")


def _loose(seed=7, n=bringup.TILE):
    return bringup._rand_elems(np.random.default_rng(seed), n) * 7


def test_plain_carry_equals_reference_normalize_limb_for_limb():
    a = _loose()
    want = np.asarray(RF.normalize(jnp.asarray(a)))
    got = bu.plain_carry(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, a)            # the carries did happen


@pytest.mark.parametrize("rung", range(5))
def test_plain_rungs_pass_the_reference_int_checks(rung):
    r = bringup.RUNGS[rung](np.random.default_rng(7), CPU, bringup.TILE)
    assert r.ok, r.report
    assert r.report["lanes"] == bringup.TILE


def test_plain_rung4_meets_the_reference_sampled_check():
    """tools/pallas_bringup.py:188-194, verbatim in ints: every 257th lane
    holds a^((a[0] & 3) + 1) * col0 mod p."""
    a = bringup._rand_elems(np.random.default_rng(7), bringup.TILE)
    col0 = bringup.base_niels_col0()
    got = bu.plain_table_gather(torch.from_numpy(a),
                                torch.from_numpy(F.int_to_limbs(col0)))
    for i in range(0, bringup.TILE, 257):
        av = F.limbs_to_int(a[:, i])
        k = int(a[0, i]) & 3
        assert F.limbs_to_int(got[:, i]) == pow(av, k + 1, F.P) * col0 % F.P


def test_plain_table_gather_with_another_constant():
    rng = np.random.default_rng(3)
    a = bringup._rand_elems(rng, 96)
    c = int.from_bytes(rng.bytes(32), "little") % F.P
    got = bu.plain_table_gather(torch.from_numpy(a),
                                torch.from_numpy(F.int_to_limbs(c))).numpy()
    for i in range(96):
        want = pow(F.limbs_to_int(a[:, i]), (int(a[0, i]) & 3) + 1, F.P) * c
        assert np.array_equal(got[:, i], F.int_to_limbs(want))


def test_plain_verify_rung_on_a_small_corpus():
    r = bringup.rung5(np.random.default_rng(7), CPU, 48)
    assert r.ok, r.report
    assert 0 < r.report["valid"] < 48


def test_ladder_stops_at_the_first_failing_rung(monkeypatch):
    def failing(rng, dev, lanes):
        r = bringup.rung0(rng, dev, lanes)
        r.report["mismatches_vs_int"] = 1
        return r
    monkeypatch.setattr(bringup, "RUNGS",
                        [bringup.rung0, failing, bringup.rung2])
    done = bringup.run_ladder(CPU, lanes=16)
    assert [r.ok for r in done] == [True, False]
    assert bringup.main(["--cpu", "--lanes", "16"]) == 1


def test_ladder_cli_on_the_cpu_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "tpubft_torch.tools.bringup", "--cpu",
         "--lanes", "64"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count(": OK (") == len(bringup.RUNGS)


def test_ladder_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bringup.main(["--rung", "0"]) == 2


@pytest.mark.parametrize("call", [
    lambda a: bu.bringup_copy(a), lambda a: bu.fe_carry(a),
    lambda a: bu.fe_table_gather(a, a[:, 0].contiguous()),
    lambda a: bu.fe_inv(a)],
    ids=["bringup_copy", "fe_carry", "fe_table_gather", "fe_inv"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    a = torch.zeros((F.NL, 8), dtype=torch.int32)
    before = dict(bu.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(a)
    assert bu.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["bringup_copy", "fe_carry",
                                    "fe_table_gather", "fe_mul", "fe_inv"])
def test_work_counts_scale_with_lanes(kernel):
    ops1, bytes1 = bu.work(kernel, 1)
    ops2, bytes2 = bu.work(kernel, 1024)
    assert 0 < ops1 and 0 < bytes1
    if kernel == "fe_inv":         # the chain, from bringup_cuda's counts
        assert ops1 == bu.CHAIN_SQR * (2 * 55 + 9) \
            + bu.CHAIN_MUL * (2 * 100 + 9)
    assert ops2 == 1024 * ops1
    assert bytes2 > 512 * bytes1


@pytest.mark.parametrize("sms", [1, 132])
def test_fe_inv_lanes_rule(sms):
    """Four lanes an element while 4n threads are one warp per SM
    partition, one above."""
    assert bu.lanes_for(1, sms) == 4
    assert bu.lanes_for(32 * sms, sms) == 4
    assert bu.lanes_for(32 * sms + 1, sms) == 1
    assert bu.lanes_for(1 << 17, sms) == 1


def test_fe_inv_yardsticks():
    """The function's work is the chain's 254 squares and 11 multiplies
    whatever the lanes; four lanes execute more, one lane about as much;
    the chain floor is the 265 steps at the cycles a step given."""
    assert (bu.CHAIN_SQR, bu.CHAIN_MUL, bu.CHAIN_STEPS) == (254, 11, 265)
    need = bu.work("fe_inv", 1024)[0]
    assert bu.executed_ops(1024, 4) > need
    assert 0.9 * need < bu.executed_ops(1024, 1) < 1.2 * need
    assert bu.chain_floor_ms(0, 1980.0, 368.0) == 0.0
    assert bu.chain_floor_ms(1024, 1980.0, 368.0) == pytest.approx(
        265 * 368.0 / 1.98e6)
    with pytest.raises(ValueError):
        bu.executed_ops(1024, 2)


def test_work_refuses_unknown_kernel():
    with pytest.raises(ValueError):
        bu.work("fe_sqrt", 1)


# ---- against the reference's Pallas rung bodies, interpreted ----

@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    import tools.pallas_bringup as pb
    real = pl.pallas_call

    def interp(*a, **kw):
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return real(*a, **kw)
    monkeypatch.setattr(pl, "pallas_call", interp)
    return pb


def test_copy_and_carry_equal_the_interpreted_pallas_rungs(pallas_interpret):
    pb = pallas_interpret
    a = _loose()
    want0 = pb._run_elemwise(pb._body_copy, 1, a)
    want1 = pb._run_elemwise(pb._body_carry, 1, a)
    ta = torch.from_numpy(a)
    assert np.array_equal(bu.plain_copy(ta).numpy(), want0)
    assert np.array_equal(bu.plain_carry(ta).numpy(), want1)


def test_table_gather_equals_the_interpreted_pallas_rung(pallas_interpret):
    """Rung 4's Pallas body leaves loose limbs; the port's are canonical,
    so the two agree mod p, lane for lane."""
    pb = pallas_interpret
    a = bringup._rand_elems(np.random.default_rng(7), pb.TILE)
    btab = jnp.asarray(pb.kp._btab_transposed())
    out = pb.pl.pallas_call(
        pb._body_table,
        in_specs=[pb._ELEM_SPEC,
                  pb.pl.BlockSpec(btab.shape, lambda: (0, 0),
                                  memory_space=pb.pltpu.VMEM),
                  pb._CONST_SPEC],
        out_specs=pb._ELEM_SPEC,
        out_shape=pb.jax.ShapeDtypeStruct((F.NL, pb.SUB, pb.T8), jnp.int32),
        scratch_shapes=[pb.pltpu.VMEM((4, F.NL, pb.SUB, pb.T8), jnp.int32)],
    )(pb._shaped(a), btab, pb._consts())
    want = np.asarray(out).reshape(F.NL, pb.TILE)
    col0 = int(F.limbs_to_int(np.asarray(pb.kp._btab_transposed())[:, 0]))
    assert col0 == bringup.base_niels_col0()
    got = bu.plain_table_gather(torch.from_numpy(a), torch.from_numpy(
        F.int_to_limbs(col0))).numpy()
    for i in range(pb.TILE):
        assert F.limbs_to_int(got[:, i]) == F.limbs_to_int(want[:, i])
