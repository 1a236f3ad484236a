"""The platform probes of the PyTorch port (kernels/probes.py) against a
numpy statement of what each Pallas probe body of scripts/probe_tpu.py
computes (`kern_c`, `kern_e`, `kern_f`, `kern_d`; they are closures inside
its `main()` and cannot be imported).  `kern_f` and `kern_d` add into an
output they never initialise; the port defines it as zero, and so do the
statements here.

On the CPU each probe runs its plain version.  Every probe is a chain of
single-rounded f32 operations in a fixed order, so the comparison is exact.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from _torch_util import to_np

from dvs_mcemvs_torch.kernels import probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 576, 896   # the TPU probes' block


def _a32(seed):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (1, H, W)).astype(np.float32)


def test_smem_copy_is_run_c():
    """kern_c: scr = a * 1.0001; out = scr * 1.0001, R = 4 times in each of
    64 steps, each time the same value."""
    a = _a32(40)
    scale = np.float32(1.0001)
    scr = a[0] * scale
    want = scr * scale
    np.testing.assert_array_equal(to_np(probes.smem_copy(torch.as_tensor(a)))[0], want)


def test_block_step_is_run_e():
    """kern_e: out = a + 1 on one (8, 128) tile, 4096 times."""
    a = np.random.default_rng(41).uniform(-2.0, 2.0, (1, 8, 128)).astype(np.float32)
    np.testing.assert_array_equal(to_np(probes.block_step(torch.as_tensor(a))),
                                  a + np.float32(1.0))


def test_hbm_stream_is_run_f():
    """kern_f: out += a[g] in f32 over g in order, from a zero output.  A
    smaller stream than the probe's 256 blocks of 576 x 896: the statement is
    the same for any block count and shape."""
    a = torch.as_tensor(np.random.default_rng(42).uniform(-4.0, 4.0, (24, 64, 256)),
                        dtype=torch.float32).to(torch.bfloat16)
    a_np = a.to(torch.float32).numpy()
    want = np.zeros((1, 64, 256), np.float32)
    for g in range(a_np.shape[0]):
        want[0] += a_np[g]
    got = probes.hbm_stream(a)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("shape", [(1, 64, 256), (3, 64, 256), (3, 8)],
                         ids=["G1", "G3", "block-of-8"])
def test_hbm_stream_small_streams(shape):
    """kern_f's statement at one and three blocks (fewer than the kernel's
    ring stages) and at blocks of 8 values (one 16-byte vector)."""
    a = torch.as_tensor(np.random.default_rng(44).uniform(-4.0, 4.0, shape),
                        dtype=torch.float32).to(torch.bfloat16)
    a_np = a.to(torch.float32).numpy()
    want = np.zeros((1, *shape[1:]), np.float32)
    for g in range(shape[0]):
        want[0] += a_np[g]
    np.testing.assert_array_equal(to_np(probes.hbm_stream(a)), want)


@pytest.mark.parametrize("n_sms", [1, 78, 132])
@pytest.mark.parametrize("n8", [1, 7, 131, 132, 133, 64_512])
def test_stream_plan_splits_evenly(n8, n_sms):
    """hbm_stream's slices: every vector in exactly one slice, in order;
    lengths differ by at most one; no more slices than SMs; none empty.
    The kernel's block i sums slice i of this plan, as the wrapper passes
    it (`test_kernel_gets_the_plan`)."""
    plan = probes.stream_plan(n8, n_sms)
    starts = [start for start, _ in plan]
    lengths = [length for _, length in plan]
    assert len(plan) == min(n8, n_sms)
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    covered = np.concatenate([np.arange(s, s + n) for s, n in plan])
    np.testing.assert_array_equal(covered, np.arange(n8))
    assert starts == sorted(starts)


@pytest.mark.parametrize("n8, n_sms, n_slices", [(64_512, 132, 132), (7, 132, 7),
                                                 (1000, 300, probes.MAX_SLICES)])
def test_kernel_gets_the_plan(n8, n_sms, n_slices):
    """The slice count and starts that hbm_stream passes to the kernel:
    stream_plan's starts and n8, at most MAX_SLICES slices."""
    got_slices, starts = probes._plan_starts(n8, n_sms)
    plan = probes.stream_plan(n8, min(n_sms, probes.MAX_SLICES))
    assert got_slices == len(plan) == n_slices
    assert list(starts) == [start for start, _ in plan] + [n8]


def test_stream_plan_at_the_probe_shape():
    """(256, 576, 896) bf16 on 132 SMs: 64,512 vectors, 96 slices of 489
    and 36 of 488."""
    lengths = [n for _, n in probes.stream_plan(576 * 896 // 8, 132)]
    assert lengths == [489] * 96 + [488] * 36


def test_dyn_slice_is_run_d():
    """kern_d: 64 steps of 20 row slices a[q_r : q_r + 168] accumulated into
    out[0:168], q_r = ((29 r) mod (H - 168)) // 8 * 8; rows 168 on stay zero."""
    a = _a32(43)
    qv = 168
    want = np.zeros((1, H, W), np.float32)
    for _ in range(64):
        for r in range(20):
            q = ((r * 29) % (H - qv) // 8) * 8
            scr = a[0, q:q + qv, :]
            want[0, 0:qv, :] += scr
    got = to_np(probes.dyn_slice(torch.as_tensor(a)))
    np.testing.assert_array_equal(got, want)
    assert not got[0, qv:].any()


def test_cpu_probes_launch_no_kernel():
    for fn in (probes.smem_copy, probes.block_step, probes.hbm_stream, probes.dyn_slice):
        fn.launches = 0
    a = torch.ones((1, 176, 128))
    probes.smem_copy(a)
    probes.block_step(a)
    probes.hbm_stream(torch.ones((2, 8, 16), dtype=torch.bfloat16))
    probes.dyn_slice(a)
    assert [fn.launches for fn in (probes.smem_copy, probes.block_step,
                                   probes.hbm_stream, probes.dyn_slice)] == [0, 0, 0, 0]


@pytest.mark.parametrize("call", [
    lambda: probes.smem_copy(torch.ones(6)),                        # not a multiple of 4
    lambda: probes.hbm_stream(torch.ones((2, 8), dtype=torch.float32)),  # not bf16
    lambda: probes.hbm_stream(torch.ones((2, 12), dtype=torch.bfloat16)),  # 12 values
    lambda: probes.dyn_slice(torch.ones((1, 100, 128))),            # H <= 168
    lambda: probes.block_step(torch.ones((1, 8, 128)), n_blocks=0),
    lambda: probes.block_step(torch.ones(6)),                       # not a multiple of 4
    lambda: probes.block_step(torch.ones((1, 8, 128), dtype=torch.float64)),
    lambda: probes.stream_plan(0, 132),                             # no vectors
    lambda: probes.stream_plan(8, 0),                               # no SMs
], ids=["smem-size", "hbm-dtype", "hbm-block", "dyn-rows", "step-blocks", "step-size",
        "step-dtype", "plan-empty", "plan-no-sms"])
def test_probes_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_probe_gpu_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(
        "probe_gpu", os.path.join(REPO, "scripts", "probe_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.measure(min_time=0.01)
