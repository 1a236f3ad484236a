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
    lambda: probes.dyn_slice(torch.ones((1, 100, 128))),            # H <= 168
], ids=["smem-size", "hbm-dtype", "dyn-rows"])
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
