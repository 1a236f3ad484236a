"""The platform probes of the PyTorch port (kernels/probes.py) against a
numpy statement of what each Pallas probe body of scripts/probe_tpu.py
computes (`kern_c`, `kern_e`, `kern_f`, `kern_d`; they are closures inside
its `main()` and cannot be imported).  `kern_f` and `kern_d` add into an
output they never initialise; the port defines it as zero, and so do the
statements here.

On the CPU each probe runs its plain version.  Every probe is a chain of
single-rounded f32 operations in a fixed order, so the comparison is exact.
The host plans that the kernels take (`stream_plan`, `dyn_slice_plan`) and
the arguments that the wrappers pass to the kernels are checked here; the
kernels themselves only on the card (`chip_smoke.py` phase 3).
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


def _kern_d(a, qv, n_offsets, steps):
    """kern_d's statement at any shape: `steps` times, for each of the
    n_offsets offsets q in order, out[0:qv] += a[q:q + qv]; rows qv on stay
    zero."""
    h = a.shape[1]
    want = np.zeros_like(a)
    for _ in range(steps):
        for r in range(n_offsets):
            q = ((r * 29) % (h - qv) // 8) * 8
            want[0, 0:qv, :] += a[0, q:q + qv, :]
    return want


@pytest.mark.parametrize("n_offsets", [1, 20])
@pytest.mark.parametrize("qv_last", [False, True], ids=["qv8", "qvH-1"])
@pytest.mark.parametrize("w", [136, 900])
@pytest.mark.parametrize("h", [200, 1100])
def test_dyn_slice_at_other_shapes(h, w, qv_last, n_offsets):
    """kern_d's statement at shapes other than the probe's, one step: widths
    that are no multiple of a strip, 8 output rows and all rows but one (one
    offset row, q = 0), one offset and twenty."""
    qv = h - 1 if qv_last else 8
    a = np.random.default_rng(h + w + qv + n_offsets).uniform(-2.0, 2.0, (1, h, w)
                                                              ).astype(np.float32)
    got = to_np(probes.dyn_slice(torch.as_tensor(a), qv, n_offsets, steps=1))
    np.testing.assert_array_equal(got, _kern_d(a, qv, n_offsets, 1))


# (H, W, qv, n_offsets, strip, band): the probe's shape under the built plan
# and other items, the ragged shapes of test_dyn_slice_at_other_shapes, a
# width no multiple of 4, and many offsets.
PLAN_CASES = [(576, 896, 168, 20, probes.DYN_STRIP, probes.DYN_BAND), (576, 896, 168, 20, 1, 42),
              (576, 896, 168, 20, 4, 12), (200, 136, 8, 20, 2, 24), (200, 900, 199, 20, 2, 24),
              (1100, 136, 1099, 1, 2, 24), (1100, 900, 8, 20, 2, 24), (1100, 900, 1099, 20, 1, 84),
              (200, 901, 8, 20, 2, 24), (200, 3, 150, 20, 2, 24), (3000, 64, 40, 300, 2, 24)]


@pytest.mark.parametrize("n_sms", [1, 132])
@pytest.mark.parametrize("h, w, qv, n_offsets, strip, band", PLAN_CASES)
def test_dyn_slice_plan_covers_the_output(h, w, qv, n_offsets, strip, band, n_sms):
    """dyn_slice's plan: every output (row, float4 column) of the first qv
    rows in exactly one item; each item's staged rows hold q_k + r for every
    offset and every row of its band; each batch's staged rows fit 227 KB
    and the largest is the plan's; the items split evenly over at most
    n_sms blocks, and a batch fits 1,024 threads.  This holds the plan's
    statement of the staging rule (`DynSlicePlan.staged`), which sizes the
    shared memory the kernel gets; that the kernel stages by the same rule
    shows only on the card, where it equals its plain version exactly."""
    offs = probes.offsets(h, qv, n_offsets)
    plan = probes.dyn_slice_plan(h, w, qv, offs, n_sms, strip, band)
    owner = np.zeros((qv, -(-w // 4)), int)
    for i in range(plan.n_items):
        rows, cols, staged = plan.item(i)
        owner[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert all(q + r in staged for q in offs for r in rows)
    np.testing.assert_array_equal(owner, 1)
    smem = [16 * plan.strip * sum(map(len, plan.staged(b0, b1).values()))
            for b0, b1 in plan.batches()]
    assert max(smem) == plan.smem_bytes <= probes.SMEM_BYTES
    lengths = np.diff(plan.starts)
    assert len(lengths) == min(plan.n_items, n_sms) and lengths.max() - lengths.min() <= 1
    assert plan.batch * plan.strip * plan.band <= plan.threads <= probes.MAX_THREADS


def test_dyn_slice_plan_at_the_probe_shape():
    """(1, 576, 896), 168 rows, 20 offsets on 132 SMs: items of 2 float4 x
    24 rows, 784 of them, 5 or 6 a block, each block's 6 staged at once by
    288 threads; offsets 0 to 400, so a strip stages its rows and 400 more."""
    plan = probes.dyn_slice_plan(H, W, 168, probes.offsets(H), 132)
    assert (plan.strip, plan.band, plan.n_items, plan.batch, plan.threads) == (2, 24, 784, 6,
                                                                              288)
    assert (plan.q_min, plan.span) == (0, 400)
    assert sorted(set(np.diff(plan.starts))) == [5, 6]


@pytest.mark.parametrize("n4", [1, 100, 132 * 20, 129_024, 275_000])
def test_copy_plan_covers_the_vectors(n4):
    """smem_copy's slices, as the wrapper passes their starts on 132 SMs:
    the n / 4 vectors once each, in order; one slice an SM (or a vector);
    lengths differ by at most one."""
    n_slices, starts = probes._plan_starts(n4, 132)
    bounds = list(starts)
    covered = np.concatenate([np.arange(s, e) for s, e in zip(bounds, bounds[1:])])
    np.testing.assert_array_equal(covered, np.arange(n4))
    lengths = np.diff(bounds)
    assert n_slices == min(n4, 132) and lengths.max() - lengths.min() <= 1


def test_copy_plan_at_the_probe_shape():
    """(1, 576, 896) f32 on 132 SMs: 129,024 vectors, 60 slices of 978 and
    72 of 977, one vector a thread."""
    lengths = [n for _, n in probes.stream_plan(H * W // 4, 132)]
    assert lengths == [978] * 60 + [977] * 72


class _Recorder:
    """Stands in for the probes library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def card_path(monkeypatch):
    """Send a CPU tensor down the wrappers' CUDA path into a `_Recorder`:
    what each wrapper passes to its kernel, on `n_sms` SMs."""
    lib = _Recorder()
    monkeypatch.setattr(probes, "_library", lambda: lib)
    monkeypatch.setattr(probes, "_check", lambda *args: True)
    monkeypatch.setattr(probes, "_stream", lambda a: 0)
    for fn in (probes.smem_copy, probes.dyn_slice):
        monkeypatch.setattr(fn, "launches", 0)

    def on(n_sms):
        monkeypatch.setattr(probes, "_n_sms", lambda a: n_sms)
        return lib
    return on


@pytest.mark.parametrize("n4, n_sms, n_slices", [(129_024, 132, 132), (100, 132, 100),
                                                 (132 * 20, 132, 132),
                                                 (10_000, 300, probes.MAX_SLICES)])
def test_smem_copy_kernel_gets_the_plan(card_path, n4, n_sms, n_slices):
    """What smem_copy passes to its kernel: the size, 64 passes of 4 round
    trips, and stream_plan's starts ending at n4, one slice an SM, at most
    MAX_SLICES; one launch."""
    lib = card_path(n_sms)
    probes.smem_copy(torch.zeros(4 * n4))
    n, passes, reps, got_slices, starts = lib.calls["smem_copy"][2:7]
    plan = probes.stream_plan(n4, min(n_sms, probes.MAX_SLICES))
    assert (n, passes, reps, got_slices) == (4 * n4, probes.PASSES, probes.REPS, n_slices)
    assert list(starts) == [start for start, _ in plan] + [n4]
    assert probes.smem_copy.launches == 1


@pytest.mark.parametrize("h, w, qv, n_offsets, n_sms", [(576, 896, 168, 20, 132),
                                                       (1100, 900, 8, 20, 132),
                                                       (200, 136, 199, 1, 300),
                                                       (3000, 64, 40, 300, 132)])
def test_dyn_slice_kernel_gets_the_plan(card_path, h, w, qv, n_offsets, n_sms):
    """What dyn_slice passes to its kernel: the shape and step count, the
    offsets of `offsets` in order, the plan's items, batch and shared memory
    (above 48 KB in the last case), and the blocks' first items ending at the
    item count, at most MAX_SLICES blocks; one launch."""
    lib = card_path(n_sms)
    probes.dyn_slice(torch.zeros((1, h, w)), qv, n_offsets, steps=3)
    args = lib.calls["dyn_slice"]
    plan = probes.dyn_slice_plan(h, w, qv, probes.offsets(h, qv, n_offsets), n_sms)
    assert args[2:7] == (h, w, qv, 3, n_offsets)
    assert list(args[7]) == probes.offsets(h, qv, n_offsets)
    assert args[8:13] == (plan.strip, plan.band, plan.batch, plan.smem_bytes,
                          len(plan.starts) - 1)
    assert list(args[13]) == list(plan.starts) and plan.starts[-1] == plan.n_items
    assert len(plan.starts) - 1 == min(plan.n_items, n_sms, probes.MAX_SLICES)
    assert probes.dyn_slice.launches == 1


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
    lambda: probes.dyn_slice(torch.ones((1, 200, 8)),               # more offsets than
                             n_offsets=probes.MAX_OFFSETS + 1),     # the kernel takes
    lambda: probes.dyn_slice(torch.ones((1, 200, 8)), steps=0),
    # 512 offsets reach 14,816 rows: one float4 of them is 237 KB
    lambda: probes.dyn_slice_plan(15_000, 4, 8, probes.offsets(15_000, 8, 512), 132),
    lambda: probes.dyn_slice_plan(200, 8, 8, [0, 193], 132),        # offset past H - qv
    lambda: probes.dyn_slice_plan(3000, 8, 2000, [0], 132, strip=1, band=1100),  # 1,100 threads
    lambda: probes.smem_copy(torch.ones(8), passes=0),              # no round trip
], ids=["smem-size", "hbm-dtype", "hbm-block", "dyn-rows", "step-blocks", "step-size",
        "step-dtype", "plan-empty", "plan-no-sms", "dyn-offsets", "dyn-steps", "dyn-no-plan",
        "dyn-offset-range", "dyn-threads", "copy-passes"])
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
