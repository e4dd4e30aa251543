"""The port's kernel wrappers and dispatch registry on the CPU: a CPU
tensor takes the plain version and launches nothing; resolution follows
the device; launch-config precedence and ``exclusive``; option names equal
the reference's; profiling counts by family and mode.
"""

import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro_torch.kernels import cuda_lib, dispatch, ops
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.paged_attention import kernel as tpk
from repro_torch.kernels.paged_attention import ref as tpr
from repro_torch.kernels.rmsnorm import kernel as trk
from repro_torch.kernels.rmsnorm import ref as trr

# tiny shapes: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the CPU under wall-clock-timed tests
torch.set_num_threads(1)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def T(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# wrappers and dispatch on the CPU
# --------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_and_launch_nothing():
    cuda_lib.reset_launches()
    x, w = arrays(11, (3, 64), (64,))
    np.testing.assert_array_equal(trk.rmsnorm_cuda(T(x), T(w)).numpy(),
                                  trr.rmsnorm_ref(T(x), T(w)).numpy())
    q, k, v = arrays(12, (1, 20, 4, 16), (1, 20, 2, 16), (1, 20, 2, 16))
    np.testing.assert_array_equal(
        tfk.flash_attention_cuda(T(q), T(k), T(v), kv_block=16).numpy(),
        tfr.attention_blockwise_ref(T(q), T(k), T(v), kv_block=16).numpy())
    lens = torch.tensor([20], dtype=torch.int32)
    np.testing.assert_array_equal(
        tfk.decode_attention_cuda(T(q[:, :1]), T(k), T(v), lens).numpy(),
        tfr.decode_attention_ref(T(q[:, :1]), T(k), T(v), lens).numpy())
    table = torch.zeros((1, 1), dtype=torch.int32)
    np.testing.assert_array_equal(
        tpk.paged_decode_attention_cuda(T(q[:, :1]), T(k), T(v), table,
                                        lens).numpy(),
        tpr.paged_decode_attention_ref(T(q[:, :1]), T(k), T(v), table,
                                       lens).numpy())
    assert all(n == 0 for n in cuda_lib.LAUNCHES.values())


def test_cpu_tensors_resolve_to_plain_versions():
    x, w = arrays(13, (2, 32), (32,))
    with dispatch.record_resolutions() as rec:
        ops.rmsnorm(T(x), T(w))
    assert [(r.family, r.mode) for r in rec] == [("rmsnorm", dispatch.REF)]
    assert dispatch.default_mode("cpu") == dispatch.REF
    assert dispatch.default_mode(torch.device("meta")) == dispatch.REF


def test_use_mode_is_explicit_scoped_and_validated():
    with dispatch.use_mode(dispatch.CUDA):
        assert dispatch.default_mode("cpu") == dispatch.CUDA
        with dispatch.use_mode(dispatch.REF):
            assert dispatch.default_mode("cpu") == dispatch.REF
        assert dispatch.default_mode("cpu") == dispatch.CUDA
    assert dispatch.default_mode("cpu") == dispatch.REF
    with pytest.raises(ValueError, match="not one of"):
        with dispatch.use_mode("pallas"):
            pass


def test_launch_config_precedence_and_exclusive():
    assert dispatch.launch_params("flash_attention") == {
        "q_block": 64, "kv_block": 64}
    assert dispatch.launch_params("flash_attention", kv_block=32)[
        "kv_block"] == 32
    with dispatch.use_launch_config({"flash_attention.kv_block": 32}):
        # a tuned config wins over the explicit call-site value
        assert dispatch.launch_params("flash_attention", kv_block=64)[
            "kv_block"] == 32
        with dispatch.use_launch_config({"rmsnorm.row_block": 8},
                                        exclusive=True):
            assert dispatch.launch_params("flash_attention")[
                "kv_block"] == 64
            assert dispatch.launch_params("rmsnorm")["row_block"] == 8
    with pytest.raises(KeyError):
        dispatch.split_launch_config({"flash_attention.bogus": 1})
    with pytest.raises(KeyError):
        dispatch.split_launch_config({"moe_router.chunk": 64})


def test_launch_space_keeps_reference_option_names():
    ours = dispatch.launch_space().names
    theirs = jdispatch.launch_space().names  # every family is ported
    assert ours == theirs
    # every domain value is one the simple kernels take
    assert dispatch.snap_down(1024, (32, 64)) == 64
    assert dispatch.snap_down(16, (32, 64)) == 32
    assert dispatch.snap_down(48, (32, 64)) == 32


def test_profile_dispatches_counts_by_family_and_mode():
    x, w = arrays(14, (2, 32), (32,))
    with dispatch.profile_dispatches() as prof:
        for _ in range(3):
            ops.rmsnorm(T(x), T(w))
    ops.rmsnorm(T(x), T(w))  # after the profile closed: not counted
    # the ops resolve without the generic router, which alone is timed
    assert prof.summary() == {"rmsnorm [ref]": {"resolutions": 3,
                                                "wall_s": 0.0}}
