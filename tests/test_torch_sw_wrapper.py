"""The Smith-Waterman kernel's wrapper layer (pepr_tpu_torch.ops.sw) and
the shared build (ops/_cuda.py): the C interface of csrc/sw.cu against
the ctypes argument lists the wrapper declares, the build command, the
CPU route of the dispatch to the plain version (launch counter stays 0),
the wrapper's refusals, and — on a machine with a CUDA card only
(marker `cuda`) — the kernel against its plain version."""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_pruning_wrapper import C_TYPES, _c_signatures

from pepr_tpu_torch.data.nt_scores import nt_kernel_matrix
from pepr_tpu_torch.ops import _cuda, sw
from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix, sw_align_batch,
                                               sw_align_batch_fast)

torch.set_num_threads(2)

KEYS = ("score", "matches", "length", "q_end", "t_end")


def test_sw_launcher_matches_declared_argtypes():
    sigs = _c_signatures(sw.SOURCE)
    assert set(sigs) == set(sw.ARGTYPES)
    for name, (ret, types) in sigs.items():
        assert [C_TYPES[t] for t in types] == sw.ARGTYPES[name], name
    assert sigs["sw_launch"][0] == "int"  # returns cudaGetLastError()
    assert sw.RESTYPES["sw_launch"] is ctypes.c_int


def test_sw_build_command_and_source():
    assert set(_cuda.SOURCES) == {"pruning", "sw", "hmm", "profile_dp"}
    cmd = _cuda.nvcc_command("nvcc", sw.SOURCE, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == sw.SOURCE
    src = open(sw.SOURCE).read()
    assert "torch/extension.h" not in src
    assert f"#define MAX_LEN {sw.MAX_LEN}" in src
    assert "pepr_tpu/ops/pallas_sw.py::_kernel" in src
    assert _cuda.lib_path("sw").startswith(_cuda.BUILD_DIR)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(4)
    q = rng.integers(0, 20, size=(6, 40)).astype(np.int8)
    t = rng.integers(0, 20, size=(6, 70)).astype(np.int8)
    t[::2, 5:35] = q[::2, 5:35]
    q[1, 30:] = 24
    return torch.as_tensor(q), torch.as_tensor(t)


def test_cpu_tensors_take_the_plain_version(pairs):
    q, t = pairs
    sw.reset_launch_counts()
    got = sw_align_batch_fast(q, t, kernel_matrix())
    assert sw.LAUNCHES == {"sw": 0}
    want = sw_align_batch(q, t, kernel_matrix())
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert got["score"].dtype == torch.float32
    assert all(got[k].dtype == torch.int32 for k in KEYS[1:])


def test_kernel_wrapper_refuses_cpu_tensors(pairs):
    q, t = pairs
    sw.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        sw.sw_align(q, t, sw.integer_sub(kernel_matrix()))
    assert sw.LAUNCHES == {"sw": 0}


@pytest.mark.parametrize("bad", ["fractional", "too_large", "shape"])
def test_integer_sub_refuses(bad):
    m = kernel_matrix()
    if bad == "fractional":
        m[0, 0] = 4.5
    elif bad == "too_large":
        m[0, 0] = 1e7
    else:
        m = m[:24, :24]
    with pytest.raises(ValueError):
        sw.integer_sub(m)


def test_integer_sub_and_gaps_accept_production_sets():
    for m in (kernel_matrix(), nt_kernel_matrix()):
        si = sw.integer_sub(m)
        assert si.dtype == torch.int32 and si.is_contiguous()
        assert torch.equal(si.to(torch.float32), torch.as_tensor(m))
    assert sw.check_gaps(11, 1) == (11, 1)
    assert sw.check_gaps(0, 0) == (0, 0)
    with pytest.raises(ValueError):
        sw.check_gaps(-1, 1)
    with pytest.raises(ValueError):
        sw.check_gaps(2.5, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("params", [("aa", 11, 1), ("nt", 5, 2),
                                    ("aa", 2, 2)])
def test_kernel_matches_plain_version_on_card(pairs, cuda_device, params):
    kind, go, ge = params
    q, t = (x.to(cuda_device) for x in pairs)
    if kind == "nt":
        q = torch.where(q == 24, q, q % 4)
        t = torch.where(t == 24, t, t % 4)
    sub = sw.integer_sub(kernel_matrix() if kind == "aa"
                         else nt_kernel_matrix(), cuda_device)
    sw.reset_launch_counts()
    got = sw_align_batch_fast(q, t, sub, go, ge)
    assert sw.LAUNCHES == {"sw": 1}
    want = sw_align_batch(q, t, sub, go, ge)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
