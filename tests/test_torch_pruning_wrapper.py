"""The pruning kernels' wrapper layer (pepr_tpu_torch.ops.pruning): the
C interface of csrc/pruning.cu against the ctypes argument lists the
wrapper declares, the CPU route to the plain versions (launch counters
stay 0), the wrapper's refusals, and — on a machine with a CUDA card
only (marker `cuda`) — each kernel against its plain version."""

import ctypes
import re

import numpy as np
import pytest
import torch

from pepr_tpu_torch.ops import _cuda
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.ops import pruning
from pepr_tpu_torch.tree import parse_newick
from pepr_tpu_torch.utils.simulate import random_tree, simulate_alignment

torch.set_num_threads(2)

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "int": ctypes.c_int}


def _c_signatures(source=pruning.SOURCE):
    """name -> (return type, [parameter types]) of every function in the
    source's extern "C" block."""
    src = open(source).read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^([\w ]+?\*?)\s*(\w+)\(([^)]*)\)\s*\{", block,
                         re.M):
        ret, name, params = m.group(1).strip(), m.group(2), m.group(3)
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if not p or p == "void":
                continue
            types.append(re.sub(r"\s*\w+$", "", p).replace(" *", "*"))
        out[name] = (ret, types)
    return out


def test_source_launchers_match_declared_argtypes():
    sigs = _c_signatures()
    assert {"pruning_fwd_launch", "pruning_bwd_launch"} <= set(sigs)
    assert set(sigs) == set(pruning.ARGTYPES)
    for name, (ret, types) in sigs.items():
        assert [C_TYPES[t] for t in types] == pruning.ARGTYPES[name], name
    for name in ("pruning_fwd_launch", "pruning_bwd_launch"):
        assert sigs[name][0] == "int"  # returns cudaGetLastError()
        assert pruning.RESTYPES[name] is pruning._I


def test_build_command_targets_sm90a_without_torch_headers():
    cmd = _cuda.nvcc_command("nvcc", pruning.SOURCE, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1] == pruning.SOURCE
    src = open(pruning.SOURCE).read()
    assert "torch/extension.h" not in src
    assert "atomicAdd" not in src  # the gradient is reduced in order
    assert _cuda.lib_path("pruning").startswith(_cuda.BUILD_DIR)
    assert "pruning" in _cuda.SOURCES
    for macro, value in (("WARP", pruning.WARP),
                         ("MAXC", pruning.MAX_CATS),
                         ("PLAN_W", pruning.PLAN_W),
                         ("SITES_PER_LANE", pruning.SITES_PER_LANE),
                         ("WARPS_PER_CAT", pruning.WARPS_PER_CAT)):
        assert re.search(rf"#define {macro} {value}\b", src), macro


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    tree = parse_newick("(((A:0.1,B:0.2):0.1,(C:0.15,D:0.1):0.2):0.05,"
                        "(E:0.1,F:0.3):0.1);")
    codes, taxa = simulate_alignment(tree, 150, rng, alpha=0.5)
    codes[rng.random(codes.shape) < 0.1] = 23
    arr = tlik.tree_to_arrays(tree, taxa)
    model = tlik.WagModel.create(0.5)
    blen = torch.as_tensor(np.stack([arr.blen, arr.blen * 0.5]))
    return (torch.as_tensor(codes),
            torch.as_tensor(np.stack([arr.children] * 2)),
            tlik.transition_matrices(model, blen).contiguous(),
            torch.as_tensor(model.pi),
            torch.as_tensor(rng.random((2, 150)).astype(np.float32)))


def test_cpu_tensors_take_the_plain_versions(small):
    codes, ch, pm, pi, ct = small
    pruning.reset_launch_counts()
    p = pm.clone().requires_grad_(True)
    ll = pruning.site_ll(codes, ch, p, pi)
    (ll * ct).sum().backward()
    assert pruning.LAUNCHES == {"pruning_fwd": 0, "pruning_bwd": 0}
    torch.testing.assert_close(ll.detach(),
                               pruning.site_ll_reference(codes, ch, pm, pi),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        p.grad, pruning.site_ll_grad_reference(codes, ch, pm, pi, ct),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(small, which):
    codes, ch, pm, pi, ct = small
    pruning.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        if which == "fwd":
            pruning.pruning_fwd(codes, ch, pm, pi)
        else:
            pruning.pruning_bwd(codes, ch, pm, pi, ct)
    assert pruning.LAUNCHES == {"pruning_fwd": 0, "pruning_bwd": 0}


def test_per_tree_codes_match_shared_codes(small):
    codes, ch, pm, pi, _ = small
    per_tree = codes[None].expand(2, -1, -1).contiguous()
    torch.testing.assert_close(pruning.site_ll_reference(per_tree, ch, pm,
                                                         pi),
                               pruning.site_ll_reference(codes, ch, pm, pi),
                               rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(small, cuda_device):
    codes, ch, pm, pi, ct = (t.to(cuda_device) for t in small)
    ll = pruning.pruning_fwd(codes, ch, pm, pi)
    g = pruning.pruning_bwd(codes, ch, pm, pi, ct)
    ll_ref = pruning.site_ll_reference(codes, ch, pm, pi)
    g_ref = pruning.site_ll_grad_reference(codes, ch, pm, pi, ct)
    assert torch.all((ll - ll_ref).abs() <= 1e-5 * ll_ref.abs() + 1e-5)
    assert float((g - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())


@pytest.mark.cuda
def test_site_ll_autograd_launches_both_kernels(small, cuda_device):
    codes, ch, pm, pi, ct = (t.to(cuda_device) for t in small)
    pruning.reset_launch_counts()
    p = pm.clone().requires_grad_(True)
    (pruning.site_ll(codes, ch, p, pi) * ct).sum().backward()
    assert pruning.LAUNCHES == {"pruning_fwd": 1, "pruning_bwd": 1}


def test_plain_gradient_sums_site_tiles_pairwise(monkeypatch):
    """site_ll_grad_reference over tiles of GRAD_TILE sites, the tiles'
    gradients summed pairwise (PERF.md, F4): one tile gives the plain
    autograd pass bit for bit; seven tiles of 16 sites agree with it
    within 1e-6 of the largest entry, and with the float64 gradient
    within 1e-5 (float32 round-off of the per-site terms)."""
    rng = np.random.default_rng(17)
    taxa = [f"t{i}" for i in range(9)]
    arr = tlik.tree_to_arrays(random_tree(taxa, rng), taxa)
    model = tlik.WagModel.create(0.5)
    pm = tlik.transition_matrices(model, torch.as_tensor(arr.blen[None]))
    codes = torch.as_tensor(rng.integers(0, 23, size=(9, 100))
                            .astype(np.int8))
    ch = torch.as_tensor(arr.children[None])
    pi = torch.as_tensor(model.pi)
    ct = torch.as_tensor(rng.random((1, 100)).astype(np.float32))
    whole = pruning.site_ll_grad_reference(codes, ch, pm, pi, ct)
    with torch.enable_grad():
        p = pm.detach().requires_grad_(True)
        (one,) = torch.autograd.grad(
            (pruning.site_ll_reference(codes, ch, p, pi) * ct).sum(), p)
    assert torch.equal(whole, one)
    monkeypatch.setattr(pruning, "GRAD_TILE", 16)
    tiled = pruning.site_ll_grad_reference(codes, ch, pm, pi, ct)
    wide = pruning.site_ll_grad_reference(codes, ch, pm.double(),
                                          pi.double(), ct.double())
    scale = float(wide.abs().max())
    assert float((tiled - whole).abs().max()) <= 1e-6 * scale
    assert float((tiled.double() - wide).abs().max()) <= 1e-5 * scale
