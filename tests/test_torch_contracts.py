"""The port's kernel contracts (``repro_torch.analysis.kernel_contracts``)
against the reference's, on the CPU: every pass must catch.

* every kernel package declares a ``CONTRACT`` whose grid holds each of the
  reference contract's cases, name for name, dims equal, and passes clean
  at ``device="cpu"``;
* every wrapper launches with the numbers of its contract's plan: with the
  launch branch forced on CPU tensors and ``common.launch`` stood in for,
  each case's launches equal ``CONTRACT.plan(dims)`` symbol for symbol and
  int for int;
* each failure class is caught by a stand-in contract or source, with its
  ``[contract / case / check]`` message, and the matching clean case is
  clean: shared memory 1 B over the limit, 1,056 threads, ``grid.y``
  65,536, a ragged division, a CTA past the extent and a missed tail,
  ``expect_async_copy`` without ``cp.async``, ``cp.async`` without a wait
  or with its last copy after its last wait, ``.item()`` in a wrapper at an
  ``expect_no_host_read`` case, a wrapper that reaches no kernel;
* on a card (marker ``cuda``; skipped here): each plan equal to its
  source's C ``<launcher>_plan``, and every contract clean on the card.
  These import no JAX: ``pytest -m cuda --noconftest`` runs them there.
"""
from __future__ import annotations

import functools

import pytest
import torch

from repro_torch.analysis import op_trace
from repro_torch.analysis.kernel_contracts import (
    KernelContract,
    ShapeCase,
    all_contracts,
    c_launch_plan,
    check_contract,
    python_launch_plan,
)
from repro_torch.kernels import common

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONTRACTS = all_contracts()


def _ref_contracts():
    """The reference's registry (imported here, not at the top, so that the
    card's tests of this file need no JAX)."""
    from repro.analysis.kernel_contracts import all_contracts as ref_all_contracts

    return ref_all_contracts()


# --------------------------------------------------------------------------
# the checked-in registry
# --------------------------------------------------------------------------


def test_every_kernel_package_declares_a_contract():
    assert set(CONTRACTS) == set(_ref_contracts()) == {
        "block_prune", "block_prune_csr", "block_topk", "chunk_step",
        "impact_scatter", "impact_scatter_topk", "sparse_score",
    }


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_checked_in_contract_passes(name):
    violations = check_contract(CONTRACTS[name], device="cpu")
    assert violations == [], "\n".join(str(v) for v in violations)


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_port_grid_holds_the_reference_cases(name):
    port = {c.name: c for c in CONTRACTS[name].shape_grid}
    ref = _ref_contracts()[name]
    for case in ref.shape_grid:
        assert case.name in port, case.name
        assert port[case.name].dims == case.dims, case.name
        assert not port[case.name].port
    # the port's own cases are marked as such
    ref_names = {c.name for c in ref.shape_grid}
    assert all(c.port for n, c in port.items() if n not in ref_names)


def test_scatter_and_dense_prune_contracts_expect_async_copy():
    # the copies of impact_scatter and block_prune are the only ones the
    # sources issue; a refactor that drops them (or adds some) must trip
    want = {"impact_scatter", "block_prune"}
    assert {n for n, c in CONTRACTS.items() if c.expect_async_copy} == want
    for name in CONTRACTS:
        assert op_trace.async_copy_report(name).issues == (name in want)


def test_multi_trip_and_csr_cases_expect_no_host_read():
    # the counterpart of the reference's scalar prefetch: the dynamic trip
    # budget and the CSR windows stay on the device
    assert CONTRACTS["block_prune_csr"].expect_no_host_read
    assert CONTRACTS["chunk_step"].expect_no_host_read
    assert any("trips" in c.dims for c in CONTRACTS["chunk_step"].shape_grid)


def test_chip_smoke_edges_are_port_cases():
    """The edges chip_smoke.py sweeps: B = 63 and 64 at the engine widths,
    k_blk on both sides of SELECT_MAX_K, block_d 512."""
    from repro_torch.kernels.impact_scatter_topk import ops as fused_ops

    prune = dict(CONTRACTS["block_prune_csr"].cases(port=True))
    assert {prune[n]["batch"] for n in prune if "lq35_nb2159" in n} == {1, 63, 64}
    ks = CONTRACTS["impact_scatter_topk"].sweep_values("k", require=("empty",))
    assert min(ks) <= fused_ops.SELECT_MAX_K < max(k for k in ks if k < 512)
    assert dict(CONTRACTS["impact_scatter"].cases(port=True))["edge"]["block_d"] == 512
    assert dict(CONTRACTS["block_prune"].cases(port=True))["engine_b63"]["batch"] == 63


def _forced_launches(monkeypatch, name, dims):
    """The launches a contract's call makes with its launch branch taken on
    CPU tensors and ``common.launch`` stood in for: ``[(symbol, ints)]``."""
    launched = []

    def fake_launch(kernel, symbol, n_ptrs, args, device_index):
        assert kernel == name
        launched.append((symbol, tuple(args[n_ptrs:])))

    monkeypatch.setattr(common, "run_kernel", lambda n, ints, on, plain, launch: launch())
    monkeypatch.setattr(common, "launch", fake_launch)
    monkeypatch.setattr(common, "check_cuda_tensors", lambda *ts: None)
    monkeypatch.setattr(common, "sm_count", lambda index: common.H100_SMS)
    fn, args = CONTRACTS[name].make_call(dims, torch.device("cpu"))
    fn(*args)
    return launched


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_every_launch_takes_its_numbers_from_the_contract_plan(monkeypatch, name):
    contract = CONTRACTS[name]
    for case in contract.shape_grid:
        with monkeypatch.context() as m:
            got = _forced_launches(m, name, case.dims)
        want = [(p.symbol, p.ints) for p in contract.plan(case.dims, common.H100_SMS)]
        assert got == want, case.name


# --------------------------------------------------------------------------
# stand-in contracts: every plan pass catches
# --------------------------------------------------------------------------


def _standin_call(dims, device, read=False, kernel=True):
    x = torch.arange(8, dtype=torch.float32, device=device)

    def fn(x):
        if read:
            int(x.sum().item())
        if not kernel:
            return x * 2
        return common.run_kernel("standin", (8,), x, lambda: x * 2, lambda: x * 2)
    return fn, (x,)


def _plan(**kw):
    base = dict(kernel="standin", symbol="standin_launch", function="standin_kernel",
                ints=(8,), grid=(1, 1, 1), threads=32, cover=(("x", 8, 8),))
    base.update(kw)
    return common.LaunchPlan(**base)


def _contract(plan=None, name="seeded", **kw):
    return KernelContract(
        name=name, make_call=kw.pop("make_call", _standin_call),
        plan=lambda dims, n_sms: [plan if plan is not None else _plan()],
        shape_grid=kw.pop("shape_grid", (ShapeCase("case", dict(n=8)),)),
        source=kw.pop("source", "block_topk"), **kw)


def _checks(violations):
    return [v.check for v in violations]


def test_clean_stand_in_is_clean():
    assert check_contract(_contract()) == []


def test_smem_over_the_limit_by_one_byte_is_caught():
    limit = common.SMEM_LIMIT
    over = _plan(smem=(("tile", limit - 100),), static_smem=(("table", 101),))
    violations = check_contract(_contract(over))
    assert _checks(violations) == ["smem"]
    msg = str(violations[0])
    assert msg.startswith("[seeded / case / smem]") and "breakdown" in msg
    assert "tile" in msg and "table" in msg  # names every buffer
    at = _plan(smem=(("tile", limit - 100),), static_smem=(("table", 100),))
    assert check_contract(_contract(at)) == []


def test_smem_limit_is_never_above_the_cards():
    with pytest.raises(ValueError, match="exceeds"):
        _contract(smem_limit_bytes=common.SMEM_LIMIT + 1)
    tight = _contract(_plan(smem=(("tile", 4096),)), smem_limit_bytes=4095)
    assert _checks(check_contract(tight)) == ["smem"]


@pytest.mark.parametrize("threads,ok", [(1056, False), (1024, True), (48, False), (32, True)])
def test_threads_a_cta_are_checked(threads, ok):
    violations = check_contract(_contract(_plan(threads=threads)))
    assert (violations == []) == ok
    if not ok:
        assert str(violations[0]).startswith("[seeded / case / launch]")


def test_grid_y_past_the_limit_is_caught():
    big = _plan(grid=(1, 65_536, 1), cover=(("x", 8, 8), ("y", 65_536, 1)))
    violations = check_contract(_contract(big))
    assert _checks(violations) == ["launch"] and "grid.y" in str(violations[0])
    edge = _plan(grid=(1, 65_535, 1), cover=(("x", 8, 8), ("y", 65_535, 1)))
    assert check_contract(_contract(edge)) == []


def test_cluster_must_divide_grid_x():
    assert _checks(check_contract(_contract(_plan(grid=(6, 1, 1), cluster=4,
                                                   cover=(("x", 1, 1),))))) == ["launch"]
    assert check_contract(_contract(_plan(grid=(8, 1, 1), cluster=4,
                                          cover=(("x", 2, 1),)))) == []


def test_ragged_division_is_caught():
    # block_topk.cu and impact_scatter_topk.cu divide without rounding up
    ragged = _plan(exact=(("n / tile", 1000, 256),))
    violations = check_contract(_contract(ragged))
    assert _checks(violations) == ["launch"] and "pad" in str(violations[0])
    assert check_contract(_contract(_plan(exact=(("n / tile", 1024, 256),)))) == []


def test_cta_past_the_extent_is_caught():
    past = _plan(grid=(3, 1, 1), cover=(("x", 1000, 500),))
    violations = check_contract(_contract(past))
    assert _checks(violations) == ["coverage"] and "past" in str(violations[0])
    assert check_contract(_contract(_plan(grid=(2, 1, 1), cover=(("x", 1000, 500),)))) == []


def test_missed_tail_is_caught():
    short = _plan(grid=(1, 1, 1), cover=(("x", 1000, 500),))
    violations = check_contract(_contract(short))
    assert _checks(violations) == ["coverage"] and "tail" in str(violations[0])


def test_host_read_in_a_wrapper_is_caught():
    reading = _contract(make_call=functools.partial(_standin_call, read=True))
    violations = check_contract(reading)
    assert _checks(violations) == ["host_read"]
    assert "test_torch_contracts.py" in violations[0].message  # names the site
    assert str(violations[0]).startswith("[seeded / case / host_read]")


def test_no_host_read_expectation_per_case_override():
    mixed = _contract(
        make_call=functools.partial(_standin_call, read=True), expect_no_host_read=False,
        shape_grid=(ShapeCase("reads", dict(n=8)),
                    ShapeCase("must_not", dict(n=8), expect_no_host_read=True)))
    assert [(v.case, v.check) for v in check_contract(mixed)] == [("must_not", "host_read")]


def test_wrapper_that_reaches_no_kernel_is_caught():
    plain = _contract(make_call=functools.partial(_standin_call, kernel=False))
    violations = check_contract(plain)
    assert _checks(violations) == ["trace"] and "no kernel" in str(violations[0])


def test_failing_call_is_a_trace_violation():
    def broken(dims, device):
        raise ValueError("no such shape")
    assert _checks(check_contract(_contract(make_call=broken))) == ["trace"]


# --------------------------------------------------------------------------
# the source side of the copy check
# --------------------------------------------------------------------------

_COPY_HELPERS = r"""
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(0), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
"""


def _source(tmp_path, body, name="standin.cu"):
    path = tmp_path / name
    path.write_text('#include "helpers.cuh"\nnamespace {\n__global__ void k(float* o, const float* s) {\n'
                    + body + "\n}\n}  // namespace\n")
    (tmp_path / "helpers.cuh").write_text(_COPY_HELPERS)
    return path


def test_missing_async_copy_wait_is_caught(tmp_path):
    path = _source(tmp_path, "  __shared__ float b[32];\n  copy4(b, s);\n  commit();\n"
                             "  o[0] = b[0];")
    report = op_trace.async_copy_report(path)
    assert report.issues and report.kernels["k"]["commits"] and not report.kernels["k"]["waits"]
    assert any("wait" in v for v in report.violations)
    violations = check_contract(_contract(source=path, expect_async_copy=True))
    assert _checks(violations) == ["async_copy"]
    assert str(violations[0]).startswith("[seeded / source / async_copy]")


def test_disciplined_async_copy_is_clean(tmp_path):
    path = _source(tmp_path, "  __shared__ float b[32];\n  copy4(b, s);\n  commit();\n"
                             "  wait_copies<0>();\n  o[0] = b[0];")
    report = op_trace.async_copy_report(path)
    assert report.issues and report.violations == []
    assert check_contract(_contract(source=path, expect_async_copy=True)) == []


def test_copy_after_the_last_wait_is_caught(tmp_path):
    path = _source(tmp_path, "  __shared__ float b[32];\n  copy4(b, s);\n  commit();\n"
                             "  wait_copies<0>();\n  copy4(b, s + 1);\n  commit();")
    report = op_trace.async_copy_report(path)
    assert any("after its last wait" in v for v in report.violations)


def test_expect_async_copy_without_copies_is_caught(tmp_path):
    path = _source(tmp_path, "  o[0] = s[0];")
    violations = check_contract(_contract(source=path, expect_async_copy=True))
    assert _checks(violations) == ["async_copy"] and "no __global__" in str(violations[0])


def test_unexpected_async_copy_is_caught():
    violations = check_contract(_contract(source="impact_scatter", expect_async_copy=False))
    assert _checks(violations) == ["async_copy"]


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_python_plans_equal_the_c_plans(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels' C plans")
    contract = CONTRACTS[name]
    n_sms = common.sm_count(torch.cuda.current_device())
    for case in contract.shape_grid:
        for plan in contract.plan(case.dims, n_sms):
            assert c_launch_plan(plan) == python_launch_plan(plan), (case.name, plan.symbol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_checked_in_contract_passes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    violations = check_contract(CONTRACTS[name], device="cuda")
    assert violations == [], "\n".join(str(v) for v in violations)
