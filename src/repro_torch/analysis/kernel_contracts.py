"""KernelContract: checked invariants of the port's CUDA kernel packages.

The port of ``repro.analysis.kernel_contracts``. Every
``repro_torch/kernels/*/ops.py`` exports a ``CONTRACT``: the shapes the
kernel is held to (the reference contract's cases, same names and dims,
and the port's own edges that ``chip_smoke.py`` sweeps), the launch each
shape makes (``plan``: the :class:`~repro_torch.kernels.common.LaunchPlan`
the launcher itself takes its numbers from) and what its source is
expected to do. :func:`check_contract` runs, at every case:

  1. **smem**: the plan's declared static and dynamic shared memory of a
     CTA is within ``smem_limit_bytes``; a failure lists every buffer.
  2. **launch**: threads a multiple of 32 in [32, 1024]; ``grid.x`` at most
     2^31 - 1, ``grid.y``/``grid.z`` at most 65,535; a cluster of at most 8
     CTAs that divides ``grid.x``; every extent the C launcher divides
     without rounding up is a multiple of its divisor.
  3. **coverage**: along each grid axis the tiles cover the extent, and no
     cluster starts at or past it.
  4. **async_copy** (once, on the source): ``expect_async_copy`` holds
     exactly when the kernel's source issues ``cp.async``, and every
     ``__global__`` function that issues one commits and waits after its
     last copy (:func:`repro_torch.analysis.op_trace.async_copy_report`).
  5. **host_read**: at a case with ``expect_no_host_read`` the wrapper's
     host code (outside the kernel's event) reads no device value. This is
     the counterpart of the reference's scalar prefetch: the dynamic trip
     budget (``chunk_step_multi``'s ``trips_left``) and the CSR windows
     stay on the device.
  6. **trace**: ``make_call`` raises, or the call reaches no kernel.

Passes 1 to 3 read the plan, pass 5 and 6 a recorded call of the wrapper
(:func:`repro_torch.analysis.op_trace.record`) on the CPU, where the
kernel's plain version runs in its place, or on the card. On the card
``chip_smoke.py`` adds what only the card can tell: static shared memory
and registers from the build's ptxas report, ``LDGSTS`` in the built SASS,
and each Python plan held equal to the source's C plan
(:func:`c_launch_plan`).

The shape grid is the one source of the shapes: ``chip_smoke.py``'s kernel
phases read ``CONTRACT.cases()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import op_trace

# repro_torch.kernels is imported where it is used: its ops modules import
# this module for their contracts.

MAX_THREADS = 1024
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65_535
MAX_CLUSTER = 8  # the portable cluster size
# 32-bit registers of one SM, shared by the threads of a CTA on it
REGISTERS_PER_SM = 65_536


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    """One named point of a contract's shape grid.

    ``dims`` holds the op-level shape parameters (the reference contract's
    names). ``expect_no_host_read`` overrides the contract's for this case
    (``None``: inherit). ``port`` marks a case of the port's own (an edge
    ``chip_smoke.py`` sweeps), not the reference's.
    """

    name: str
    dims: Mapping[str, int]
    expect_no_host_read: Optional[bool] = None
    port: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dims", dict(self.dims))


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared invariants of one kernel package (exported as ``CONTRACT``).

    ``make_call(dims, device)`` returns ``(fn, args)`` such that
    ``fn(*args)`` calls the package's wrapper at that shape on inputs made
    from a seed on ``device``. ``plan(dims, n_sms)`` returns the launches
    that call makes, one :class:`LaunchPlan` each. ``source``: the CUDA
    source the async-copy pass reads, a ``csrc`` stem (default ``name``) or
    a path.
    """

    name: str
    make_call: Callable
    plan: Callable
    shape_grid: Tuple[ShapeCase, ...]
    smem_limit_bytes: Optional[int] = None  # None: common.SMEM_LIMIT
    expect_async_copy: bool = False
    expect_no_host_read: bool = True
    description: str = ""
    source: Optional[str | Path] = None

    def __post_init__(self):
        from repro_torch.kernels import common

        if self.smem_limit_bytes is None:
            object.__setattr__(self, "smem_limit_bytes", common.SMEM_LIMIT)
        if self.smem_limit_bytes > common.SMEM_LIMIT:
            raise ValueError(
                f"contract {self.name!r}: smem_limit_bytes={self.smem_limit_bytes} exceeds "
                f"the H100's {common.SMEM_LIMIT} B a block"
            )
        names = [c.name for c in self.shape_grid]
        if len(set(names)) != len(names):
            raise ValueError(f"contract {self.name!r}: duplicate case names {names}")

    def sweep(
        self, *dim_names: str, require: Sequence[str] = (), exclude: Sequence[str] = ()
    ) -> list[tuple]:
        """Shape tuples for test parametrization: one row per grid case that
        defines every requested dim (single dims flatten to scalars).

        ``require``/``exclude`` filter cases by the presence of OTHER dims —
        e.g. ``exclude=("batch",)`` selects the single-query cases.
        """
        rows = []
        for case in self.shape_grid:
            if any(n in case.dims for n in exclude):
                continue
            if not all(n in case.dims for n in require):
                continue
            if all(n in case.dims for n in dim_names):
                row = tuple(case.dims[n] for n in dim_names)
                rows.append(row[0] if len(dim_names) == 1 else row)
        return rows

    def sweep_values(
        self, dim_name: str, require: Sequence[str] = (), exclude: Sequence[str] = ()
    ) -> list[int]:
        """Deduplicated, order-preserving values of one dim across the grid."""
        return list(dict.fromkeys(self.sweep(dim_name, require=require, exclude=exclude)))

    def cases(self, port: Optional[bool] = None) -> list[tuple[str, dict]]:
        """``(name, dims)`` of the grid's cases: the reference's
        (``port=False``), the port's own (``True``) or all (``None``)."""
        return [(c.name, c.dims) for c in self.shape_grid if port is None or c.port == port]


@dataclasses.dataclass(frozen=True)
class Violation:
    contract: str
    case: str
    # "smem" | "launch" | "coverage" | "async_copy" | "host_read" | "trace"
    # (and the hot-path checks: "host_sync" | "dtype" | "dense_blockmax" |
    # "repeat" | "executable_key")
    check: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract} / {self.case} / {self.check}] {self.message}"


# --------------------------------------------------------------------------
# the passes over a plan
# --------------------------------------------------------------------------


def smem_breakdown(plan) -> str:
    rows = [(label, b, "dynamic") for label, b in plan.smem]
    rows += [(label, b, "static") for label, b in plan.static_smem]
    return "\n".join(f"    {label:<36} {b:>10,} B  {kind}" for label, b, kind in rows)


def _check_smem(contract, case, plan) -> list[Violation]:
    total = plan.smem_bytes
    if total <= contract.smem_limit_bytes:
        return []
    return [Violation(
        contract.name, case.name, "smem",
        f"{plan.function}: {total:,} B of shared memory a CTA exceeds the contract limit "
        f"{contract.smem_limit_bytes:,} B; breakdown:\n{smem_breakdown(plan)}",
    )]


def _check_launch(contract, case, plan) -> list[Violation]:
    out = []

    def bad(msg):
        out.append(Violation(contract.name, case.name, "launch", f"{plan.function}: {msg}"))

    gx, gy, gz = plan.grid
    t = plan.threads
    if t < 32 or t > MAX_THREADS or t % 32:
        bad(f"{t} threads a CTA: a CTA takes a multiple of 32 in [32, {MAX_THREADS}]")
    if not 1 <= gx <= MAX_GRID_X:
        bad(f"grid.x = {gx} is outside [1, {MAX_GRID_X}]")
    for axis, g in (("y", gy), ("z", gz)):
        if not 1 <= g <= MAX_GRID_YZ:
            bad(f"grid.{axis} = {g} is outside [1, {MAX_GRID_YZ}] (the batch sits on grid.y: "
                f"split it)")
    c = plan.cluster
    if not 1 <= c <= MAX_CLUSTER or gx % c:
        bad(f"a cluster of {c} CTAs: it takes 1 to {MAX_CLUSTER} CTAs and must divide "
            f"grid.x = {gx}")
    for what, n, d in plan.exact:
        if d <= 0 or n % d:
            bad(f"{what}: {n} is not a multiple of {d}, and the launcher divides without "
                "rounding up; the wrapper must pad")
    return out


def _check_coverage(contract, case, plan) -> list[Violation]:
    out = []
    for axis, extent, tile in plan.cover:
        units = plan.grid["xyz".index(axis)] // (plan.cluster if axis == "x" else 1)
        if tile <= 0 or units * tile < extent:
            out.append(Violation(
                contract.name, case.name, "coverage",
                f"{plan.function}: {units} CTAs (clusters) of {tile} along {axis} cover "
                f"{units * max(tile, 0)} of its extent {extent}: the tail is never computed"))
        elif (units - 1) * tile >= max(extent, 1):
            out.append(Violation(
                contract.name, case.name, "coverage",
                f"{plan.function}: the last of {units} CTAs (clusters) along {axis} starts at "
                f"{(units - 1) * tile}, at or past its extent {extent}"))
    return out


def _check_async_copy(contract) -> list[Violation]:
    source = contract.source if contract.source is not None else contract.name
    try:
        report = op_trace.async_copy_report(source)
    except OSError as e:
        return [Violation(contract.name, "source", "async_copy", f"cannot read the source: {e}")]
    out = [Violation(contract.name, "source", "async_copy", msg) for msg in report.violations]
    if contract.expect_async_copy and not report.issues:
        out.append(Violation(
            contract.name, "source", "async_copy",
            f"the contract expects asynchronous copies, but no __global__ function of "
            f"{report.source} issues cp.async: the operands are read straight from device "
            "memory"))
    if not contract.expect_async_copy and report.issues:
        out.append(Violation(
            contract.name, "source", "async_copy",
            f"{report.source} issues cp.async in {sorted(report.issuing)}, which the contract "
            "does not expect: declare expect_async_copy=True"))
    return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def check_contract(
    contract: KernelContract,
    case_names: Optional[Sequence[str]] = None,
    device: str | torch.device = "cpu",
) -> list[Violation]:
    """Check one contract over its shape grid. Returns the violations.

    On ``device="cuda"`` each case's call launches the kernel, a case that
    expects no host read runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, and the plans are made for the card's SM count."""
    from repro_torch.kernels import common

    dev = torch.device(device)
    n_sms = common.sm_count(dev.index or 0) if dev.type == "cuda" else common.H100_SMS
    out = _check_async_copy(contract)
    for case in contract.shape_grid:
        if case_names is not None and case.name not in case_names:
            continue
        try:
            plans = list(contract.plan(case.dims, n_sms))
        except Exception as e:  # noqa: BLE001 - a plan that fails is the finding
            out.append(Violation(contract.name, case.name, "trace",
                                 f"plan failed at dims {case.dims}: {type(e).__name__}: {e}"))
            plans = []
        for plan in plans:
            out += _check_smem(contract, case, plan)
            out += _check_launch(contract, case, plan)
            out += _check_coverage(contract, case, plan)
        no_read = case.expect_no_host_read
        if no_read is None:
            no_read = contract.expect_no_host_read
        try:
            fn, args = contract.make_call(case.dims, dev)
            trace = op_trace.record(fn, *args, sync_debug="error" if no_read else None)
        except Exception as e:  # noqa: BLE001 - a call that fails is the finding
            check = "host_read" if no_read and op_trace.is_sync_error(e) else "trace"
            out.append(Violation(contract.name, case.name, check,
                                 f"the call failed at dims {case.dims}: {type(e).__name__}: {e}"))
            continue
        if not op_trace.find_kernel_calls(trace):
            out.append(Violation(
                contract.name, case.name, "trace",
                "the call reached no kernel: the kernel path is not exercised at these dims"))
        if no_read:
            for op in trace.reads():
                out.append(Violation(
                    contract.name, case.name, "host_read",
                    f"the wrapper reads a device value on the host ({op.name}, {op.read}, at "
                    f"{op.site}); the launch must take its numbers from the host, and its "
                    "dynamic data stay on the device"))
    return out


def c_launch_plan(plan) -> tuple:
    """``(grid, threads, cluster, dynamic smem)`` as the source's C
    ``<launcher stem>_plan`` computes them for ``plan.ints``: the helper
    the launcher itself calls. Builds the kernel's library if needed (on a
    machine with ``nvcc``)."""
    from repro_torch.kernels import common

    lib = common.kernel_library(plan.kernel)
    fn = getattr(lib, plan.symbol.replace("_launch", "_plan"))
    fn.argtypes = [ctypes.c_int] * len(plan.ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    code = fn(*plan.ints, ctypes.cast(out, ctypes.c_void_p))
    if code != 0:
        raise ValueError(f"{plan.symbol}'s plan refused {plan.ints}: cudaError {code}")
    return (tuple(out[:3]), out[3], out[4], out[5])


def python_launch_plan(plan) -> tuple:
    """The same four numbers from the Python plan."""
    return (tuple(plan.grid), plan.threads, plan.cluster, sum(b for _, b in plan.smem))


KERNEL_PACKAGES = ("block_prune", "block_prune_csr", "block_topk", "chunk_step",
                   "impact_scatter", "impact_scatter_topk", "sparse_score")


def all_contracts() -> dict[str, KernelContract]:
    """Import every kernel package's CONTRACT (the checked-in registry)."""
    import importlib

    out: dict[str, KernelContract] = {}
    for pkg in KERNEL_PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        contract = getattr(mod, "CONTRACT", None)
        if contract is None:
            raise AttributeError(
                f"{mod.__name__} exports no CONTRACT: every kernel package must declare one "
                "(see src/repro_torch/README.md)"
            )
        out[contract.name] = contract
    return out
