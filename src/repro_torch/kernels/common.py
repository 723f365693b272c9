"""Shared helpers for the scatter-family kernels, the kernel builder and
the launch path.

The builder compiles each ``csrc/<name>.cu`` with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/torch_kernels/``
at the repository root, the first time a kernel is used, and loads it with
``ctypes``. Nothing is built when a module is imported, and nothing is built
from outside the repository: with no ``nvcc`` or a failed build it raises.
Each library's name carries a hash of its sources, so an edited source is
rebuilt and a stale library is never loaded.

Every wrapper launches through :func:`launch`: each C launcher is bound
once (its argument types set, then cached), pointers go as plain ints from
``data_ptr()``, and the stream is the current stream's raw handle, read
without building a ``torch.cuda.Stream`` object, so a launch repeats no
binding work on the host.

Every wrapper picks its branch through :func:`run_kernel`: the plain
version for CPU tensors, the launch for any other. A launch's numbers come
from a :class:`LaunchPlan`, which each ``ops.py`` makes with the same
function for its launcher and for its ``CONTRACT``
(``repro_torch.analysis.kernel_contracts``), and which each source's
``<launcher stem>_plan`` export computes again in C.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# (library, bound launcher) by (kernel, symbol): see launcher()
_LAUNCHERS: dict[tuple[str, str], tuple[ctypes.CDLL, object]] = {}
# streaming multiprocessors by device index: see sm_count()
_SMS: dict[int, int] = {}

# Shared memory one block may use on the H100 (227 KB, opted in above 48 KB).
SMEM_LIMIT = 232_448
# Streaming multiprocessors of an H100 SXM: what a plan assumes where it is
# made for no card (on the CPU, for the contract checks).
H100_SMS = 132

# The op recorders of repro_torch.analysis.op_trace while they record,
# innermost last: run_kernel tells the innermost of each kernel call.
RECORDERS: list = []


class LaunchPlan(NamedTuple):
    """One launch of a kernel as its C launcher makes it.

    ``ints`` are the launcher's int arguments in order (the pointers and the
    stream aside); ``<symbol stem>_plan`` in the source takes the same ints
    and writes ``grid``, ``threads``, ``cluster`` and the dynamic shared
    memory. ``smem`` and ``static_smem`` name each buffer of the dynamic
    and the static shared memory with its bytes. ``cover``: ``(axis,
    extent, tile)``, each cluster along ``axis`` covering ``tile`` of
    ``extent`` (rows, slots, docs or blocks). ``exact``: ``(what, extent,
    divisor)`` for each division the launcher makes without rounding up.
    ``function`` is the ``__global__`` instance launched, as
    ``name<template args>``."""

    kernel: str
    symbol: str
    function: str
    ints: tuple
    grid: tuple
    threads: int
    cluster: int = 1
    smem: tuple = ()
    static_smem: tuple = ()
    cover: tuple = ()
    exact: tuple = ()

    @property
    def smem_bytes(self) -> int:
        """Dynamic and static shared memory of one CTA."""
        return sum(b for _, b in self.smem) + sum(b for _, b in self.static_smem)


def run_kernel(name: str, ints: tuple, on: torch.Tensor, plain, launch):
    """A wrapper's two branches: ``plain()`` where ``on`` lies on the CPU,
    else ``launch()`` (which launches the kernel or raises). An active
    recorder sees the call as one event ``kernel:<name>`` with ``ints``,
    the numbers the launch is planned from; with none active this costs
    one test."""
    if RECORDERS:
        return RECORDERS[-1].kernel_call(name, ints, on, plain, launch)
    return plain() if on.device.type == "cpu" else launch()


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_axis(x: torch.Tensor, axis: int, multiple: int, fill=0) -> torch.Tensor:
    """Pad one axis up to a multiple."""
    n = x.shape[axis]
    target = round_up(n, multiple)
    if target == n:
        return x
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def sorted_posting_tiles(
    doc_ids: torch.Tensor, contribs: torch.Tensor, n_docs_pad: int, tile_p: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared preprocessing for the scatter-family kernels: ``[..., P]`` in,
    ``(docs i32, contribs f32)`` of ``[..., P_pad]`` out, P_pad % tile_p == 0.

    Each row is stably sorted by doc (the counterpart of the reference's
    ``lax.sort``), so every doc's contributions sit together in their
    original order, and every consumer adds them in that one order.

    A slot whose contribution is 0 carries nothing (0 added to a sum of
    non-negative terms leaves it bit-for-bit unchanged), so its doc becomes
    the sentinel ``n_docs_pad`` before the sort, which sends it to the tail
    of the row with the tile padding. The kernels' per-block binary search
    never reaches the tail; the reference's tile ranges, which served the
    same skip, are not needed. Budget slots past a query's own postings are
    exactly such slots: without the sentinel they would all pile onto doc 0.
    """
    docs = doc_ids.to(torch.int32)
    c = contribs.to(torch.float32)
    docs = torch.where(c != 0, docs, n_docs_pad)
    docs, order = torch.sort(docs, dim=-1, stable=True)
    c = torch.gather(c, -1, order)
    axis = docs.ndim - 1
    docs = pad_axis(docs, axis, tile_p, fill=n_docs_pad)
    c = pad_axis(c, axis, tile_p, fill=0.0)
    return docs.contiguous(), c.contiguous()


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# The scatter kernels' CTA shape (csrc/scatter_common.cuh): each thread sums
# SCATTER_DOCS_PER_THREAD docs (fewer where the block would get under two
# warps), and a CTA stages STAGE_PER_DOC postings a doc of its block at once.
SCATTER_DOCS_PER_THREAD = 4
STAGE_PER_DOC = 2


def scatter_shape(block_d: int) -> dict:
    """The scatter kernels' launch shape for blocks of ``block_d`` docs:
    docs a thread (``dpt``: 1, 2 or 4), threads a CTA, postings a stage and
    the shared memory of the accumulation (``block_doc_sums``): 8 B a
    staged posting and a run start per doc, 4 B x ``block_d``."""
    dpt = SCATTER_DOCS_PER_THREAD
    while dpt > 1 and block_d // dpt < 64:
        dpt //= 2
    stage = STAGE_PER_DOC * block_d
    return dict(dpt=dpt, threads=block_d // dpt, stage=stage, smem=8 * stage + 4 * block_d)


def check_block_d(block_d: int) -> None:
    """A block is a power of two of docs in [64, 1024]: a scatter CTA holds
    one to four docs a thread and sorts the block's keys by a bitonic sort."""
    if block_d < 64 or block_d > 1024 or block_d & (block_d - 1):
        raise ValueError(f"block_d must be a power of two in [64, 1024], got {block_d}")


# ---------------------------------------------------------------------------
# kernel builder
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns each kernel's
    compiler output (ptxas register and shared-memory report)."""
    paths = {n: _lib_path(n) for n in (kernel_names() if names is None else names)}
    todo = {n: out for n, out in paths.items() if not out.is_file()}
    logs = {n: out.with_suffix(".log").read_text() for n, out in paths.items()
            if n not in todo and out.with_suffix(".log").is_file()}
    if not todo:
        return logs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check_cuda_tensors(*tensors: torch.Tensor) -> None:
    """A kernel takes contiguous CUDA tensors on one device."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def check_dtypes(**named: tuple[torch.Tensor, torch.dtype]) -> None:
    """Each named kernel input has the type its kernel reads."""
    for name, (t, dtype) in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def sm_count(index: int) -> int:
    """Streaming multiprocessors of the CUDA device ``index``, read once."""
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def stream_handle(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, as an int.

    It is the stream PyTorch launches on (the capturing stream while a CUDA
    graph is captured), read without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def launcher(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, bound once.

    Its argument types (``n_ptrs`` pointers, ``n_ints`` ints, then the
    stream) and its int result are set when it is first asked for, and the
    bound function is cached for as long as the same library stays loaded.
    ``c_void_p`` pointer types pass a pointer whole (64 bits), where an
    untyped argument would go as a 32-bit int."""
    lib = _LIBS.get(name)
    hit = _LAUNCHERS.get((name, symbol))
    if hit is not None and hit[0] is lib:
        return hit[1]
    lib = kernel_library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LAUNCHERS[(name, symbol)] = (lib, fn)
    return fn


def launch(name: str, symbol: str, n_ptrs: int, args: tuple, device_index: int) -> None:
    """Launch a kernel through its C launcher on the current stream of
    ``device_index``. ``args`` are the launcher's ``n_ptrs`` pointers (ints
    from ``data_ptr()``, or None for a null pointer) and then its ints.
    Raises if the launch failed."""
    fn = launcher(name, symbol, n_ptrs, len(args) - n_ptrs)
    code = fn(*args, stream_handle(device_index))
    if code != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: cudaError {code}")
