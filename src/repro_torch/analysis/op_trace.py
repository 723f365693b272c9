"""Op traces of eager PyTorch calls, and the source side of the copy check.

The port's counterpart of ``repro.analysis.jaxpr_walk``. Eager PyTorch has
no jaxpr: a trace here is the list of ops one call dispatches, recorded by
a ``TorchDispatchMode`` (:func:`record`). Each :class:`Op` holds the aten
op's name, its tensor inputs' and outputs' dtypes, shapes and devices, its
other arguments, and whether it reads a device value on the host:

  * ``item``: ``aten._local_scalar_dense`` (what ``.item()``, ``int(t)``
    and ``bool(t)`` call) and ``aten.equal``;
  * ``shape``: the ops whose output shape depends on data (``nonzero``,
    ``masked_select``, the ``unique`` ops, ``repeat_interleave`` without
    ``output_size``, indexing by a bool mask);
  * ``d2h`` / ``h2d``: a copy between a card and the host (a blocking copy
    waits for the card either way).

On a card only reads of device tensors count; in a run on the CPU, where
the card's tensors lie on the host, every read counts. A ``.tolist()`` or
``.numpy()`` of a CPU tensor dispatches no op, so the CPU run cannot see
it; on the card the CUDA sync debug mode counts every synchronizing call
too (``OpTrace.sync_warnings``), and the two counts are held equal.

A kernel wrapper's call is one event, ``kernel:<name>``, with the ints its
launch is planned from (``kernels/common.py: run_kernel``). The ops of its
plain version on the CPU, and of its launch on the card, are not recorded
one by one, as a ``pallas_call`` is one equation of a jaxpr: a trace reads
the same program on both devices.

:func:`async_copy_report` is the source side of the reference's DMA pass:
for each ``__global__`` function of ``csrc/<name>.cu`` (and the local
headers it includes), whether it issues ``cp.async`` and whether it
commits and waits after its last copy. It reads the text, not the control
flow: a read of a staged buffer before its wait on one branch is not
seen here (the reference's pass walks the kernel's jaxpr); on the card
every contract case is held to its plain version, where such a race shows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import sys
import warnings
from pathlib import Path
from typing import Any, Iterator, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# repro_torch.kernels is imported where it is used: its ops modules import
# this package for their contracts.

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_THIS = str(Path(__file__).resolve())
_SRC = Path(__file__).resolve().parents[2]

_ITEM_OPS = {"aten::_local_scalar_dense", "aten::equal"}
_SHAPE_OPS = {"aten::nonzero", "aten::masked_select", "aten::_unique", "aten::_unique2",
              "aten::unique_dim", "aten::unique_consecutive", "aten::unique_dim_consecutive"}
_COPY_OPS = {"aten::_to_copy", "aten::copy_"}
_WIDE = (torch.float64, torch.complex128)


class Op(NamedTuple):
    """One recorded op, or one kernel event (``name`` ``kernel:<name>``).

    ``inputs``/``outputs``: ``(dtype, shape, device type)`` of each tensor;
    ``args``: the other arguments, as text; ``ints``: a kernel event's
    launch ints; ``read``: the host-read kind, or None; ``site``: where a
    read was made (``path:line in function``)."""

    name: str
    inputs: tuple
    outputs: tuple
    args: str = ""
    ints: tuple = ()
    read: Optional[str] = None
    site: Optional[str] = None

    def line(self) -> str:
        """The op as one line of the trace's fingerprint (no site: the same
        program read from another source line is the same program)."""
        return f"{self.name}|{self.inputs}|{self.outputs}|{self.args}|{self.ints}|{self.read}"


@dataclasses.dataclass
class OpTrace:
    """What one call dispatched: ``ops`` in order, the call's tensor
    ``arg_types`` (``(dtype, shape, device type)`` each), its ``result``,
    and on a card the CUDA sync debug mode's count of synchronizing calls
    (``sync_warnings``; None off the card)."""

    ops: list
    arg_types: tuple
    result: Any = None
    sync_warnings: Optional[int] = None

    def reads(self) -> list:
        return [op for op in self.ops if op.read is not None]

    def text(self) -> str:
        return "\n".join(op.line() for op in self.ops)


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _types(x) -> tuple:
    return tuple((str(t.dtype).removeprefix("torch."), tuple(t.shape), t.device.type)
                 for t in _tensors(x))


def _arg_text(x) -> str:
    if isinstance(x, torch.Tensor):
        return "T"
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_arg_text(y) for y in x) + "]"
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    if isinstance(x, (torch.dtype, torch.device, torch.layout, torch.memory_format)):
        return str(x)
    return type(x).__name__


@functools.lru_cache(maxsize=None)
def _shown_path(filename: str) -> Optional[str]:
    """A frame's file as a site shows it (relative to ``src`` where it lies
    there), or None for a file of torch or of this module."""
    path = str(Path(filename).resolve())
    if path.startswith(_TORCH_DIR) or path == _THIS:
        return None
    try:
        return str(Path(path).relative_to(_SRC))
    except ValueError:
        return path


def _site() -> str:
    """The first frame outside torch and this module: where a read was made."""
    f = sys._getframe(2)
    while f is not None:
        shown = _shown_path(f.f_code.co_filename)
        if shown is not None:
            return f"{shown}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "?"


def _read_kind(name: str, args, kwargs, device_type: str) -> Optional[str]:
    """The host-read kind of one op (``name`` without its overload) in a
    run on ``device_type``, or None."""
    tensors = list(_tensors(args)) + list(_tensors(kwargs))
    on_run = any(t.device.type == device_type for t in tensors)
    if name in _ITEM_OPS:
        return "item" if on_run else None
    if name in _SHAPE_OPS:
        return "shape" if on_run else None
    if name == "aten::repeat_interleave":  # the repeats a tensor, no output_size
        return "shape" if on_run and kwargs.get("output_size") is None and len(args) < 3 else None
    if name in ("aten::index", "aten::index_put", "aten::index_put_"):
        idx = args[1] if len(args) > 1 else ()
        masks = [t for t in _tensors(idx) if t.dtype in (torch.bool, torch.uint8)]
        if not masks or not on_run:
            return None
        if name != "aten::index" and len(list(_tensors(idx))) == 1 and len(args) > 2 \
                and isinstance(args[2], torch.Tensor) and args[2].dim() == 0:
            return None  # a single mask and a scalar value: a masked fill, no read
        return "shape"
    if name in _COPY_OPS and device_type != "cpu":
        src = args[1] if name == "aten::copy_" else args[0]
        dst_dev = args[0].device.type if name == "aten::copy_" else kwargs.get("device")
        dst = torch.device(dst_dev).type if dst_dev is not None else src.device.type
        if src.device.type != "cpu" and dst == "cpu":
            return "d2h"
        if src.device.type == "cpu" and dst != "cpu":
            return "h2d"
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.ops: list = []
        self.hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden:
            read = _read_kind(func._schema.name, args, kwargs, self.device_type)
            self.ops.append(Op(
                name=str(func), inputs=_types((args, kwargs)), outputs=_types(out),
                args=_arg_text([a for a in args if not isinstance(a, torch.Tensor)])
                + _arg_text(sorted(kwargs.items())),
                read=read, site=_site() if read else None,
            ))
        return out

    def kernel_call(self, name, ints, on, plain, launch):
        """One kernel event; the branch's own ops are not recorded."""
        self.hidden += 1
        try:
            out = plain() if on.device.type == "cpu" else launch()
        finally:
            self.hidden -= 1
        self.ops.append(Op(name=f"kernel:{name}", inputs=(), outputs=_types(out),
                           ints=tuple(int(i) for i in ints)))
        return out


# What the CUDA sync debug mode says of each synchronizing call.
_SYNC_WARNING = "called a synchronizing CUDA operation"


def is_sync_error(e: BaseException) -> bool:
    """Whether ``e`` is the CUDA sync debug mode's error."""
    return isinstance(e, RuntimeError) and _SYNC_WARNING in str(e)


def record(fn, *args, sync_debug: Optional[str] = None, **kwargs) -> OpTrace:
    """Call ``fn(*args, **kwargs)`` once and record the ops it dispatches.

    The run is on the card when a tensor argument lies on one. There the
    CUDA sync debug mode runs too: ``sync_debug="error"`` makes any
    synchronizing call raise; otherwise it warns, and the warnings are
    counted into ``sync_warnings``."""
    from repro_torch.kernels import common

    arg_types = _types((args, kwargs))
    cuda = any(t.is_cuda for t in _tensors((args, kwargs)))
    rec = _Recorder("cuda" if cuda else "cpu")
    caught = None
    common.RECORDERS.append(rec)
    old_mode = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        with contextlib.ExitStack() as stack:
            if cuda:
                torch.cuda.synchronize()
                if sync_debug == "error":
                    torch.cuda.set_sync_debug_mode("error")
                else:
                    caught = stack.enter_context(warnings.catch_warnings(record=True))
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
            with rec:
                result = fn(*args, **kwargs)
    finally:
        common.RECORDERS.remove(rec)
        if cuda:
            torch.cuda.set_sync_debug_mode(old_mode)
    if cuda:
        torch.cuda.synchronize()
    syncs = None
    if caught is not None:
        syncs = sum(1 for w in caught if _SYNC_WARNING in str(w.message))
    return OpTrace(rec.ops, arg_types, result, syncs)


def iter_ops(trace: OpTrace) -> Iterator[Op]:
    """Every op and kernel event of a trace, in order."""
    yield from trace.ops


def find_kernel_calls(trace: OpTrace, name: Optional[str] = None) -> list:
    """The kernel events of a trace (of one kernel when ``name`` is given)."""
    return [op for op in trace.ops if op.name.startswith("kernel:")
            and (name is None or op.name == f"kernel:{name}")]


# --------------------------------------------------------------------------
# the source side of the copy check
# --------------------------------------------------------------------------

_ISSUE = re.compile(r"cp\.async\.(?:ca|cg|bulk)\b")
_COMMIT = re.compile(r"cp\.async\.(?:commit_group|wait_all)\b")
_WAIT = re.compile(r"cp\.async\.(?:wait_group|wait_all)\b")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


@dataclasses.dataclass
class AsyncCopyReport:
    """Per ``__global__`` function of a source: ``issues`` (it issues
    ``cp.async``, itself or through a function it calls), ``commits`` and
    ``waits``; and the violations: a function that issues copies but does
    not commit, or does not wait after its last copy."""

    source: str
    kernels: dict
    violations: list

    @property
    def issues(self) -> bool:
        return any(k["issues"] for k in self.kernels.values())

    @property
    def issuing(self) -> set:
        return {n for n, k in self.kernels.items() if k["issues"]}


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: " " * len(m.group()), text, flags=re.S)
    return re.sub(r"//[^\n]*", lambda m: " " * len(m.group()), text)


def _source_text(path: Path, seen: set) -> str:
    """The source and, in front of it, the local headers it includes."""
    if path in seen:
        return ""
    seen.add(path)
    text = path.read_text()
    heads = "".join(_source_text(path.parent / inc, seen) for inc in _INCLUDE.findall(text)
                    if (path.parent / inc).is_file())
    return heads + "\n" + text


def _functions(text: str) -> dict:
    """``{name: (is_global, body)}`` of the functions defined outside any
    other function (namespaces are looked through)."""
    out = {}
    stack = []  # kinds of the open braces: "ns", "fn" or "block"
    start = 0  # where the current declaration began
    body_at = None
    name = glob = None
    for i, ch in enumerate(text):
        if ch in ";}" and all(k == "ns" for k in stack):
            if ch == "}" and stack:
                stack.pop()
            start = i + 1
            continue
        if ch == "{":
            head = text[start:i]
            if all(k == "ns" for k in stack):
                if re.search(r"\bnamespace\b[\w\s]*$", head):
                    stack.append("ns")
                    start = i + 1
                    continue
                m = re.search(r"(\w+)\s*(?:<[^<>]*>)?\s*\([^()]*(?:\([^()]*\)[^()]*)*\)\s*"
                              r"(?:const\s*)?$", head)
                if m and "(" in head:
                    name, glob, body_at = m.group(1), "__global__" in head, i
                    stack.append("fn")
                    continue
                stack.append("block")
                continue
            stack.append("block")
        elif ch == "}" and stack:
            kind = stack.pop()
            if kind == "fn" and all(k == "ns" for k in stack):
                out[name] = (glob, text[body_at + 1:i])
                start = i + 1
    return out


def async_copy_report(source: str | Path) -> AsyncCopyReport:
    """The copy discipline of a CUDA source: ``source`` is a ``csrc`` stem
    (``"impact_scatter"``) or a path to a ``.cu`` file."""
    from repro_torch.kernels import common

    path = Path(source) if isinstance(source, Path) or str(source).endswith(".cu") \
        else common.CSRC / f"{source}.cu"
    fns = _functions(_strip_comments(_source_text(path.resolve(), set())))
    calls = {n: {m for m in fns if m != n and re.search(rf"\b{m}\s*(?:<[^;()]*>)?\s*\(", body)}
             for n, (_, body) in fns.items()}

    def closure(pattern) -> set:
        have = {n for n, (_, body) in fns.items() if pattern.search(body)}
        while True:
            more = {n for n in fns if n not in have and calls[n] & have}
            if not more:
                return have
            have |= more

    issues, commits, waits = closure(_ISSUE), closure(_COMMIT), closure(_WAIT)

    def last(body, names, pattern) -> int:
        """Where in ``body`` the last event of a kind is (direct or a call)."""
        at = [m.start() for m in pattern.finditer(body)]
        for n in names:
            at += [m.start() for m in re.finditer(rf"\b{n}\s*(?:<[^;()]*>)?\s*\(", body)]
        return max(at, default=-1)

    kernels, violations = {}, []
    for n, (glob, body) in fns.items():
        if not glob:
            continue
        k = dict(issues=n in issues, commits=n in commits, waits=n in waits)
        kernels[n] = k
        if not k["issues"]:
            continue
        if not k["commits"] or not k["waits"]:
            violations.append(
                f"{n} issues cp.async but never "
                + ("commits a group or " if not k["commits"] else "")
                + "waits for it (cp.async.wait_group / wait_all): its shared memory may be read "
                "before the copy lands")
        elif last(body, waits, _WAIT) < last(body, issues, _ISSUE):
            violations.append(
                f"{n}'s last cp.async comes after its last wait: a copy may still be in flight "
                "when the kernel returns")
    return AsyncCopyReport(path.name, kernels, violations)
