"""Static analysis of the port's kernels and serving paths.

The port of ``repro.analysis``. Two passes, one CLI
(``python -m repro_torch.analysis.check``):

  * :mod:`repro_torch.analysis.kernel_contracts`: every kernel package's
    ``KernelContract``, checked at its shape grid: shared memory, launch
    limits and coverage from the launch plan the launcher takes its
    numbers from, the source's ``cp.async`` discipline, and no host read
    in the wrapper;
  * :mod:`repro_torch.analysis.hot_path`: the serving dispatches behind
    ``AnytimeServer`` and the sharded/pod steps, each recorded
    (:mod:`repro_torch.analysis.op_trace`) and held to its route's
    host-read budget, its dtypes, and one program per executable key.

The reference works on jaxprs, with no device. Eager PyTorch has none: the
passes record real calls, on the CPU (where each kernel's plain version
runs, and the kernel call is one opaque event) or on the card, where
``chip_smoke.py`` adds the ptxas report, the built SASS and the C launch
plans.
"""
from repro_torch.analysis.hot_path import (  # noqa: F401
    check_dtype_discipline,
    check_host_sync,
    lint_server,
    lint_sharded_serve,
    lint_trace,
)
from repro_torch.analysis.kernel_contracts import (  # noqa: F401
    KernelContract,
    ShapeCase,
    Violation,
    all_contracts,
    check_contract,
)
