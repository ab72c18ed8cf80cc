"""Static analysis of the port's device discipline.

The counterpart of the JAX package's jit-discipline analyzer
(``repro.analysis``), for eager torch on a CUDA card:

  * `registry`   — the unified kernel registry: the single `LAUNCH_COUNTS`
    counter every hand-kernel wrapper bumps where it launches, per-counter
    ownership, and representative-shape builders (on a given device) for
    the graph layer;
  * `graph_lint` — runs every registered kernel once under a
    ``TorchDispatchMode`` and checks the aten ops it dispatched for dtype
    drift off float64, host syncs, tensors escaping the operands' device
    and hand kernels that fell back to their plain versions;
  * `ast_lint`   — walks source ASTs for the port's bug classes
    (unannotated host syncs in kernel modules, truthiness on
    ``__len__``-bearing tables, launches that skip the launch counter,
    host syncs in ``torch.compile`` bodies);
  * `lint`       — the CLI (``python -m repro_torch.analysis.lint``) with
    a checked-in baseline for grandfathered findings; it exits non-zero on
    any new finding.
"""

from .registry import (  # noqa: F401 - re-exported API
    LAUNCH_COUNTS,
    count_launch,
    kernel_specs,
    launch_counts,
    register_counter,
    register_kernel,
)
