"""Core: the paper's k-priority scheduling data structures (single-instance
and batched phase plane) and the SSSP application, in PyTorch."""
from repro_torch.core.kpriority import (  # noqa: F401
    Policy,
    PoolState,
    PopResult,
    common_visibility,
    ignored_count,
    init_pool,
    phase_pop,
    publish,
    push,
    push_batch,
    rho_bound,
    visibility,
)
from repro_torch.core import batched  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    SSSPBatchRun,
    SSSPRun,
    run_sssp,
    run_sssp_batched,
)
from repro_torch.core.random import GeneratorDraws, PhaseDraws  # noqa: F401
