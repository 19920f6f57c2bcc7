"""Core: communication-region profiling on PyTorch.

Public API (every module of the JAX package's core except ``hlo_cost``):
  compat                     — SPMD shim: named mesh axes, trace-only
                               shard_map over meta tensors, axis_index /
                               axis_size
  comm_region(name)          — mark a communication region (Caliper analog)
  recording()                — install a profiling recorder for a trace
  profile_traced(fn, *args)  — trace fn on meta tensors and return its
                               CommProfile
  collectives                — instrumented collectives (recording on meta
                               tensors)
  scan_hlo_collectives       — compiled-HLO communication extraction into a
                               columnar HloCollectiveBuffer
  Frame                      — Thicket-style analysis (traced + hlo +
                               network rows)
  NetworkModeledProfiler     — modeled fabric costs per region (ring /
                               fat-tree / dragonfly), peer heatmaps
  reports                    — the paper's tables and figures as markdown
  StreamingProfiler / ProfileSummary / merge_tree — incremental
                               profiling into mergeable shards
                               (CommPatternProfiler.incremental)
  resolve_backend / use_backend — reduction-backend selection (numpy |
                               torch; default torch on the CUDA card,
                               byte-identical profiles across backends)
  FaultPlan / install_plan / maybe_fault — deterministic seeded fault
                               injection (REPRO_FAULT_SPEC)
"""

from repro_torch.core import compat  # noqa: F401
from repro_torch.core.backend import (  # noqa: F401
    BackendUnavailable,
    NumpyBackend,
    ReduceBackend,
    TorchBackend,
    available_backends,
    resolve_backend,
    use_backend,
)
from repro_torch.core.faultinject import (  # noqa: F401
    FAULT_SEED_ENV,
    FAULT_SPEC_ENV,
    FaultPlan,
    FaultRule,
    InjectedFault,
    fault_context,
    install_plan,
    maybe_fault,
)
from repro_torch.core.regions import (  # noqa: F401
    COMM_REGION_SCOPE_PREFIX,
    comm_region,
    current_region,
    recording,
)
from repro_torch.core.profiler import (  # noqa: F401
    CommPatternProfiler,
    CommProfile,
    HloCollectiveProfiler,
    RegionStats,
    profile_traced,
    trace_observer,
)
from repro_torch.core.hlo import (  # noqa: F401
    CollectiveOp,
    CollectiveSummary,
    HloCollectiveBuffer,
    parse_hlo_collectives,
    parse_hlo_collectives_with_loops,
    scan_hlo_collectives,
    summarize_collectives,
)
from repro_torch.core import collectives  # noqa: F401
from repro_torch.core.thicket import Frame, add_rate_metrics  # noqa: F401
from repro_torch.core.network import (  # noqa: F401
    DRAGONFLY,
    FABRICS,
    FAT_TREE,
    RING,
    FabricModel,
    NetworkModeledProfiler,
    ascii_heatmap,
    heatmap_csv,
    peer_heatmap,
    resolve_fabric,
)
from repro_torch.core import reports  # noqa: F401
from repro_torch.core.streaming import (  # noqa: F401
    ProfileSummary,
    RegionSummary,
    StreamingProfiler,
    merge_tree,
)
