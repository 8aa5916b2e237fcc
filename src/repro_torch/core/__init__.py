"""Core of the port: the split-latency model, solvers, planner, the DP on
the card, and runtime replanning.

The port's counterpart of ``repro.core``; it re-exports the same names
wherever the port has them:
  latency      — Eq. 4-8 cost model (LinkProfile / DeviceProfile / SplitCostModel)
  spec         — the planner tier: PlanSpec (one serializable planning
                 request; exact JSON round-trip, the reference's schema),
                 PlannerService (spec -> batched engines on a device;
                 every kwarg entry point routes through it),
                 build_surfaces_from_spec (process-pool rebuild worker)
  solvers      — beam / greedy / first_fit / random_fit / brute_force / optimal_dp
  planner      — plan_split, compare_solvers, plan_split_batch,
                 plan_pipeline (LM stages on H100s; stage_cost_profile)
  sweep        — batched solvers over stacked C[k,a,b] cost tensors +
                 ScenarioGrid fleet sweeps
  cuda_dp      — the dense and fused split-DP kernels on the card
                 (backend="cuda"; the counterpart of the reference's
                 pallas_dp)
  shard        — the scenario axis sharded over cards, simulated CPU
                 shards or the ranks of a torch.distributed group
                 (backend="sharded")
  surface      — precomputed degradation surfaces for O(1) replanning
  async_replan — stale-while-revalidate surface rebuilds
  adaptive     — LinkEstimator + AdaptiveSplitManager runtime replanning;
                 fleet_managers for mixed-fleet-size deployments
  executor     — run_split / run_unsplit segment execution with the
                 int8 wire simulated at every hop
  profiles     — paper-calibrated ESP32 + protocol tables; H100 stage
                 hardware and the NVLink / InfiniBand links
  quantization — int8 PTQ + activation wire format

The reference's ``tpu_cost_profile`` is ``stage_cost_profile`` here. As in the
reference, only names are re-exported here: ``repro_torch.core.sweep``,
``.surface``, ``.async_replan`` and ``.adaptive`` stay the submodules
(get the function with ``from repro_torch.core.sweep import sweep``).
"""

from repro_torch.core.latency import (  # noqa: F401
    COST_CHANNELS,
    BottleneckVariant,
    ContentionModel,
    DeviceProfile,
    LayerCost,
    LinkProfile,
    ModelCostProfile,
    RTTBreakdown,
    SplitCostModel,
    bottleneck_variant,
    bottleneck_variants,
    rtt_breakdown,
)
# NOTE: `spec` sits below every layer it orchestrates (it imports only
# latency at module scope; the engines load lazily inside
# PlannerService), so it comes right after latency here.
from repro_torch.core.spec import (  # noqa: F401
    MeshSpec,
    PlanSpec,
    PlannerService,
    ScenarioRef,
    SurfaceAxes,
    build_surfaces_from_spec,
)
from repro_torch.core.planner import (  # noqa: F401
    SegmentPlan,
    SplitPlan,
    compare_solvers,
    plan_pipeline,
    plan_split,
    plan_split_batch,
    plan_surface,
    stage_cost_profile,
    uniform_split,
)
# NOTE: `surface` must keep resolving to the submodule — only names are
# re-exported here, never a shadowing function.
from repro_torch.core.surface import (  # noqa: F401
    DegradationSurface,
    ProtocolSurface,
    SurfaceLookup,
    SwitchPoint,
    build_surface,
    build_surfaces,
    refit_link,
)
# NOTE: the sweep() entry point itself is deliberately NOT re-exported —
# `repro_torch.core.sweep` must keep resolving to the submodule.
from repro_torch.core.sweep import (  # noqa: F401
    DP_BACKENDS,
    BatchedSolverResult,
    ParetoFrontier,
    Scenario,
    ScenarioGrid,
    SweepResult,
    SweepRow,
    batched_beam_search,
    batched_beam_search_all_k,
    batched_greedy_search,
    batched_greedy_search_all_k,
    batched_optimal_dp,
    batched_total_cost,
    apply_accuracy_floor,
    apply_energy_budget,
    combine_channels,
    pareto_frontier,
    solve_multi_channel,
    solve_variant_bank,
    stack_cost_tensors,
    sweep_scalar,
)
# NOTE: `cuda_dp` imports sweep, so it comes after it.
from repro_torch.core.cuda_dp import (  # noqa: F401
    cuda_dp_tables,
    cuda_fused_dp_tables,
    cuda_fused_optimal_dp,
    cuda_optimal_dp,
)
# NOTE: `shard` imports cuda_dp and sweep, so it comes after them.
from repro_torch.core.shard import (  # noqa: F401
    mesh_from_spec,
    scenario_shards,
    sharded_dp_tables,
    sharded_optimal_dp,
)
from repro_torch.core.solvers import (  # noqa: F401
    SOLVERS,
    SolverResult,
    VariantInstance,
    beam_search,
    brute_force,
    budget_masked,
    first_fit_search,
    greedy_search,
    optimal_dp,
    random_fit,
    total_cost,
    total_energy,
)
# NOTE: `async_replan` stays a submodule attribute; it imports surface,
# so it comes after it (and before adaptive, which imports it).
from repro_torch.core.async_replan import (  # noqa: F401
    ManualExecutor,
    RebuildFanout,
    RebuildHandle,
    RebuildRequest,
    SurfaceRebuilder,
    recentered_axes,
)
# NOTE: `adaptive` stays a submodule attribute; it imports planner,
# surface, sweep and async_replan, so it comes after them.
from repro_torch.core.adaptive import (  # noqa: F401
    AdaptiveSplitManager,
    LinkEstimator,
    PlanDecision,
    fleet_managers,
    optimize_chunk_size,
    surface_parity_report,
)
