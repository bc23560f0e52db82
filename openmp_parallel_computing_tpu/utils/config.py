"""Typed configuration spanning kernels / mesh / solver / serving.

Replaces the reference's four ad-hoc config layers — positional argv
(``monolithic/src/main.c:15-18``), env vars (``OMP_NUM_THREADS``,
``MINIO_*``, ``RABBITMQ_URL``), HTTP form fields (``threads``/``passes``/
``repeat``), and compose-file env injection — with one dataclass tree plus
uniform env-var and CLI overrides (``OMPC_<SECTION>_<FIELD>`` /
``--section.field=value``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class KernelConfig:
    passes: int = 1                   # kernel repeat count (bench contract)


@dataclasses.dataclass
class MeshConfig:
    data: int = -1                    # devices along the data axis (-1: rest)
    model: int = 1                    # devices along the model axis


@dataclasses.dataclass
class MPCConfig:
    horizon: int = 20                 # H
    num_features: int = 8             # tracked image-plane feature points
    scenarios: int = 256              # rollout batch per solve
    # Iteration budget. History: rounds 2-4 shipped a FIXED 1x5 with
    # admm_relax=1.3 (below) — quality-equivalent to the plain-ADMM 3x5
    # plateau at a third of the sweeps (results/cpu/relax_study_solve.json,
    # docs/DESIGN.md §2f). Round 5 ships the ADAPTIVE split of that same
    # budget: a 1x3 base plus up to 2 residual-gated extra iterations
    # (admm_iters_extra/admm_tol below). A cold solve's batch-max residual
    # after 3 iterations always exceeds the gate, so one-shot solve_batch
    # calls still run the full 5 iterations BIT-IDENTICALLY to the old
    # defaults (tests/test_solver_quality.py's pinned golden is unchanged);
    # settled receding-horizon loops with the dual carry pass the gate and
    # run at the 3-iteration base — the r4 "1x3-dual labeled option" now
    # quality-gated and default (closed-loop cost within 0.00-0.02% of the
    # fixed 1x5-cold loop at H=20 and H=50:
    # results/cpu/adaptive_budget_h{20,50}.json). The headline bench
    # (bench.py) runs exactly these defaults.
    ilqr_iters: int = 1               # linearize/solve sweeps per ADMM iter
    admm_iters: int = 2               # base constraint-projection iters
    dt: float = 1.0 / 30.0
    u_limit: float = 1.0              # control box |u| <= u_limit
    q_track: float = 1.0              # feature tracking weight
    r_ctrl: float = 1e-2              # control effort weight
    q_edge: float = 0.1               # edge-map attraction weight
    # Solver backend (all numerically equivalent, equivalence-tested):
    #   "sweep"     - batch-last lanes layout, the Riccati backward and
    #                 line-searched forward as lax.scan programs over the
    #                 horizon (models/mpc/sweep.py; default)
    #   "reference" - per-scenario vmapped XLA implementation
    #   "assoc"     - reference with the associative-scan (log-depth)
    #                 Riccati backward: the latency-bound long-horizon
    #                 regime (riccati.backward_assoc)
    backend: str = "sweep"
    # Edge-term linearization schedule (same semantics in every backend,
    # so cross-backend equivalence holds per setting):
    #   "ilqr" - re-sample the edge pyramid value+grad at the nominal
    #            trajectory before EVERY iLQR sweep
    #   "admm" - sample once per ADMM iteration (the iLQR sweeps inside
    #            share the linearization) — fewer pyramid samplings
    #   "solve" - sample once at the warm-start trajectory for the WHOLE
    #            solve (pure real-time mode: staleness bounded by the
    #            per-frame warm-start distance)
    # Default "admm": final-cost parity with "ilqr" (tests/test_mpc.py::
    # TestEdgeRefresh) at fewer samplings; cold-start solves have no
    # warm-start distance to bound "solve"'s staleness.
    edge_refresh: str = "admm"
    # Pyramid sampling implementation for the sweep backend's lanes paths
    # (value + gradient of the edge cost); numerically equivalent (tested):
    #   "xla"      - dense separable-weight einsums in XLA, gradients by
    #                autodiff (the weight tensors materialize twice:
    #                forward and backward pass)
    #   "analytic" - the same dense-weight einsums with value AND gradient
    #                computed analytically in one pass
    #                (costs.edge_vg_pyramid_xy): the weight tensors
    #                materialize once. Default.
    edge_sampler: str = "analytic"
    # Storage dtype for the dense sampler's weight tensors / level fields
    # ("float32" or "bfloat16"; sweep backend, "xla"/"analytic" samplers).
    # Contractions still accumulate in f32 (``preferred_element_type``);
    # bf16 halves the bytes of the materialized hat-weight tensors.
    # Default f32 (bit-identical to the historical path, pinned by test);
    # the bf16 numerics are tested (quantization ~2^-8 of a pyramid cell
    # on positions after mean-centering the level; closed-loop cost
    # within seed noise at H=20/H=50 — results/cpu/sampler_dtype_quality.json,
    # tests/test_mpc.py::TestSamplerDtype). Part of the jit static key.
    sampler_dtype: str = "float32"
    # Quality-gated adaptive budget (round 5): after the admm_iters base
    # iterations, run admm_iters_extra FURTHER ADMM iterations only when
    # the batch-max primal residual max|us - z| still exceeds admm_tol —
    # one scalar reduction and a lax.cond around a fixed-shape scan, so
    # the whole thing stays jit/scan-safe and the shapes static. The
    # gating is BATCH-GLOBAL in every backend (one predicate for the
    # whole solve), which keeps the four backends numerically equivalent
    # (per-scenario gating would diverge between the vmapped reference
    # path and the lanes kernels). 0 = off (fixed budget, the pre-r5
    # behavior, bit-identical). With the dual warm start carrying the
    # scaled duals between frames, the settled receding-horizon loop
    # passes the residual check almost every frame and runs at the
    # reduced base budget; cold starts and transients trip the check and
    # get the full budget (see
    # docs/DESIGN.md §2j and results/cpu/adaptive_budget_h{20,50}.json).
    # Defaults 2+3@0.1 (retightened from the first-shipped 3+2@0.1
    # once the corrected quality study showed the settled H=20 loop
    # passes the gate at TWO base iterations with the same seed-noise
    # cost profile: +0.006%/+0.030% across seeds vs 3+2's +0.01%/+0.027%,
    # results/cpu/adaptive_budget2_h20*.json). Cold solves
    # still trip the gate (residual after 2 iters ~1.6 >> 0.1), so
    # one-shot results remain bit-identical to the fixed 1x5 (the pinned
    # golden did not move); at H=50 the gate fires every frame and the
    # loop keeps exact 1x5-dual behavior. CEILING: base+extra is 5
    # because 5 effective iterations is also the most the decayed dual
    # carry TOLERATES at long horizons — 7 effective destabilizes the
    # H=50 loop (+22% asymptotic cost; docs/DESIGN.md §2j "budget
    # ceiling", tests/test_solver_quality.py::
    # test_long_horizon_budget_ceiling). Don't raise admm_iters with the
    # extra gate left on without re-running that study.
    admm_iters_extra: int = 3
    admm_tol: float = 0.1
    # ADMM penalty. Also acts as proximal damping on the iLQR inner solve:
    # each inner step is ~gradient/(2*r_ctrl + rho) for low-curvature cost
    # terms (the edge field is piecewise-linear), so large rho slows
    # convergence; the returned controls are feasible by projection
    # regardless of rho.
    rho: float = 0.1
    # ADMM over-relaxation factor (Boyd et al., Distributed Optimization
    # §3.4.3): the z/dual updates see u_hat = relax*us + (1-relax)*z_prev.
    # 1.0 = off (plain ADMM, bit-identical to the pre-knob solver);
    # 1.5-1.8 is the classical range for convex splittings, but this ADMM
    # is inexact and nonconvex: >= 1.5 measured unstable on an adversarial
    # edge-dominated instance (q_track=0, 50x edge weight — DESIGN.md
    # §2f), while 1.3 improves BOTH the production operating point (the
    # 1x5 budget above beats the plain 15-sweep plateau,
    # results/cpu/relax_study_solve.json) and that adversarial instance.
    # Same semantics in every backend (equivalence-tested at relax != 1).
    admm_relax: float = 1.3
    # Warm-start the ADMM scaled duals across receding-horizon steps:
    # the closed-loop carry shifts last frame's duals (Scenario.y0 =
    # dual_decay * shift(Solution.dual), zero-filled tail like the plan
    # shift — solver._shift_tail_zero) instead of restarting them at
    # zero each solve. Standard warm-started-ADMM practice (Boyd et al.
    # §4.3: warm starts cut iterations in closed-loop MPC); the shifted
    # duals are near the new solve's fixed point because consecutive
    # frames differ by one dynamics step. Only changes the receding-
    # horizon carry — cold-start solve_batch calls are unaffected unless
    # the caller passes Scenario.y0 explicitly. Same semantics in every
    # backend.
    dual_warm_start: bool = True
    # Damping on the carried duals. THE UNDAMPED CARRY (1.0) IS
    # DIVERGENT: with inexact solves (1 iLQR sweep per relaxed ADMM
    # iteration) the carried dual error compounds frame over frame —
    # measured |y| -> 7.6e16 over 60 frames at H=50
    # (results/cpu/dual_warm_loop_h50.json's gamma study; at H=20 it
    # merely stayed lucky-bounded). 0.5 contracts the accumulated error
    # while keeping most of the one-frame warm-start signal, and
    # measures strictly better than cold duals at BOTH horizons: H=20
    # settled residual -21%, H=50 -42%, asymptotic closed-loop cost
    # equal or better at every budget (DESIGN.md §2i). 0.0 reproduces
    # the cold-dual loop exactly.
    dual_decay: float = 0.5

    def __post_init__(self):
        for field, allowed in (("backend", ("sweep", "reference", "assoc")),
                               ("edge_refresh", ("ilqr", "admm", "solve")),
                               ("edge_sampler", ("xla", "analytic")),
                               ("sampler_dtype", ("float32", "bfloat16"))):
            if getattr(self, field) not in allowed:
                raise ValueError(f"MPCConfig.{field} must be one of "
                                 f"{allowed}, got {getattr(self, field)!r}")


@dataclasses.dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 5000
    # Micro-batching of concurrent /control requests: requests arriving
    # within batch_window_ms of the first pending one coalesce into a
    # single device solve of up to max_batch scenarios.
    batch_window_ms: float = 5.0
    max_batch: int = 8
    # Bound on concurrent device computations (request threads beyond it
    # queue on a semaphore instead of piling work onto the device).
    max_inflight: int = 2
    # Real-time admission control for /control: a request is rejected with
    # 503 (shed) when its predicted completion wait — queue depth ahead of
    # it in the micro-batcher x the measured per-batch device time, plus
    # the batching window — exceeds its deadline, and a queued frame whose
    # deadline has already passed is dropped at dispatch instead of solved
    # stale. Clients state their own staleness budget per request via the
    # ``deadline_ms`` form field; this is the server-wide default for
    # requests that don't. 0 disables shedding (pure FIFO queueing, the
    # pre-round-4 behavior). The reference analogue fails fast with a 500
    # rather than queueing (microservices/grayscale/app.py:36-38).
    control_deadline_ms: float = 1000.0
    # Bound on DISTINCT image shapes accepted per process: every new shape
    # keys fresh jit cache entries (each a first compile of seconds to
    # minutes), so unauthenticated shape churn is capped like the
    # horizon/features/passes allowlists. First-come shapes are admitted;
    # past the cap, unseen shapes get a 400.
    max_shapes: int = 16
    # Ingestion cap: requests declaring a body larger than this are
    # rejected with 413 BEFORE the body is read (utils.httpguard), so one
    # crafted Content-Length cannot buffer the process into OOM. 64 MiB
    # clears any realistic camera frame (a 6 MP PNG is ~10-30 MB).
    max_body_mb: int = 64
    # Bound on per-/control receding-horizon SESSIONS held in memory
    # (warm-start plan + carried duals per session, ~horizon*6 floats
    # each): least-recently-used sessions past the cap are evicted, as
    # are sessions idle longer than session_idle_s. A fleet of real
    # controllers at one session per camera sits far below the cap.
    max_sessions: int = 256
    session_idle_s: float = 300.0


@dataclasses.dataclass
class DispatchConfig:
    # Queue + object-store location: a DIRECTORY (shared-filesystem
    # backend, single-host default) or an ``http://host:port`` URL of a
    # ``dispatch.broker`` process — the network path that lets the tier
    # span machines without a shared mount, matching the reference's
    # network-reachable RabbitMQ/MinIO (docker-compose.yml:3-18).
    root: str = "/tmp/ompc_dispatch"
    queue: str = "grayscale"
    visibility_timeout_s: float = 60.0
    # Ingestion cap for the frontend's and broker's HTTP surfaces: bodies
    # declaring more than this are 413'd before being read (see
    # ServeConfig.max_body_mb).
    max_body_mb: int = 64
    # Shared secret for the broker's MUTATING routes (queue publish/claim/
    # ack/nack, object put/delete): clients send it as X-Auth-Token.
    # Empty = auth disabled (single-host filesystem default, where Unix
    # permissions do the job). Set via OMPC_DISPATCH_AUTH_TOKEN to span
    # machines the way the reference's RabbitMQ/MinIO require credentials
    # (docker-compose.yml:5-17).
    auth_token: str = ""


@dataclasses.dataclass
class Config:
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    dispatch: DispatchConfig = dataclasses.field(
        default_factory=DispatchConfig)


def _coerce(value: str, ref: Any) -> Any:
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes")
    if ref is None or isinstance(ref, int):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    return value


def load(env: dict[str, str] | None = None,
         overrides: list[str] | None = None) -> Config:
    """Build a Config from defaults + OMPC_* env vars + --a.b=c overrides."""
    cfg = Config()
    env = dict(os.environ if env is None else env)
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        for f in dataclasses.fields(section):
            key = f"OMPC_{section_field.name.upper()}_{f.name.upper()}"
            if key in env:
                setattr(section, f.name,
                        _coerce(env[key], getattr(section, f.name)))
    for item in overrides or []:
        item = item.lstrip("-")
        path, _, value = item.partition("=")
        sec_name, _, field = path.partition(".")
        section = getattr(cfg, sec_name)
        setattr(section, field, _coerce(value, getattr(section, field)))
    return cfg
