"""Static FLOP / HBM-stream counting by walking a jaxpr.

XLA's ``compiled.cost_analysis()`` counts loop bodies ONCE (trip counts
are not multiplied in) and sees nothing inside a ``pallas_call`` — so it
is useless for a roofline of a solver that is 5 nested scans deep. This
walker does the multiplication the hardware does:

- ``scan`` bodies are counted ``length`` times;
- ``pallas_call`` bodies are counted once per grid point
  (``prod(grid)``), using the kernel-body jaxpr embedded in the
  primitive's params;
- ``while_loop`` trip counts are unknowable statically — counted once
  and reported in ``unknown_loops`` so the caller knows the number is a
  lower bound;
- ``cond``/``custom_*`` branches recurse (cond takes the max branch);
- flops inside a named jitted call (a ``jit`` equation) are also tallied under
  that name in ``by_call`` (nested calls count toward every enclosing
  name), so a caller can see which functions hold the work.

FLOP conventions (roofline-style, matching the hand counts previously in
docs/DESIGN.md §2b): elementwise arith = 1 flop/element; ``dot_general``
= 2·M·N·K·batch; comparisons/selects/copies = 0; transcendentals = 1
(one issue slot each, which is what the solver's roofline is measured
against).

HBM stream estimate: for each ``pallas_call``, bytes = Σ over
inputs/outputs of block_bytes × grid points (an upper bound that ignores
block revisiting and on-chip residency between grid steps); for plain XLA
ops nothing is counted (fusion makes static per-op byte counts
meaningless — use the compiled cost analysis for the XLA part instead).

Guarded by tests/test_flops.py against closed-form counts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import numpy as np

# Elementwise primitives worth one flop per output element.
_ELEMENTWISE_1 = {
    "add", "sub", "mul", "div", "rem", "neg", "abs", "sign",
    "max", "min", "exp", "log", "log1p", "expm1", "sqrt", "rsqrt",
    "tanh", "logistic", "sin", "cos", "floor", "ceil", "round",
    "erf", "pow", "atan2", "cbrt", "square", "reciprocal",
    "add_any",
}
# Reductions / segmented ops: one flop per INPUT element.
_REDUCE = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
           "reduce_and", "reduce_or", "cumsum", "cumlogsumexp",
           "cummax", "cummin", "cumprod", "argmax", "argmin"}
# Recurse-through call-like primitives (count once).
_CALLS = {"pjit", "jit", "closed_call", "core_call", "custom_jvp_call",
          "custom_vjp_call", "custom_vjp_call_jaxpr", "remat", "checkpoint",
          "custom_partitioning", "shard_map"}


@dataclass
class Counts:
    flops: float = 0.0
    pallas_flops: float = 0.0          # subset of flops inside kernels
    pallas_hbm_bytes: float = 0.0      # block-stream upper bound
    unknown_loops: int = 0             # while_loops counted once
    by_prim: dict = field(default_factory=dict)
    by_call: dict = field(default_factory=dict)   # pjit name -> flops

    def _bump(self, name: str, n: float, scale: float,
              in_pallas: bool, calls: tuple = ()) -> None:
        v = n * scale
        self.flops += v
        if in_pallas:
            self.pallas_flops += v
        self.by_prim[name] = self.by_prim.get(name, 0.0) + v
        for call in set(calls):
            self.by_call[call] = self.by_call.get(call, 0.0) + v


def _size(aval) -> float:
    return float(math.prod(getattr(aval, "shape", ()) or (1,)))


def _dot_flops(eqn) -> float:
    (lhs_c, rhs_c), (lhs_b, rhs_b) = eqn.params["dimension_numbers"]
    a = eqn.invars[0].aval
    k = math.prod(a.shape[d] for d in lhs_c)
    out = _size(eqn.outvars[0].aval)
    return 2.0 * out * k


def _conv_flops(eqn) -> float:
    rhs = eqn.invars[1].aval            # kernel: (..., in_ch, out_ch) etc.
    out = _size(eqn.outvars[0].aval)
    # taps per output = kernel spatial size x input feature dim
    dn = eqn.params["dimension_numbers"]
    ksp = math.prod(rhs.shape[d] for d in dn.rhs_spec[2:])
    kin = rhs.shape[dn.rhs_spec[1]]
    return 2.0 * out * ksp * kin


def _walk(jaxpr, counts: Counts, scale: float, in_pallas: bool,
          calls: tuple = ()) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            inner = eqn.params["jaxpr"].jaxpr
            _walk(inner, counts, scale * eqn.params["length"], in_pallas,
                  calls)
        elif name == "while":
            counts.unknown_loops += 1
            _walk(eqn.params["body_jaxpr"].jaxpr, counts, scale, in_pallas,
                  calls)
        elif name == "cond":
            best = None
            for br in eqn.params["branches"]:
                sub = Counts()
                _walk(br.jaxpr, sub, scale, in_pallas, calls)
                if best is None or sub.flops > best.flops:
                    best = sub
            if best is not None:
                counts.flops += best.flops
                counts.pallas_flops += best.pallas_flops
                counts.pallas_hbm_bytes += best.pallas_hbm_bytes
                counts.unknown_loops += best.unknown_loops
                for k, v in best.by_prim.items():
                    counts.by_prim[k] = counts.by_prim.get(k, 0.0) + v
                for k, v in best.by_call.items():
                    counts.by_call[k] = counts.by_call.get(k, 0.0) + v
        elif name == "pallas_call":
            gm = eqn.params["grid_mapping"]
            grid = math.prod(gm.grid) if gm.grid else 1
            body = eqn.params["jaxpr"]
            body = body.jaxpr if hasattr(body, "jaxpr") else body
            _walk(body, counts, scale * grid, True, calls)
            blk = 0.0
            for bm in gm.block_mappings:
                shape = getattr(bm, "block_shape", None) or ()
                dims = []
                for d in shape:
                    d = getattr(d, "block_size", d)   # pallas Blocked(...)
                    if d is None:                     # squeezed index dim
                        continue
                    try:
                        dims.append(int(d))
                    except (TypeError, ValueError):
                        pass
                blk += math.prod(dims) * 4.0 if dims else 0.0
            counts.pallas_hbm_bytes += blk * grid * scale
        elif name in _CALLS or "jaxpr" in eqn.params:
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is not None:
                named = (calls + (eqn.params.get("name", name),)
                         if name in ("pjit", "jit") else calls)
                _walk(inner.jaxpr if hasattr(inner, "jaxpr") else inner,
                      counts, scale, in_pallas, named)
        elif name == "dot_general":
            counts._bump(name, _dot_flops(eqn), scale, in_pallas, calls)
        elif name == "conv_general_dilated":
            counts._bump(name, _conv_flops(eqn), scale, in_pallas, calls)
        elif name in _REDUCE:
            counts._bump(name, _size(eqn.invars[0].aval), scale, in_pallas,
                         calls)
        elif name == "integer_pow":
            counts._bump(name, _size(eqn.outvars[0].aval), scale, in_pallas,
                         calls)
        elif name in _ELEMENTWISE_1:
            counts._bump(name, _size(eqn.outvars[0].aval), scale, in_pallas,
                         calls)
        # everything else (reshape/transpose/slice/select/compare/iota/
        # gather/dynamic_slice/convert): 0 flops by convention


def count_flops(fn, *args, **kwargs) -> Counts:
    """Trace ``fn(*args)`` and statically count flops (see module doc)."""
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args)
    c = Counts()
    _walk(jaxpr.jaxpr, c, 1.0, False)
    return c


def main() -> None:
    """Roofline inputs for the shipped solve at the headline config:
    per-solve FLOPs, in total and inside the sweep's backward/forward
    programs."""
    import argparse
    import json

    import jax.numpy as jnp

    from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
    from openmp_parallel_computing_tpu.utils.config import MPCConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--q-edge", type=float, default=0.1)
    args = ap.parse_args()

    B = args.batch
    cfg = MPCConfig(horizon=args.horizon, num_features=8, scenarios=B,
                    edge_refresh="solve", q_edge=args.q_edge)
    mpc = VisualServoMPC(cfg)
    scen = mpc.random_scenarios(jax.random.PRNGKey(0), B)
    edge = jnp.zeros((1088, 1920), jnp.float32)
    c = count_flops(lambda s: mpc.solve_batch(edge, s), scen)
    top = sorted(c.by_prim.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "batch": B, "horizon": args.horizon, "q_edge": args.q_edge,
        "flops_per_solve": round(c.flops / B, 1),
        "sweep_flops_per_solve": round(
            (c.by_call.get("backward_sweep", 0.0)
             + c.by_call.get("forward_sweep", 0.0)) / B, 1),
        "unknown_loops": c.unknown_loops,
        "top_prims_per_solve": {k: round(v / B, 1) for k, v in top},
    }))


if __name__ == "__main__":
    main()
