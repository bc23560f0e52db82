"""Closed-form checks for the static FLOP walker (bench/flops.py).

The walker exists because ``compiled.cost_analysis()`` neither multiplies
loop bodies by trip count nor sees inside ``pallas_call`` — these tests
pin exactly those two behaviors plus the dot_general convention.
"""

import jax
import jax.numpy as jnp
import pytest

from openmp_parallel_computing_tpu.bench.flops import count_flops


class TestElementwiseAndDot:
    def test_matmul_flops(self):
        a = jnp.ones((8, 32))
        b = jnp.ones((32, 16))
        c = count_flops(lambda x, y: x @ y, a, b)
        assert c.flops == 2 * 8 * 16 * 32

    def test_batched_dot(self):
        a = jnp.ones((4, 8, 32))
        b = jnp.ones((4, 32, 16))
        c = count_flops(jnp.matmul, a, b)
        assert c.flops == 4 * 2 * 8 * 16 * 32

    def test_elementwise_chain(self):
        x = jnp.ones((8, 128))
        c = count_flops(lambda v: v * 2.0 + 1.0, x)
        assert c.flops == 2 * 8 * 128

    def test_reduce_counts_input_size(self):
        x = jnp.ones((8, 128))
        c = count_flops(jnp.sum, x)
        assert c.flops == 8 * 128

    def test_zero_cost_ops_ignored(self):
        x = jnp.ones((8, 128))
        c = count_flops(lambda v: jnp.transpose(v).reshape(-1)[:16], x)
        assert c.flops == 0


class TestLoops:
    def test_scan_multiplies_by_length(self):
        x = jnp.ones((8, 8))

        def f(v):
            return jax.lax.scan(lambda c, _: (c @ c, None), v, None,
                                length=7)[0]

        c = count_flops(f, x)
        assert c.flops == 7 * 2 * 8 * 8 * 8
        assert c.unknown_loops == 0

    def test_nested_scan(self):
        x = jnp.ones((4, 4))

        def inner(v):
            return jax.lax.scan(lambda c, _: (c + 1.0, None), v, None,
                                length=3)[0]

        def outer(v):
            return jax.lax.scan(lambda c, _: (inner(c), None), v, None,
                                length=5)[0]

        c = count_flops(outer, x)
        assert c.flops == 5 * 3 * 16

    def test_while_flagged_unknown(self):
        x = jnp.float32(0.0)

        def f(v):
            return jax.lax.while_loop(lambda s: s < 10.0,
                                      lambda s: s + 1.0, v)

        c = count_flops(f, x)
        assert c.unknown_loops == 1
        assert c.flops >= 1        # body counted at least once

    def test_cond_takes_max_branch(self):
        x = jnp.ones((8, 8))

        def f(v):
            return jax.lax.cond(v[0, 0] > 0.0,
                                lambda u: u @ u,        # 2*8*8*8 = 1024
                                lambda u: u + 1.0,      # 64
                                v)

        c = count_flops(f, x)
        assert c.flops == 2 * 8 * 8 * 8


class TestPallas:
    def test_kernel_body_times_grid(self):
        from jax.experimental import pallas as pl

        def k(x_ref, o_ref):
            o_ref[...] = x_ref[...] * 2.0 + 1.0

        def f(x):
            return pl.pallas_call(
                k,
                out_shape=jax.ShapeDtypeStruct((32, 128), jnp.float32),
                grid=(4,),
                in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
                out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
            )(x)

        c = count_flops(f, jnp.ones((32, 128)))
        assert c.flops == 4 * (2 * 8 * 128)
        assert c.pallas_flops == c.flops
        # stream bound: (in + out) block bytes per grid point
        assert c.pallas_hbm_bytes == 4 * 2 * (8 * 128 * 4)

    def test_solver_kernels_dominate_at_qedge0(self):
        """At q_edge=0 the shipped solve's flops are almost entirely inside
        the sweep's scanned Riccati backward and line-searched forward
        programs — the glue is layout/ADMM vector work."""
        from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
        from openmp_parallel_computing_tpu.utils.config import MPCConfig

        B = 8
        cfg = MPCConfig(horizon=6, num_features=4, scenarios=B, q_edge=0.0)
        mpc = VisualServoMPC(cfg)
        scen = mpc.random_scenarios(jax.random.PRNGKey(0), B)
        edge = jnp.zeros((64, 128), jnp.float32)
        c = count_flops(lambda s: mpc.solve_batch(edge, s), scen)
        assert c.flops > 0
        in_sweeps = (c.by_call.get("backward_sweep", 0.0)
                     + c.by_call.get("forward_sweep", 0.0))
        assert in_sweeps / c.flops > 0.9
        assert c.pallas_flops == 0.0
