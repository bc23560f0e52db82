"""What keeps the GPU path honest, checked on the CPU: every float32
contraction on the control path pinned to HIGHEST precision (no TF32), the
compile-cache placement, ``chip_smoke.py`` refusing to run without a GPU,
and the dispatch stack's one-worker-per-card rule."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from openmp_parallel_computing_tpu.dispatch import stack
from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC
from openmp_parallel_computing_tpu.utils.config import MPCConfig

REPO = Path(__file__).resolve().parents[1]
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    """(precision, shapes) of every float32 dot_general, nested ones too."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and all(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn.params.get("precision"), [v.aval.shape
                                                for v in eqn.invars]
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _f32_dots(sub)


def _small(**kw):
    return MPCConfig(horizon=4, num_features=2, **kw)


def _control_step(cfg):
    mpc = VisualServoMPC(cfg)
    frame = jnp.zeros((3, 48, 160), jnp.uint8)
    scen = mpc.random_scenarios(jax.random.PRNGKey(0), 3)
    return jax.make_jaxpr(VisualServoMPC.control_step, static_argnums=0)(
        mpc, frame, scen)


def _receding_frames(cfg):
    mpc = VisualServoMPC(cfg)
    frames = jnp.zeros((2, 3, 48, 160), jnp.uint8)
    scen = mpc.random_scenarios(jax.random.PRNGKey(0), 3)
    return jax.make_jaxpr(VisualServoMPC.receding_horizon_frames,
                          static_argnums=(0, 3))(mpc, frames, scen, 2)


def _sharded_base():
    from jax.sharding import PartitionSpec as P

    from openmp_parallel_computing_tpu import parallel
    from openmp_parallel_computing_tpu.models.mpc.distributed import (
        MODEL, perception_base)

    mesh = parallel.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    f = jax.shard_map(lambda fr: perception_base(fr, 2)[0], mesh=mesh,
                      in_specs=P(None, MODEL, None), out_specs=P(),
                      check_vma=False)
    return jax.make_jaxpr(f)(jnp.zeros((3, 64, 160), jnp.uint8))


@pytest.mark.parametrize("path", [
    "control_step", "control_step_xla_sampler", "control_step_reference",
    "control_step_assoc", "receding_horizon_frames", "sharded_pyramid_base"])
def test_f32_contractions_pinned_highest(path):
    jaxpr = {
        "control_step": lambda: _control_step(_small()),
        "control_step_xla_sampler": lambda: _control_step(
            _small(edge_sampler="xla")),
        "control_step_reference": lambda: _control_step(
            _small(backend="reference")),
        "control_step_assoc": lambda: _control_step(_small(backend="assoc")),
        "receding_horizon_frames": lambda: _receding_frames(
            _small(edge_refresh="solve")),
        "sharded_pyramid_base": _sharded_base,
    }[path]()
    dots = list(_f32_dots(jaxpr.jaxpr))
    assert dots, "expected f32 contractions on this path"
    loose = [shapes for prec, shapes in dots if prec != HIGHEST]
    assert not loose, f"{len(loose)} f32 dot_general(s) not HIGHEST: {loose}"


def _python(code: str, env_extra: dict, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


_CACHE_PROBE = ("import jax\n"
                "from openmp_parallel_computing_tpu.utils.compile_cache "
                "import enable_compile_cache\n"
                "print(enable_compile_cache())\n"
                "print(jax.config.jax_compilation_cache_dir)\n")


def test_compile_cache_honours_env(tmp_path):
    out = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_default_inside_checkout():
    out = _python(_CACHE_PROBE, {})
    assert out.returncode == 0, out.stderr
    want = str(REPO / ".jax_cache")
    assert out.stdout.split() == [want, want]
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored, ".jax_cache/ must be in .gitignore"


def test_chip_smoke_refuses_cpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("requested,gpus,want", [
    (2, ["0"], ["0"]),                      # never two workers on a card
    (4, ["0", "1", "2", "3"], ["0", "1", "2", "3"]),
    (1, ["0", "1"], ["0"]),
    (8, ["2", "3"], ["2", "3"]),
])
def test_stack_one_worker_per_gpu(requested, gpus, want):
    envs = stack.plan_workers(requested, gpus)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == want


def test_stack_cpu_host_runs_requested_workers():
    assert stack.plan_workers(3, []) == [{}, {}, {}]


@pytest.mark.parametrize("env,want", [("0,1", ["0", "1"]), ("", []),
                                      ("3", ["3"])])
def test_stack_reads_visible_devices(monkeypatch, env, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    assert stack.visible_gpus() == want
    np.testing.assert_equal(len(stack.plan_workers(2, want)),
                            min(2, len(want)) if want else 2)
