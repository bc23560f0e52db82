"""Single-command stack launcher.

Capability twin of the reference's compose topology
(``event-driven/docker-compose.yml:1-41``: storage + broker + worker +
frontend): starts the frontend HTTP server and N worker processes over one
shared dispatch root. The storage and broker are the in-process durable
store/queue (no external services), so ``python -m
openmp_parallel_computing_tpu.dispatch.stack`` is the whole
``docker compose up``.

Worker death is survivable by design: unacked jobs redeliver after the
visibility timeout, and workers are plain processes that can be restarted
(or scaled: ``--workers N`` is the replication recipe of
``event-driven/README.md:57-73``).

One JAX process per GPU: a JAX process reserves most of a card's memory
when it first uses it, so a second worker on the same card fails for want
of memory. The launcher therefore starts at most one worker per visible
GPU and pins each to its own card (``CUDA_VISIBLE_DEVICES``); on a host
without GPUs the workers run on the CPU as requested.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import threading

from openmp_parallel_computing_tpu.utils.config import DispatchConfig


def visible_gpus() -> list[str]:
    """Ids of the GPUs this process may hand to its children, found without
    starting JAX (which would claim a card): ``CUDA_VISIBLE_DEVICES`` when
    set, else nvidia-smi's list; empty on a host without GPUs."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [g.strip() for g in env.split(",") if g.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [g.strip() for g in out.splitlines() if g.strip()]


def plan_workers(requested: int, gpus: list[str]) -> list[dict[str, str]]:
    """The environment of each worker to start: one per GPU at most, each
    pinned to its own card; ``requested`` CPU workers when there is no
    GPU."""
    if not gpus:
        return [{} for _ in range(max(1, requested))]
    return [{"CUDA_VISIBLE_DEVICES": g} for g in gpus[:max(1, requested)]]


def _worker_main(cfg: DispatchConfig, env: dict[str, str]) -> None:
    os.environ.update(env)          # before JAX first touches a device
    from openmp_parallel_computing_tpu.dispatch.worker import Worker
    from openmp_parallel_computing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    Worker(cfg).run()


def _broker_main(root: str, port: int, visibility_timeout_s: float,
                 token: str, max_body_mb: int) -> None:
    from openmp_parallel_computing_tpu.dispatch.broker import serve_broker

    serve_broker(root, host="127.0.0.1", port=port,
                 visibility_timeout_s=visibility_timeout_s,
                 token=token, max_body_mb=max_body_mb).serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="dispatch root: a directory (shared-filesystem "
                         "backend) or an http://host:port broker URL")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--broker-port", type=int, default=0,
                    help="also start a network broker on this port and "
                         "route the whole tier through it (the reference's "
                         "network-reachable RabbitMQ/MinIO topology; 0 = "
                         "direct filesystem backend)")
    args = ap.parse_args(argv)

    from openmp_parallel_computing_tpu.utils.config import load

    cfg = load().dispatch
    if args.root:
        cfg.root = args.root

    ctx = mp.get_context("spawn")
    broker = None
    if args.broker_port:
        from openmp_parallel_computing_tpu.dispatch.broker import _HttpClient

        # The visibility timeout is broker-side state (NetworkQueue only
        # forwards claims); the embedded broker must inherit the config's
        # value or long first-compile MPC jobs would get swept back to
        # new/ mid-run at the 60 s default.
        broker = ctx.Process(
            target=_broker_main,
            args=(cfg.root, args.broker_port, cfg.visibility_timeout_s,
                  cfg.auth_token, cfg.max_body_mb),
            daemon=True)
        broker.start()
        url = f"http://127.0.0.1:{args.broker_port}"
        _HttpClient(url, retries=20, retry_delay_s=0.25).json(
            "GET", "/healthz")  # wait for the broker to come up
        cfg.root = url
    envs = plan_workers(args.workers, visible_gpus())
    if len(envs) < args.workers:
        print(f"starting {len(envs)} worker(s), one per visible GPU, "
              f"not the {args.workers} requested")
    workers = [ctx.Process(target=_worker_main, args=(cfg, env), daemon=True)
               for env in envs]
    for w in workers:
        w.start()

    from openmp_parallel_computing_tpu.dispatch.frontend import serve

    httpd, state = serve(cfg, port=args.port)
    print(f"frontend on :{args.port}, {len(workers)} worker(s), "
          f"root={cfg.root}")

    def shutdown(*_):
        # shutdown() must run on a different thread than serve_forever()
        # (calling it from this signal handler, which executes on the
        # serving thread, deadlocks on the internal event).
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    try:
        httpd.serve_forever()
    finally:
        state.shutdown()
        for w in workers:
            w.terminate()
        if broker is not None:
            broker.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
