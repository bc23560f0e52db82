"""Shared validation for MPC scenario-batch jobs.

The frontend validates before publishing (bad form values become a 400,
mirroring the serve tier's compile-churn clamps, serve/server.py
ALLOWED_HORIZONS), and the worker re-validates before building an engine
(defense in depth: a job published by another producer must not be able to
key long first compiles with arbitrary values,
nor crash-loop the worker on malformed payloads). Kept free of jax imports
so the frontend stays light.
"""

from __future__ import annotations

# Bounds for job-supplied MPCConfig overrides. The batch tier is wider than
# the serve tier's interactive allowlist (it may legitimately run pod-scale
# horizons) but still bounded: each distinct config is a fresh jit cache
# entry and a minutes-long first compile.
MAX_HORIZON = 64
MAX_FEATURES = 16
MAX_ITERS = 20
MAX_REPEAT = 100
CONFIG_FIELDS = ("horizon", "num_features", "ilqr_iters", "admm_iters")


def validate_mpc_config(config: dict) -> dict:
    """Return a cleaned copy of the MPCConfig overrides; raise ValueError."""
    clean = {}
    for name in CONFIG_FIELDS:
        if name not in config:
            continue
        try:
            val = int(config[name])
        except (TypeError, ValueError):
            raise ValueError(f"{name} must be an integer") from None
        hi = (MAX_HORIZON if name == "horizon"
              else MAX_FEATURES if name == "num_features" else MAX_ITERS)
        if not 1 <= val <= hi:
            raise ValueError(f"{name} must be in 1..{hi}")
        clean[name] = val
    unknown = set(config) - set(CONFIG_FIELDS)
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    return clean
