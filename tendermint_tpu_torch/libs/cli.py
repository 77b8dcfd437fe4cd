"""CLI plumbing shared by __main__ (reference libs/cli/setup.go).

The reference's cobra scaffolding binds --home, --log_level, --trace and
env-var overrides (TM_ prefix, setup.go:29-60). argparse is the Python
idiom; this module holds the pieces every command shares.
"""

from __future__ import annotations

import argparse
import os


ENV_PREFIX = "TM"


def default_home() -> str:
    """$TMHOME > $TM_HOME > ~/.tendermint_tpu (reference HomeFlag)."""
    return (
        os.environ.get("TMHOME")
        or os.environ.get("TM_HOME")
        or os.path.expanduser("~/.tendermint_tpu")
    )


def add_global_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--home", default=default_home(), help="node home dir")
    p.add_argument(
        "--log-level",
        default=os.environ.get(f"{ENV_PREFIX}_LOG_LEVEL", "info"),
        help="debug|info|error|none",
    )
    p.add_argument(
        "--trace",
        action="store_true",
        default=bool(os.environ.get(f"{ENV_PREFIX}_TRACE")),
        help="print full tracebacks on error",
    )


def env_override(args: argparse.Namespace, key: str):
    """TM_<KEY> env beats config file, flag beats env (setup.go:52-60)."""
    return os.environ.get(f"{ENV_PREFIX}_{key.upper()}")
