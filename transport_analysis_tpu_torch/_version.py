"""Version bookkeeping: the port's own copy of the JAX package's
``_version.py`` (the reference's versioneer ``get_versions()`` surface).
The version is the project's, ``pyproject.toml``'s."""

from __future__ import annotations

import os
import subprocess

__version__ = "0.9.0"


def _git_revision() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=here,
            capture_output=True,
            text=True,
            timeout=5,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def get_versions() -> dict:
    return {
        "version": __version__,
        "full-revisionid": _git_revision(),
        "dirty": None,
        "error": None,
    }
