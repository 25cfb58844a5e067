"""Protocol version compatibility, the port's own copy of the checks in
petals_tpu/utils/version.py: versions are ``MAJOR.MINOR.PATCH`` and two
builds interoperate iff their (MAJOR, MINOR) match. A server refuses a
session whose ``client_version`` lies across that line. Unannounced or
unparseable versions are accepted; ``PETALS_TPU_IGNORE_VERSION=1`` disables
the check."""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import petals_tpu_torch

_VER_RE = re.compile(r"^\s*(\d+)\.(\d+)(?:\.(\d+))?")


def parse_version(version) -> Optional[Tuple[int, int]]:
    """(MAJOR, MINOR) of a version string, or None if unparseable."""
    if not isinstance(version, str):
        return None
    m = _VER_RE.match(version)
    return (int(m.group(1)), int(m.group(2))) if m else None


def gating_disabled() -> bool:
    return os.environ.get("PETALS_TPU_IGNORE_VERSION", "").strip() not in ("", "0", "false")


def is_compatible(peer_version: Optional[str]) -> bool:
    """Can this build talk to a peer announcing ``peer_version``?"""
    if gating_disabled() or peer_version is None:
        return True
    theirs = parse_version(peer_version)
    return theirs is None or theirs == parse_version(petals_tpu_torch.__version__)


def incompatibility_error(peer_version: Optional[str], peer: str = "server") -> str:
    ours = petals_tpu_torch.__version__
    return (
        f"{peer} runs petals_tpu_torch {peer_version}, this client runs {ours}; "
        f"builds interoperate only within the same MAJOR.MINOR line. Upgrade "
        f"the older side (or set PETALS_TPU_IGNORE_VERSION=1 to force)."
    )
