"""Build/version stamping.

Reference: ``util/VersionInfo.java`` (149 LoC) injects build
version/revision/branch into the job configuration at submit time
(``TonyClient.java:152``), so the frozen artifact records exactly which
build ran the job. Here the same triple is resolved at submit from the
package version plus best-effort git metadata and stamped into the frozen
``tony-final.json`` under ``tony.internal.{version,revision,branch}``.
The port's version also names the torch it runs on (read from the installed
package's metadata: the control plane never imports torch).
"""

from __future__ import annotations

import functools
import importlib.metadata
import os
import subprocess
from typing import Dict


@functools.lru_cache(maxsize=1)
def version_info() -> Dict[str, str]:
    from tony_tpu_torch import __version__

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def _git(*args: str) -> str:
        try:
            out = subprocess.run(
                ["git", *args], cwd=root, capture_output=True, text=True,
                timeout=5)
            return out.stdout.strip() or "unknown"
        except Exception:  # noqa: BLE001 — no git / not a checkout
            return "unknown"

    # Only stamp git metadata when the checkout is actually OURS: an
    # installed package under someone else's repo (site-packages inside a
    # project checkout) would otherwise record the USER's revision as the
    # framework build — wrong provenance is worse than "unknown".
    toplevel = _git("rev-parse", "--show-toplevel")
    ours = toplevel != "unknown" and \
        os.path.realpath(toplevel) == os.path.realpath(root)
    try:
        torch_version = importlib.metadata.version("torch")
    except importlib.metadata.PackageNotFoundError:
        torch_version = "unknown"
    return {
        "version": __version__,
        "torch": torch_version,
        "revision": _git("rev-parse", "--short", "HEAD") if ours
        else "unknown",
        "branch": _git("rev-parse", "--abbrev-ref", "HEAD") if ours
        else "unknown",
    }
