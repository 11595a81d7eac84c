"""show_version: print framework + stream-format version (the port's copy of
sperr_tpu/cli/show_version.py, naming sperr_tpu_torch)."""

from __future__ import annotations

import subprocess


def run(argv=None) -> int:
    from .. import SPERR_VERSION_MAJOR, __version__

    sha = "unknown"
    try:
        sha = (
            subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
            ).stdout.strip()
            or sha
        )
    except Exception:
        pass
    print(f"sperr_tpu_torch version {__version__} ({sha})")
    print(f"SPERR stream format major version {SPERR_VERSION_MAJOR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
