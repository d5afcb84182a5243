"""Scripts that measure the port on the card."""

import os
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])


def checkout_env(**extra) -> dict:
    """``os.environ`` (plus ``extra``) with this checkout first on
    ``PYTHONPATH``: a child ``python -m ray_tpu_torch...`` then imports
    the same package as its parent, whatever its working directory."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path
                                                 if path else ""), **extra)
