"""Where the port builds its native code: ``kazen_tpu_torch/build/`` (listed
in .gitignore), created at first use."""
from __future__ import annotations

import os

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def build_dir() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    return _BUILD
