"""Deprecation shim: the model-serving demo moved to
``repro_torch.launch.serve_model`` (the ``serve`` name was reserved for the
planner front door — see ``repro_torch.flow.daemon`` and
``repro_torch.launch.serve_planner``).

``python -m repro_torch.launch.serve ...`` still works, with a warning.
"""
from __future__ import annotations

import warnings

from repro_torch.launch.serve_model import main, serve  # noqa: F401

# a plain DeprecationWarning: this shim is a user-facing rename, not a
# planner-API migration
warnings.warn(
    "repro_torch.launch.serve moved to repro_torch.launch.serve_model; the "
    "planner serving daemon lives in repro_torch.flow.daemon (CLI: "
    "python -m repro_torch.launch.serve_planner)",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
