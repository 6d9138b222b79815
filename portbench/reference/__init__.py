"""Plain f32 references of the served models, for the correctness check.

Plain torch alone: nothing here imports the program, the JAX package or a
kernel. Each family's forward takes the benchmark's weights (the port's
parameter layout, as the benchmark drew them) and the token ids, and works
out everything else again.
"""
from __future__ import annotations

import importlib


def module(name: str):
    """The reference ``portbench.reference.<name>`` that a configuration's
    file names under ``reference``."""
    return importlib.import_module(f"portbench.reference.{name}")
