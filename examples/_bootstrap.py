"""Make the repo root importable so examples run without installing.

``python examples/<name>.py`` puts examples/ on sys.path but not the repo
root; importing this module first fixes that (and is a no-op if dynode_tpu
is installed).

For CI (tests/test_examples runs every script headless on the CPU with
``JAX_PLATFORMS=cpu``, mirroring the reference's example-as-integration-test
workflow, CDCgov/DynODE/.github/workflows/test-example.yaml:24-28),
``DYNODE_FAST_EXAMPLES=1`` is read by the inference-heavy examples to
shrink their workloads (fewer chains/draws), via :func:`fast_mode`.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def fast_mode() -> bool:
    """True when CI asks examples to shrink their workloads."""
    return bool(os.environ.get("DYNODE_FAST_EXAMPLES"))
