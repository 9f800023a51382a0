"""Every example script must execute headless (example-as-integration-test).

Mirrors the reference CI, which literally runs ``python3 examples/sir.py``
(/root/reference/.github/workflows/test-example.yaml:24-28), extended to all
scripts so they cannot rot silently. Each runs in a subprocess on local CPU
(``JAX_PLATFORMS=cpu``) with shrunken inference workloads
(``DYNODE_FAST_EXAMPLES``); figures land in a tmp dir.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLES_DIR = os.path.join(REPO, "examples")

EXAMPLES = sorted(
    f
    for f in os.listdir(EXAMPLES_DIR)
    if f.endswith(".py") and not f.startswith("_")
)


def test_example_list_is_current():
    # the reference ships 7 example workloads (SURVEY.md section 2.6); this
    # repo adds seip.py and ensemble_scenarios.py
    assert len(EXAMPLES) >= 9, EXAMPLES


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_headless(script, tmp_path):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        DYNODE_FAST_EXAMPLES="1",
        MPLBACKEND="Agg",
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, script)],
        env=env,
        cwd=tmp_path,  # relative savefig() outputs land here
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}"
    )
