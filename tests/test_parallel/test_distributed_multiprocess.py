"""REAL multi-process jax.distributed test (2 processes, gloo collectives).

tests/test_parallel/test_distributed.py exercises create_hybrid_mesh's
layout logic on a single process; this module goes the rest of the way:
two actual processes coordinate through jax.distributed, build the hybrid
mesh with the process boundary as the host axis, all-reduce a globally
sharded array, and run a sharded multistrain ensemble solve whose batch
axis spans both processes — the framework's multi-host claim executed,
not just compiled (SURVEY.md section 2.8 item 3).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_sharded_solve():
    port = _free_port()
    env = dict(os.environ)
    # each worker sets its own XLA_FLAGS/platform; scrub pytest's
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}\n{out[-3000:]}"
        assert "WORKER_OK" in out, f"worker {i} incomplete\n{out[-3000:]}"
