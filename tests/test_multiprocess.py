"""True multi-process validation (SURVEY §4: "multi-host tests using
jax.distributed-style local multi-process simulation").

Spawns 2 separate Python processes, each owning 2 virtual CPU devices,
joined into one 4-device cluster via jax.distributed; the edge-sharded
LM delta runs over the cross-process mesh (Gloo collectives standing in
for DCN) and must match the locally computed single-device solve. This
exercises the real multi-host runtime path — process coordination, global
arrays from per-process shards, cross-process all-reduce — that the
single-process 8-device tests cannot.
"""

import os
import socket
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(900)
@pytest.mark.slow
def test_two_process_karto_mission():
    """The FULL KartoSLAM pipeline across 2 OS processes (mesh-sharded
    ring loop search + distributed LM back-end) must reproduce the
    single-device mission — the multi-host front-end of SURVEY §5."""
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "mp_karto_worker.py"),
             str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=850)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {i} failed (rc {p.returncode}):\n{out[-3000:]}"
        )
        assert f"proc {i}: KARTO OK" in out


@pytest.mark.timeout(300)
@pytest.mark.slow
def test_two_process_distributed_lm():
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "mp_worker.py"),
             str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {i} failed (rc {p.returncode}):\n{out[-3000:]}"
        )
        assert f"proc {i}: OK" in out
