"""Timed multi-process KARTO FRONT-END rung.

The full online pipeline, the same mission run on (a) 1 process / 2
virtual CPU devices and (b) 2 processes / 2 devices each (`jax.distributed` + Gloo standing
in for DCN), wall per accepted scan + per-stage attribution from
`KartoSLAM.timer`. Correctness of the 2-process run vs single-device is
asserted inside the worker (tests/mp_karto_worker.py) before timing.

    python benchmarks/bench_mp_karto.py
"""

import os
import socket
import subprocess
import sys

_DIR = os.path.join(os.path.dirname(__file__), "..", "tests")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(nproc: int) -> list[str]:
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "mp_karto_worker.py"),
             str(i), str(nproc), str(port), "--timed"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=2400)
        outs.append(out)
        if p.returncode != 0:
            raise RuntimeError(out[-3000:])
    return outs


def main():
    for nproc in (1, 2):
        outs = run(nproc)
        for out in outs:
            for line in out.splitlines():
                if ("timed_karto" in line or "KARTO OK" in line
                        or "stage" in line or line.startswith("  ")):
                    print(f"[{nproc}p] {line}")


if __name__ == "__main__":
    main()
