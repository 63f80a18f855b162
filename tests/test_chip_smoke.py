"""chip_smoke.py on the CPU: the device check, the last-line contract and
each phase's comparison at a tiny size (the card runs them full size)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_check_fails_without_gpu():
    """A CPU-only process exits non-zero at the device check and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no GPU" in out.stderr
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu()


def test_result_line_has_exactly_the_contract_keys():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


TINY = {
    "plicp": (chip_smoke.phase_plicp,
              dict(n_pairs=6, beams=180, warm_runs=1)),
    "solver": (chip_smoke.phase_solver,
               dict(ring_nodes=64, big_nodes=3000, warm_runs=0)),
    "karto_offline": (chip_smoke.phase_karto_offline,
                      dict(laps=1, beams=128, arm=6.0, width=2.2,
                           warm_runs=0)),
    "karto_online": (chip_smoke.phase_karto_online,
                     dict(laps=1, beams=128, warm_runs=0)),
    "hector": (chip_smoke.phase_hector,
               dict(n_scans=30, map_size=256, warm_runs=0)),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_passes_at_tiny_size(phase):
    fn, kwargs = TINY[phase]
    res = fn(**kwargs)
    assert res["checks"], res
    failed = [c for c in res["checks"] if not c["ok"]]
    assert not failed, failed
    assert np.isfinite(res["cold_s"])


def test_phases_cover_the_main_path():
    names = [fn.__name__ for fn in chip_smoke.PHASES]
    assert names == ["phase_" + p for p in (
        "plicp", "solver", "karto_offline", "karto_online", "hector")]


@pytest.mark.gpu
@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_passes_at_full_size_on_gpu(gpu, phase):
    """The card's own run of each phase at chip_smoke.py's sizes."""
    fn, _ = TINY[phase]
    res = fn()
    failed = [c for c in res["checks"] if not c["ok"]]
    assert not failed, failed
