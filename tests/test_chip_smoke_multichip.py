"""chip_smoke.py --multichip on four virtual CPU devices: every mesh path
matches its single-device run (the card runs it on four GPUs)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def test_multichip_paths_match_single_device():
    res = chip_smoke.multichip(
        n_devices=4, laps=1, beams=128, ring_nodes=64, hector_scans=20,
        hector_map=256, warm_runs=0,
    )
    assert res["devices"] == 4
    assert len(res["checks"]) == 10
    failed = [c for c in res["checks"] if not c["ok"]]
    assert not failed, failed
