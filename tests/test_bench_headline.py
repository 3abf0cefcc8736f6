"""bench.py's FINAL stdout line: a compact headline that names the device.

`_headline` stays far below a 2000-char tail window in both the success
and the worst-case error branch, and carries the fields the record
contract names: the metric, and the device as JAX and nvidia-smi report
it.  bench.py imports no jax at module level (workload metadata is read by
the parent process), so this test is pure host-side.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench

TAIL_WINDOW = 2000
MARGIN = 500  # room for driver-side prefixes/wrapping
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _full_record(flag):
    return {
        "metric": "1dtfim_n100_vmc_samples_per_sec",
        "value": flag.get("samples_per_sec", 0.0),
        "unit": "samples/s",
        "vs_baseline": 1.0,
        "device": DEVICE,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W" + " " * 500,
        "workloads": {"1dtfim_n100": flag, "extra": "x" * 5000},
    }


def test_headline_success_branch_fits_tail_window():
    flag = {"steps_per_sec": 80.0, "samples_per_sec": 40000.0}
    accuracy = {"steps_to_rtol": 100, "rel_error": 6.3e-4, "converged": True}
    h = bench._headline(_full_record(flag), flag, accuracy, 23)
    line = json.dumps(h)
    assert len(line) < TAIL_WINDOW - MARGIN, len(line)
    got = json.loads(line)
    for field in ("metric", "value", "vs_baseline", "device", "card",
                  "rows_measured", "accuracy_n20_minsr"):
        assert field in got, field
    assert got["value"] == 40000.0
    assert got["device"] == DEVICE
    for gone in ("mfu", "roof_frac", "stale_last_good_onchip"):
        assert gone not in got
    assert "workloads" not in got  # the giant dict must stay off this line


def test_headline_error_branch_caps_length():
    # worst case: flagship lost with a huge subprocess-tail error string,
    # accuracy probe failed with its own (already-capped) error
    flag = {"error": "timeout: " + "y" * 5000}
    accuracy = {"ok": False, "error": "z" * 200}
    h = bench._headline(_full_record(flag), flag, accuracy, 0)
    line = json.dumps(h)
    assert len(line) < TAIL_WINDOW - MARGIN, len(line)
    got = json.loads(line)
    assert len(got["error"]) <= 200
    assert got["value"] == 0.0
