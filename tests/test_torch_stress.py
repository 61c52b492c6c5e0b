"""The sampling service's stress driver (``csrc/stress_test.cpp``) under
ThreadSanitizer and AddressSanitizer: several workers, cache routing,
emit ranges of all four partitions and of two, worker-gathered tails in
f32 and bf16, and shutdown with work in flight. Each binary is built by
``ops.build.build_stress`` with g++ and must exit 0, print ``STRESS OK``
and report nothing (LeakSanitizer included, under ASAN)."""

import subprocess

import pytest

from occ_gnn_tpu_torch.ops.build import build_stress

# Seconds a sanitized run may take (about 2 s here).
RUN_TIMEOUT_S = 120


@pytest.mark.parametrize("sanitizer", ["thread", "address"])
def test_stress_driver_runs_clean(sanitizer):
    binary = build_stress(sanitizer)
    proc = subprocess.run([str(binary)], capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "STRESS OK" in proc.stdout
    assert out.count("batches ok") == 3
    for report in ("ThreadSanitizer", "AddressSanitizer", "LeakSanitizer"):
        assert report not in out, out[-4000:]


def test_stress_build_refuses_other_sanitizers():
    with pytest.raises(ValueError, match="sanitizer"):
        build_stress("memory")
