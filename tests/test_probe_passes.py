"""Probe + on-device passes-loop semantics tests."""

import numpy as np

from openmp_parallel_computing_tpu import ops
from openmp_parallel_computing_tpu.probe import probe


def test_probe_reports_support():
    info = probe()
    assert info["compute"] == "supported"
    assert info["backend"] == "cpu"
    assert info["device_count"] == 8  # virtual CPU mesh


def test_probe_main_fails_without_gpu(capsys):
    """The command never reports the CPU as the accelerator."""
    from openmp_parallel_computing_tpu.probe import main

    assert main() == 1
    assert "no GPU attached" in capsys.readouterr().out


class TestPasses:
    def test_grayscale_passes_idempotent(self, small_rgb):
        once = np.asarray(ops.grayscale(small_rgb))
        many = np.asarray(ops.grayscale(small_rgb, passes=5))
        np.testing.assert_array_equal(once, many)

    def test_edge_passes_match_staged(self, small_rgb):
        # passes=2 == running the whole pipeline twice (the reference's
        # driver reruns all stages on the previous output)
        twice = np.asarray(ops.edge_pipeline(small_rgb, passes=2))
        staged = np.asarray(
            ops.edge_pipeline(np.asarray(ops.edge_pipeline(small_rgb))))
        np.testing.assert_array_equal(twice, staged)

    def test_blur_passes_match_staged(self, small_rgb):
        twice = np.asarray(ops.gaussian_blur(small_rgb, passes=2))
        staged = np.asarray(
            ops.gaussian_blur(np.asarray(ops.gaussian_blur(small_rgb))))
        np.testing.assert_array_equal(twice, staged)

    def test_grayscale_inplace_alias_correct(self, small_rgb):
        # Repeated passes over the loop carry must not corrupt results
        # (the in-place contract of the reference kernel).
        got = np.asarray(ops.grayscale(small_rgb.copy(), passes=3))
        want = np.asarray(ops.grayscale(small_rgb))
        np.testing.assert_array_equal(got, want)
