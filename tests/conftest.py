"""Test harness: the tests run on the CPU with 8 virtual devices, so the
sharding tests need no accelerator (SURVEY.md §4).

Tests marked `gpu` need an NVIDIA card and skip without one (the `gpu`
fixture decides). To run them on a card, name the platform:
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`; `chip_smoke.py` does
so in its own process. Any other setting runs on the CPU.
"""
import os
import sys

import jax
if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    # jax 0.9 ignores XLA_FLAGS=--xla_force_host_platform_device_count; the
    # supported mechanism is the jax_num_cpu_devices config (before backend
    # init).
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

# ---------------------------------------------------------------------------
# quick/slow tiers: `pytest -m quick` is the <~2 min CI-style gate covering
# units, one PT convergence gate, RMIS-oracle on one calibration, LVC
# equivalence, traversal-vs-brute, and one sharding test. The full suite
# (default, ~11 min CPU) adds the heavy convergence/equivalence renders.
# Anything listed here (exact nodeid or prefix) is marked slow; everything
# else is quick. New tests default to quick — add them here if they render.
# ---------------------------------------------------------------------------
_SLOW = [
    "tests/test_benchmark_app.py",  # 3 subprocess jax startups
    "tests/test_env_scene.py::test_env_spcbpt_matches_pt",
    "tests/test_env_scene.py::test_env_lit_floor",
    "tests/test_convergence.py::test_bdpt_convergence",
    "tests/test_convergence_interior.py::test_bdpt_interior_convergence",
    "tests/test_convergence_interior.py::test_spcbpt_trained_path_interior_convergence",
    "tests/test_units.py::test_bdpt_unit_invariant",
    "tests/test_units.py::test_lvc_weights_finite_in_raw_units",
    "tests/test_render.py::test_spcbpt_pool_matches_naive",
    "tests/test_render.py::test_bdpt_matches_pt_mean",
    "tests/test_render.py::test_spcbpt_trained_state_runs",
    "tests/test_render.py::test_light_trace_physicality",
    "tests/test_render.py::test_pt_frame_finite_and_lit",
    "tests/test_render.py::test_pt_pool_presort_matches_brute",
    "tests/test_render.py::test_pt_pool_matches_naive",
    "tests/test_viewer.py::test_scripted_session_renders_and_saves",
    # keep only the 'weighted' calibration quick: each calibration pays its
    # own ~12 s trained-state module fixture
    "tests/test_rmis_oracle.py::test_general_connection_matches_oracle[mixture",
    "tests/test_rmis_oracle.py::test_general_connection_matches_oracle[uniform",
    "tests/test_rmis_oracle.py::test_light_source_connection_matches_oracle[mixture",
    "tests/test_rmis_oracle.py::test_light_source_connection_matches_oracle[uniform",
    "tests/test_rmis_oracle.py::test_perturbed_rmis_cache_is_detected[mixture]",
    "tests/test_rmis_oracle.py::test_perturbed_rmis_cache_is_detected[uniform]",
    "tests/test_rmis_oracle.py::test_is_brdf_zeroes_weight[mixture]",
    "tests/test_rmis_oracle.py::test_is_brdf_zeroes_weight[uniform]",
    "tests/test_tile_trace.py::test_coherent_camera_rays_cornell",
    "tests/test_parallel.py::test_sharded_spcbpt_render_runs",
    "tests/test_parallel.py::test_sharded_pt_spp_axis_is_mean_of_streams",
    "tests/test_parallel.py::test_sharded_pt_equals_sequential_tiles",
    "tests/test_parallel.py::test_sharded_spcbpt_trained_equals_sequential_tiles",
    "tests/test_rmis_oracle.py::test_emitter_hit_matches_oracle[mixture",
    "tests/test_rmis_oracle.py::test_emitter_hit_matches_oracle[uniform",
    "tests/test_convergence_interior.py::test_pt_interior_convergence",
    "tests/test_nn_classifier.py::test_blended_first_stage_pmf_matches_histogram",
    "tests/test_tile_trace.py::test_closest_matches_brute[300",
    "tests/test_tile_trace.py::test_closest_matches_brute[1200",
    # the three slowest of the quick tier on the CPU (the sub_blocks
    # equivalence alone is most of it); the full suite still runs them
    "tests/test_parallel.py::test_sharded_spcbpt_sub_blocks_exact",
    "tests/test_parallel.py::test_dp_gamma_step_matches_single_device",
    "tests/test_nn_classifier.py::test_nn_state_checkpoint_roundtrip",
]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy render/equivalence test (excluded by -m quick)")
    config.addinivalue_line(
        "markers", "quick: fast tier, `pytest -m quick` (<~2 min on CPU)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips elsewhere")


def _read_png(path):
    """Decode an 8-bit RGB PNG of unfiltered scanlines (what
    utils.image.write_png writes) with zlib alone."""
    import struct
    import zlib
    import numpy as np
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body), tag
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture
def read_png():
    return _read_png


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (see the module docstring
    for how to run these tests on a card)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        nid = item.nodeid
        if any(nid == s or nid.startswith(s) for s in _SLOW):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)
