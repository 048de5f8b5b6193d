"""Test configuration: CPU backend, float64, 8 virtual devices.

The virtual 8-device CPU mesh is the standard JAX substitute for testing
multi-chip sharding without a multi-GPU host (SURVEY.md section 4).  The
platform is forced to cpu via jax.config before any backend is
initialized, so the suite runs on the CPU also on a machine with a GPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Test tiering: end-to-end solves (channel benchmarks, refinement passes,
# multichip dryruns) are marked ``slow`` here so the default development
# loop is ``pytest -m "not slow"`` (< 3 min); the full suite runs nightly /
# before release commits.  The tier policy lives in this one list so
# re-tiering is a one-line change.
# ---------------------------------------------------------------------------
SLOW_TESTS = {
    "test_navier_stokes_3d",
    "test_refined_mcs_solve_initial",
    "test_refinement_matches_f64_stokes_solve",
    "test_graft_entry_multichip",
    "test_graft_entry_single_chip",
    "test_ns_hdg3d_smoke",
    "test_reynolds_ensemble_sharded",
    "test_viscosity_step_matches_do_time_step",
    "test_auxspace_beats_plain_blocks",
    "test_hdg3d_poiseuille_exact_direct",
    "test_hdg3d_bpcg_solves",
    "test_mcs_ns_poiseuille_exact",
    "test_mcs_ns_time_stepping",
    "test_mcs_minres_matches_direct",
    "test_two_level_beats_jacobi_and_is_h_robust",
    "test_heat_exponential_integrator_convergence",
    "test_curved_stokes_solves",
    # 3D MCS end-to-end (round 2)
    "test_mcs_ns_3d_poiseuille_exact",
    "test_mcs_ns_3d_channel_steady",
    "test_mcs_ns_3d_time_stepping",
    "test_mcs_ns_gauss_seidel_reduces_iterations",
    "test_curved_piola_channel_solves",
    "test_curved_mcs_channel_solves",
    # round 3: 3D sharded flagship + MCS viscosity ensemble
    "test_sharded_flagship_3d_matches_single_device",
    "test_sharded_flagship_matches_single_device",
    "test_mcs_viscosity_step_matches_do_time_step",
    "test_mcs_reynolds_ensemble_sharded",
    "test_mcs_nu_split_tables_exact",
    "test_phase2_correction_solve",
    "test_skeleton_fast_matches_slow",
    # round 3: 3D curved geometry
    "test_curved3d_affine_consistency",
    "test_curved3d_mcs_channel_solves",
    # round 4: face-sharded production fast path
    "test_faceshard_operators_match_single_device",
    "test_faceshard_solve_matches_single_device",
    # round 5: sharded solve to the production tolerance
    "test_faceshard_solve_reaches_production_tolerance",
    # round 4: iteration-count regression guard
    "test_bench_iteration_count_guard",
    # round 4: device-derived preconditioner tables (full-solve A/B)
    "test_device_tables_iteration_parity",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
