"""PyTorch port: every JAX test suite has its twin, checkably.

`TWINS` gives, for every `tests/test_*.py` of the JAX package, the
`tests/test_torch_*.py` files that hold the same drills against the port,
or the one-line reason why no port file can. `DRILLS` maps, for the
suites twinned last, each JAX test function to the port test function
that runs it on both packages, or to an earlier port test that already
held it. The tests parse the files with `ast` and fail when a JAX suite
or one of those JAX drills has no entry, when an entry names a JAX file
or function that is gone, or when a named port file or function does not
exist. Every twinned suite is mapped drill by drill, and every named
port test must also reach JAX's side in its own function (`_reaches_jax`:
through `torch_twin`'s `JAX`, `PKGS` or `twin`, an import of `pmdfc_tpu`
or of a JAX test module (its drill helpers), a `pmdfc_tpu.*` module named
for a child process, or a helper of the file that does), or stand in
`EXEMPT` with its reason. They read no benchmark file.
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)

pytestmark = pytest.mark.torch

TESTS = Path(__file__).resolve().parent

TWINS = {
    "test_admit.py": ("test_torch_tier.py", "test_torch_env_switches.py",
                      "test_torch_admit_drills.py"),
    "test_analyze.py": ("test_torch_analyze.py",
                        "test_torch_analyze_drills.py",
                        "test_torch_sanitizer_drills.py"),
    "test_autotune.py": ("test_torch_autotune.py",
                         "test_torch_autotune_drills.py"),
    "test_aux.py": ("test_torch_policy_cache.py", "test_torch_logger.py",
                    "test_torch_checkpoint.py", "test_torch_server.py",
                    "test_torch_aux_drills.py"),
    "test_bench_cert.py": "certifies the TPU history rows of the frozen "
                          "`bench.py` (BENCH_HISTORY.jsonl, BENCH_TPU_CERT."
                          "json); the port has no TPU history to certify",
    "test_bf_push.py": ("test_torch_bf_push.py", "test_torch_client.py"),
    "test_bloom.py": ("test_torch_pool_bloom.py", "test_torch_client.py",
                      "test_torch_bloom_drills.py"),
    "test_cceh.py": ("test_torch_cceh.py", "test_torch_cceh_drills.py"),
    "test_chaos.py": ("test_torch_chaos.py", "test_torch_chaos_drills.py"),
    "test_client.py": ("test_torch_client.py", "test_torch_client_drills.py",
                       "test_torch_workloads.py"),
    "test_containment.py": ("test_torch_containment.py",
                            "test_torch_bench_faults.py"),
    "test_durability.py": ("test_torch_checkpoint.py",
                           "test_torch_journal.py",
                           "test_torch_durability_drills.py"),
    "test_elastic.py": ("test_torch_ring.py", "test_torch_replica.py",
                        "test_torch_replica_rejoin.py",
                        "test_torch_bench_elastic.py",
                        "test_torch_elastic_drills.py"),
    "test_failure.py": ("test_torch_failure.py",
                        "test_torch_failure_ladder.py"),
    "test_fastpath.py": ("test_torch_fastpath.py", "test_torch_kv_surface.py",
                         "test_torch_net.py"),
    "test_fused.py": ("test_torch_fused.py", "test_torch_fused_drills.py"),
    "test_hashing.py": ("test_torch_hashing.py",
                        "test_torch_hashing_drills.py"),
    "test_hotring.py": ("test_torch_hotring.py",
                        "test_torch_hotring_drills.py"),
    "test_index_conformance.py": ("test_torch_conformance.py",
                                  "test_torch_index_conformance_drills.py",
                                  "test_torch_index_conformance_kv_drills.py",
                                  "test_torch_families.py",
                                  "test_torch_kv_family_paths.py",
                                  "test_torch_kv_family_paths_path.py",
                                  "test_torch_kv_family_paths_tiered.py",
                                  "test_torch_kv_family_paths_unpaged.py"),
    "test_insert_compaction.py": ("test_torch_insert_compaction.py",
                                  "test_torch_insert_fresh_slots.py"),
    "test_jax_pin.py": "pins the JAX and jaxlib versions the compile-cache "
                       "hardening of `pmdfc_tpu/bench/common.py` was "
                       "verified on; the port uses no JAX",
    "test_kv.py": ("test_torch_kv.py", "test_torch_extents.py",
                   "test_torch_kv_families.py", "test_torch_kv_drills.py"),
    "test_linear.py": ("test_torch_linear.py", "test_torch_linear_drills.py",
                       "test_torch_rowinsert.py"),
    "test_mesh.py": ("test_torch_plane.py", "test_torch_shard.py",
                     "test_torch_partitioning.py",
                     "test_torch_mesh_drills.py", "test_torch_mesh_ckpt.py"),
    "test_mesh2d.py": ("test_torch_mesh2d.py",
                       "test_torch_mesh2d_drills.py"),
    "test_multihost.py": ("test_torch_multihost.py",
                          "test_torch_multihost_plane.py",
                          "test_torch_multihost_drills.py"),
    "test_net.py": ("test_torch_net.py", "test_torch_net_drills.py",
                    "test_torch_net_pipes.py", "test_torch_failure.py"),
    "test_onesided.py": ("test_torch_onesided.py", "test_torch_net.py"),
    "test_pressure.py": ("test_torch_workloads.py",
                         "test_torch_bench_sweeps.py",
                         "test_torch_pressure_drills.py"),
    "test_profiler.py": ("test_torch_profiler.py",),
    "test_qos.py": ("test_torch_qos.py", "test_torch_qos_drills.py"),
    "test_replica.py": ("test_torch_replica.py",
                        "test_torch_replica_rejoin.py",
                        "test_torch_bench_replica.py",
                        "test_torch_replica_drills.py"),
    "test_runtime.py": ("test_torch_engine.py", "test_torch_server.py",
                        "test_torch_runtime_drills.py"),
    "test_shard.py": ("test_torch_shard.py", "test_torch_mesh_ckpt.py",
                      "test_torch_shard_drills.py",
                      "test_torch_partitioning.py"),
    "test_soak.py": ("test_torch_bench_soaks.py",
                     "test_torch_bench_sweeps.py",
                     "test_torch_harnesses.py",
                     "test_torch_soak_drills.py"),
    "test_telemetry.py": ("test_torch_telemetry.py", "test_torch_teletop.py",
                          "test_torch_telemetry_drills.py"),
    "test_tier.py": ("test_torch_tier.py", "test_torch_env_switches.py",
                     "test_torch_tier_drills.py"),
    "test_tracing.py": ("test_torch_tracing.py",),
    "test_xray.py": ("test_torch_xray.py", "test_torch_xray_drills.py"),
}

_FP = "test_torch_fastpath.py::"
_NET = "test_torch_net.py::"
_SURF = "test_torch_kv_surface.py::"
_BF = "test_torch_bf_push.py::"
_CLIENT = "test_torch_client.py::"
_INS = "test_torch_insert_compaction.py::"
_ONE = "test_torch_onesided.py::"
_LAD = "test_torch_failure_ladder.py::"
_ND = "test_torch_net_drills.py::"
_NP = "test_torch_net_pipes.py::"
_SH = "test_torch_shard.py::"
_SHD = "test_torch_shard_drills.py::"
_LIN = "test_torch_linear.py::"
_KVD = "test_torch_kv_drills.py::"
_TD = "test_torch_tier_drills.py::"
_TIER = "test_torch_tier.py::"
_ENV = "test_torch_env_switches.py::"
_BD = "test_torch_bloom_drills.py::"
_M2 = "test_torch_mesh2d_drills.py::"
_ED = "test_torch_elastic_drills.py::"
_AD = "test_torch_analyze_drills.py::"
_SAN = "test_torch_sanitizer_drills.py::"
_ATD = "test_torch_autotune_drills.py::"
_AT = "test_torch_autotune.py::"
_WALK = (_AT + "test_controllers_walk_identically",)
_TLD = "test_torch_telemetry_drills.py::"
_FD = "test_torch_fused_drills.py::"
_TF = "test_torch_fused.py::"
_HD = "test_torch_hashing_drills.py::"
_CD = "test_torch_cceh_drills.py::"
_HR = "test_torch_hotring.py::"
_HRD = "test_torch_hotring_drills.py::"
_ICD = "test_torch_index_conformance_drills.py::"
_ICK = "test_torch_index_conformance_kv_drills.py::"
_ADM = "test_torch_admit_drills.py::"
_MD = "test_torch_mesh_drills.py::"
_MCK = "test_torch_mesh_ckpt.py::"
_JR = "test_torch_journal.py::"
_CK = "test_torch_checkpoint.py::"
_DD = "test_torch_durability_drills.py::"
_RING = ("test_torch_ring.py::test_ring_matches_jax",)
_HERMETIC = ("test_torch_replica.py::test_hermetic_drill_matches_jax",)
_VERBS = (_SH + "test_sharded_verbs_match_jax",)
_LINOPS = (_LIN + "test_linear_ops_match_jax",)
_QOS = "test_torch_qos.py::"
_QOSD = "test_torch_qos_drills.py::"
_XR = "test_torch_xray.py::"
_XRD = "test_torch_xray_drills.py::"
_CH = "test_torch_chaos.py::"
_CHD = "test_torch_chaos_drills.py::"
_CO = "test_torch_containment.py::"
_TR = "test_torch_tracing.py::"
_SPANS = (_TR + "test_span_semantics_match_jax",)
_CLD = "test_torch_client_drills.py::"
_RTD = "test_torch_runtime_drills.py::"
_PRD = "test_torch_pressure_drills.py::"
_RPD = "test_torch_replica_drills.py::"
_AXD = "test_torch_aux_drills.py::"
_PC = "test_torch_policy_cache.py::"
_PF = "test_torch_profiler.py::"

DRILLS = {
    "test_fastpath.py": {
        "test_directory_snapshot_matches_live_state":
            (_SURF + "test_kv_surface_matches_jax",),
        "test_epoch_bumps_on_structural_invalidation":
            (_FP + "test_epoch_bumps_on_structural_invalidation",),
        "test_unpaged_config_has_no_fast_surface":
            (_SURF + "test_unpaged_kv_has_no_fast_surface_and_live_entries_"
                     "match", _FP + "test_unpaged_server_acks_no_fast_lane"),
        "test_fastread_end_to_end_bit_identical":
            (_NET + "test_wire_transcript_matches_jax",),
        "test_teledump_pins_fastpath_invariant":
            (_FP + "test_teledump_pins_fastpath_invariant",),
        "test_reput_stales_entry_delete_bumps_epoch":
            (_NET + "test_wire_transcript_matches_jax",),
        "test_dir_delta_upserts_and_tombstones":
            (_FP + "test_dir_delta_upserts_and_tombstones",),
        "test_fastpath_off_is_verb_for_verb_identical":
            (_NET + "test_wire_transcript_matches_jax",),
        "test_tier_promotion_vacates_directory_rows":
            (_FP + "test_tier_promotion_vacates_directory_rows",),
        "test_balloon_shrink_drill_zero_wrong_bytes":
            (_FP + "test_balloon_shrink_drill_zero_wrong_bytes",),
        "test_reshard_4_to_2_drill_zero_wrong_bytes":
            (_FP + "test_reshard_4_to_2_drill_zero_wrong_bytes",),
        "test_chaos_fastpath_soak_no_wrong_bytes":
            (_FP + "test_chaos_fastpath_soak_no_wrong_bytes",),
        "test_cleancache_close_joins_refresher_and_dir_refresh":
            (_FP + "test_cleancache_close_joins_refresher_and_dir_refresh",),
        "test_pool_server_stats_parity":
            (_NET + "test_pool_server_matches_jax_host_pool",),
        "test_replica_group_prefers_fastpath_over_hedging":
            (_FP + "test_replica_group_prefers_fastpath_over_hedging",),
        "test_fastpath_under_concurrent_writers":
            (_SURF + "test_fast_reads_under_concurrent_rewrites_never_tear",
             _SURF + "test_put_landing_between_check_and_gather_cannot_"
                     "serve_wrong_bytes"),
    },
    "test_bf_push.py": {
        "test_first_push_is_full_then_deltas":
            (_CLIENT + "test_first_push_is_full_then_deltas",),
        "test_delta_push_reflects_deletes":
            (_BF + "test_delta_push_reflects_deletes",),
        "test_no_false_negative_when_push_races_put":
            (_CLIENT + "test_no_false_negative_when_push_races_put",),
        "test_stale_snapshot_delivery_rejected":
            (_BF + "test_stale_snapshot_delivery_rejected",),
        "test_push_error_does_not_kill_other_clients":
            (_BF + "test_push_error_does_not_kill_other_clients",),
        "test_pushed_client_stops_pulling":
            (_BF + "test_pushed_client_stops_pulling",),
        "test_concurrent_put_storm_under_push_never_false_negative":
            (_CLIENT + "test_put_storm_under_the_push_thread_never_false_"
                       "negative",),
    },
    "test_insert_compaction.py": {
        "test_narrow_rounds_place_everything_at_fill":
            (_INS + "test_narrow_rounds_place_everything_at_fill",),
        "test_overflow_fallback_keeps_accounting":
            (_INS + "test_overflow_fallback_keeps_accounting",),
        "test_level_narrow_bottom_tail_exact":
            (_INS + "test_level_narrow_bottom_tail_exact",),
        "test_eviction_free_batches_keep_every_fresh_slot":
            ("test_torch_insert_fresh_slots.py::"
             "test_eviction_free_batches_keep_every_fresh_slot",),
    },
    "test_onesided.py": {
        "test_roundtrip_content": (_ONE + "test_roundtrip_content",),
        "test_overwrite_reuses_row":
            (_NET + "test_pool_server_matches_jax_host_pool",),
        "test_invalidate_frees_rows":
            (_NET + "test_pool_server_matches_jax_host_pool",),
        "test_grant_exhaustion_drops_oldest":
            (_NET + "test_pool_server_matches_jax_host_pool",),
        "test_duplicate_keys_in_batch_last_wins":
            (_ONE + "test_duplicate_keys_in_batch_last_wins",),
        "test_client_map_loss_is_legal_miss":
            (_ONE + "test_client_map_loss_is_legal_miss",),
        "test_multi_client_isolation":
            (_ONE + "test_multi_client_isolation",),
        "test_pool_persistence_across_restart":
            (_ONE + "test_pool_persistence_across_restart",),
        "test_cleancache_client_rides_onesided":
            (_ONE + "test_cleancache_client_rides_onesided",),
        "test_storm_content_verified": (_ONE + "test_storm_content_verified",),
        "test_remote_pool_grant_and_verbs":
            (_NET + "test_pool_server_matches_jax_host_pool",),
        "test_onesided_client_stack_over_network":
            (_ONE + "test_onesided_client_stack_over_network",),
        "test_remote_pool_grant_exhaustion_refused":
            (_ONE + "test_remote_pool_grant_exhaustion_refused",),
    },
    "test_failure.py": {
        name: (_LAD + name,) for name in (
            "test_restart_with_checkpoint_restore_and_reconnect",
            "test_restart_under_load_never_serves_wrong_data",
            "test_dropped_completions_timeout_then_recover",
            "test_stalled_driver_backpressure_is_bounded_loss",
            "test_put_first_after_kill_degrades_not_raises",
            "test_invalidation_journal_blocks_stale_resurrection",
            "test_paging_sim_survives_restart",
            "test_torn_checkpoint_detected_and_rejected",
            "test_kill_restore_falls_back_past_torn_snapshot",
            "test_reconnect_backoff_widens_and_resets")},
    "test_net.py": {
        **{name: (_ND + name,) for name in (
            "test_client_bounds_oversized_server_frame",
            "test_handshake_word_mismatch_rejected",
            "test_cleancache_client_over_tcp",
            "test_bf_push_full_then_delta",
            "test_push_race_no_false_negative",
            "test_idle_timeout_kills_and_keepalive_survives",
            "test_reconnecting_client_over_tcp_restart",
            "test_multiprocess_clients",
            "test_server_survives_garbage_and_truncation",
            "test_engine_backend_factory_over_tcp",
            "test_pull_then_push_stamp_domains_coherent",
            "test_stale_delta_or_merges_instead_of_dropping",
            "test_kill_op_conn_is_idempotent")},
        **{name: (_NP + name,) for name in (
            "test_multinode_harness_small",
            "test_tcp_over_sharded_mesh_server",
            "test_pipeline_negotiation_and_env_killswitch",
            "test_coalesced_server_fuses_across_connections",
            "test_pipelined_storm_shared_backend",
            "test_coalesced_vs_lockstep_conformance",
            "test_chaos_duplicate_frame_desync_is_detected",
            "test_chaos_truncated_frame_and_half_open_are_bounded")},
        "test_chaos_bitflip_is_dropped_frame_then_reconnect":
            (_NP + "test_chaos_bitflip_is_dropped_frame_then_reconnect",
             "test_torch_failure.py::test_chaos_proxy_delay_and_drop"),
        "test_roundtrip_put_get_invalidate":
            (_NET + "test_wire_transcript_matches_jax",),
        "test_extent_verbs_over_tcp":
            (_NET + "test_wire_transcript_matches_jax",),
    },
    "test_shard.py": {
        "test_shard_routing_balanced":
            ("test_torch_partitioning.py::"
             "test_shard_owners_equal_the_jax_hash",),
        "test_insert_get_roundtrip": _VERBS,
        "test_miss_is_legal": _VERBS,
        "test_delete": _VERBS,
        "test_matches_single_chip_ground_truth": _VERBS,
        "test_dup_keys_last_wins_matches":
            (_SH + "test_dup_keys_last_wins_across_shards",),
        "test_a2a_find_anyway_utilization_recovery": _VERBS,
        "test_packed_bloom_matches_single_chip": _VERBS,
        "test_sharded_checkpoint_roundtrip":
            ("test_torch_mesh_ckpt.py::"
             "test_sharded_snapshots_and_chains_cross_both_ways",),
        "test_a2a_bucket_overflow_is_reported_not_silent":
            (_SH + "test_a2a_bucket_overflow_is_reported_like_jax",),
        "test_extent_cross_shard": _VERBS,
        "test_extent_matches_single_chip": _VERBS,
        "test_paged_mode_sharded":
            (_SHD + "test_paged_mode_sharded_matches_jax",),
        "test_eviction_propagates":
            (_SHD + "test_eviction_propagates_like_jax",),
        "test_sharded_cceh_roundtrip": _VERBS,
        "test_cleancache_client_over_sharded_server":
            (_SHD + "test_cleancache_client_over_sharded_server_like_jax",),
        "test_node_of_and_shard_report":
            (_SHD + "test_node_of_and_shard_report_like_jax",),
        "test_lrfu_stats_plane":
            (_SH + "test_lrfu_plane_and_node_of_match_jax",),
        "test_sampled_touch_sharded":
            (_SHD + "test_sampled_touch_sharded_like_jax",),
        "test_health_and_shard_report_tier_stats_agree":
            (_SHD + "test_health_and_shard_report_tier_stats_agree_like_jax",),
    },
    "test_linear.py": {
        "test_insert_then_get_roundtrip": _LINOPS,
        "test_miss_is_legal_answer": _LINOPS,
        "test_padding_keys_are_noops": _LINOPS,
        "test_update_in_place_overwrites_value": _LINOPS,
        "test_duplicate_keys_in_batch_last_wins":
            (_LIN + "test_dedupe_last_wins_matches_jax",) + _LINOPS,
        "test_fifo_eviction_on_full_cluster":
            (_LIN + "test_overflowing_batch_drops_and_evicts_like_jax",),
        "test_overflow_within_one_batch_drops_excess":
            (_LIN + "test_overflowing_batch_drops_and_evicts_like_jax",),
        "test_delete_then_miss": _LINOPS,
        "test_large_random_workload_no_false_hits":
            ("test_torch_linear_drills.py::"
             "test_large_random_workload_no_false_hits_like_jax",),
        "test_plan_insert_matches_legacy_helpers":
            (_LIN + "test_plan_insert_and_rank_match_jax",),
        "test_rowscatter_insert_equivalence":
            ("test_torch_rowinsert.py::test_row_path_matches_jax_row_path",),
        "test_insert_path_env_switch":
            ("test_torch_rowinsert.py::test_insert_path_env_switch",),
    },
    "test_kv.py": {name: (_KVD + name,) for name in (
        "test_insert_then_get_roundtrip",
        "test_miss_is_legal",
        "test_paged_roundtrip",
        "test_update_in_place",
        "test_eviction_propagates_to_bloom",
        "test_delete",
        "test_extent_roundtrip",
        "test_extent_cover_count_is_logarithmic",
        "test_key_with_all_ones_hi_word_survives_padding",
        "test_large_extent_reachable",
        "test_extent_truncation_reported",
        "test_find_anyway_and_utilization",
        "test_stats_counts",
        "test_paged_pool_rows_recycled_under_eviction",
        "test_paged_delete_frees_rows",
        "test_fill_sweep_point_conformance",
        "test_corrupt_page_degrades_to_miss_never_wrong_bytes",
        "test_corrupt_page_miss_on_compact_path",
        "test_update_refreshes_digest_and_delete_clears_row",
        "test_integrity_backend_stale_overwrite_degrades_to_miss")},
    "test_tier.py": {
        **{name: (_ENV + name,) for name in (
            "test_tier_off_env_is_flat",
            "test_tier_on_env_default",
            "test_tier_off_bit_identical_conformance")},
        **{name: (_TD + name,) for name in (
            "test_get_compact_tiered_serves_hits_front",
            "test_tier_sampled_touch_cadence",
            "test_tier_stats_surface_in_print_stats",
            "test_sharded_tier_counters_in_shard_report",
            "test_passive_pool_tiered_mode",
            "test_tier_stats_over_the_wire",
            "test_checkpoint_roundtrip_tiered")},
        "test_promotion_preserves_bytes_and_digests":
            (_TD + "test_promotion_preserves_bytes_and_digests",
             _TIER + "test_promotion_preserves_bytes_and_digests"),
        "test_demotion_and_ghost_readmission":
            (_TD + "test_demotion_and_ghost_readmission",
             _TIER + "test_demotion_and_ghost_readmission"),
        "test_balloon_grow_covers_fill_burst":
            (_TD + "test_balloon_grow_covers_fill_burst",
             _TIER + "test_balloon_grow_covers_fill_burst"),
        "test_balloon_shrink_under_load_degrades_to_misses":
            (_TD + "test_balloon_shrink_under_load_degrades_to_misses",
             _TIER + "test_forced_shrink_under_load_degrades_to_misses"),
        "test_stale_entries_never_alias_recirculated_rows":
            (_TD + "test_stale_entries_never_alias_recirculated_rows",
             _TIER + "test_stale_entries_never_alias_recirculated_rows"),
        "test_delete_frees_hot_row":
            (_TD + "test_delete_frees_hot_row",
             _TIER + "test_delete_frees_hot_row"),
        "test_update_in_place_of_hot_resident_key":
            (_TD + "test_update_in_place_of_hot_resident_key",
             _TIER + "test_update_in_place_of_hot_resident_key"),
    },
    "test_bloom.py": {
        **{name: (_BD + name,) for name in (
            "test_insert_query_no_false_negatives",
            "test_absent_mostly_rejected",
            "test_delete_removes",
            "test_duplicate_inserts_accumulate",
            "test_packed_matches_counters")},
        "test_dirty_blocks":
            (_BD + "test_dirty_blocks",
             _CLIENT + "test_dirty_blocks_matches_jax"),
    },
    "test_mesh2d.py": {
        **{name: (_M2 + name,) for name in (
            "test_mesh2d_rules_and_replicated_markers",
            "test_mesh2d_construction_gates",
            "test_mesh2d_hedged_read_routes_around_corrupt_lane")},
        # the ten `slow` drills, each with its card counterpart
        **{name: (_M2 + name,) for name in (
            # phase 10's 2 x 2 plane: every verb byte-exact, stats and
            # shard rows reconciled
            "test_mesh2d_matches_single_device_results",
            # phase 18 (c): an unpaged 2 x 2 plane's values, repair 0
            "test_mesh2d_unpaged_plane_serves_values",
            # phase 18 (c): MSG_RREPAIR after the mid-soak corruption
            "test_mesh2d_repair_is_attributed_per_lane",
            # phase 18 (c): the plane warmed before its fill
            "test_mesh2d_warmup_counts_nothing",
            # phase 18 (c): the PMDFC_MESH2D=off transcript
            "test_mesh2d_off_kill_switch_is_conformant",
            # phase 18 (c): the storm with lane 1 corrupted mid-soak
            "test_mesh2d_wire_soak_corrupt_lane_mid_flight",
            # phase 18 (c): the fused group (one put a key)
            "test_mesh2d_group_delegates_fanout_to_fused_plane",
            # phase 18 (c): the fused_plane=False group
            "test_mesh2d_group_fused_plane_off_keeps_host_loops",
            # phase 18 (c): the group connected under PMDFC_MESH2D=off
            "test_mesh2d_off_group_keeps_host_fanout",
            # phase 18 (c): the fused group's device repair on tick 2
            "test_mesh2d_group_device_repair_rides_repair_cadence")},
    },
    "test_elastic.py": {
        **{name: (_ED + name,) + _RING for name in (
            "test_ring_owner_identity_batch_vs_scalar",
            "test_ring_epoch_monotonic_and_immutable",
            "test_ring_stability_measured_join_and_leave")},
        "test_token_bucket_rate_bound":
            (_ED + "test_token_bucket_rate_bound",
             "test_torch_ring.py::test_token_bucket_matches_jax_on_one_clock"),
        **{name: _HERMETIC for name in (
            "test_grow_migrates_owed_keys_and_dual_read_serves",
            "test_shrink_retires_slot_after_drain",
            "test_replace_endpoint_quarantines_and_migrates",
            "test_miss_routed_attribution_mid_move",
            "test_invalidate_survives_ownership_round_trip",
            "test_repair_journal_drops_moved_keys",
            "test_close_parity_joins_repair_thread",
            "test_membership_lost_claim_retires_registered_spare")},
        **{name: (_ED + name,) for name in (
            "test_breaker_force_open_semantics",
            "test_breaker_down_for_latch",
            "test_ring_note_bumps_directory_epoch_and_handoff_counts")},
        "test_ring_off_conformance":
            (_ED + "test_ring_off_conformance",
             "test_torch_replica.py::test_ring_off_conformance_matches_jax"),
        # slow: phase 18 (d), three card-backed nodes, node 1 killed
        "test_breaker_driven_auto_replacement":
            (_ED + "test_breaker_driven_auto_replacement",),
        # slow: phase 13's elastic_sweep (3 -> 5 -> 2 on the card)
        "test_elastic_chaos_scale_3_5_2_mid_soak":
            (_ED + "test_elastic_chaos_scale_3_5_2_mid_soak",),
    },
    "test_analyze.py": {
        **{name: (_AD + name,) for name in (
            "test_tree_is_clean_under_checked_in_allowlist",
            "test_lock_hierarchy_covers_every_ranked_module_lock",
            "test_unranked_serving_lock_is_a_finding",
            "test_unranked_slo_lock_is_a_finding",
            "test_bad_inversion_fixture_yields_lock_order_cycle",
            "test_bad_unguarded_fixture_yields_guarded_write",
            "test_bad_donation_fixture_yields_jax_donation",
            "test_bad_shardmap_donation_fixture_yields_jax_donation",
            "test_bad_pallas_gate_fixture_yields_finding",
            "test_interpret_false_literal_is_still_unconditional",
            "test_bad_profiler_seam_fixture_yields_findings",
            "test_profiler_seam_exempts_bench_and_the_seam_itself",
            "test_clean_fixtures_pass",
            "test_local_donate_spoof_does_not_count_as_guard",
            "test_allowlist_suppresses_and_reports_stale",
            "test_lambda_body_does_not_fabricate_lock_order_edges",
            "test_lexical_self_reacquire_is_flagged",
            "test_none_guard_with_justification_declares_no_fields",
            "test_wire_drift_rule_catches_constant_divergence")},
        **{name: (_SAN + name,) for name in (
            "test_sanitizer_off_returns_plain_primitives",
            "test_sanitizer_detects_ab_ba_inversion",
            "test_sanitizer_refuses_self_deadlock",
            "test_sanitizer_rlock_reentry_is_legal",
            "test_sanitizer_times_long_holds_on_watched_locks",
            "test_sanitizer_condition_wait_does_not_count_as_holding",
            "test_sanitizer_condition_is_reentrant_like_the_primitive",
            "test_sanitizer_nonblocking_self_probe_returns_false",
            "test_sanitizer_flush_runs_after_the_physical_release",
            "test_sanitizer_violations_reach_telemetry")},
        # slow: phase 19 (a), the soak on the card under PMDFC_SAN=on
        "test_chaos_soak_under_sanitizer_reports_nothing":
            (_SAN + "test_chaos_soak_under_sanitizer_reports_nothing",),
    },
    "test_autotune.py": {
        "test_config_validation": (_AT + "test_config_validation_matches_jax",),
        "test_kill_switch_off_is_inert":
            (_AT + "test_kill_switch_leaves_both_inert",),
        # scenario "light"
        "test_dwell_walks_down_under_light_load": _WALK,
        # scenario "fanin"
        "test_window_and_dwell_walk_up_under_fan_in": _WALK,
        # scenario "starvation"
        "test_starvation_reverts_once_then_holds": _WALK,
        # scenario "balloon-pressure"
        "test_balloon_steps_are_clamped_to_envelope": _WALK,
        # scenario "balloon-saturated"
        "test_balloon_offset_advances_only_on_observed_movement": _WALK,
        "test_breach_freezes_reverts_and_dumps":
            (_ATD + "test_breach_freezes_reverts_and_dumps",
             _AT + "test_breach_freezes_and_reverts_identically"),
        **{name: (_ATD + name,) for name in (
            "test_hedge_tracks_wire_p99",
            "test_migrate_rate_live_and_static_conformance",
            "test_unbounded_migrate_rate_gets_no_knob",
            "test_envelope_widens_to_contain_static_point",
            "test_bind_unconnected_reconnecting_client_assumes_default",
            "test_disabled_hedging_gets_no_knob",
            "test_provisional_window_lkg_adopts_first_real_sighting",
            "test_controller_move_never_adopted_as_lkg_sighting",
            "test_clock_stepback_keeps_loop_alive",
            "test_wedged_flush_window_keeps_up_streak_and_is_not_starvation",
            "test_hysteresis_requires_consecutive_windows",
            "test_kv_balloon_state_surface",
            "test_window_gate_semantics",
            "test_tcp_set_window_live_mid_traffic",
            "test_reconnecting_client_window_survives_reconnect",
            "test_check_autotune_pins")},
    },
    "test_telemetry.py": {name: (_TLD + name,) for name in (
        "test_scope_counters_and_mapping_reads",
        "test_scope_instances_never_share_counters",
        "test_shared_scope_with_seed_counters",
        "test_registry_collision_asserts",
        "test_histogram_log2_quantiles",
        "test_render_prometheus_style",
        "test_kill_switch_noops_tracing_keeps_counters",
        "test_env_kill_switch_resolution",
        "test_set_enabled_runtime_toggle",
        "test_mint_trace_32bit_nonzero",
        "test_trace_negotiation_and_server_spans",
        "test_trace_off_when_telemetry_disabled",
        # phase 19 (c) runs it on the card
        "test_trace_ids_match_under_chaos",
        "test_rung3_phase_failure_dump_attributes_conn_and_phase",
        "test_rung5_replica_exhausted_dump_attributes_endpoints",
        "test_dump_cooldown_limits_writes",
        "test_msg_stats_ships_registry_and_schema_conforms",
        "test_reconnecting_client_counters_shim_removed",
        "test_integrity_backend_namespaces_wrapper_counters")},
    "test_fused.py": {
        "test_fused_core_parity_representative":
            (_FD + "test_fused_core_parity_representative",
             _TF + "test_get_core_stats_match_both_jax_programs"),
        # slow: phase 3 holds every variant against its plain version on
        # every miss cause, and every path since (phases 4-18) again
        "test_fused_core_parity_full_grid":
            (_FD + "test_fused_core_parity_full_grid",
             _TF + "test_tiered_get_core_matches_jax_composed"),
        # slow: phase 8's recovering window and phase 9's restarted node
        "test_fused_core_parity_recovering":
            (_FD + "test_fused_core_parity_recovering",),
        # slow: phase 3's digest cause, phase 14's pool poisoned in place
        "test_fused_digest_cause_matches_composed":
            (_FD + "test_fused_digest_cause_matches_composed",),
        "test_fused_kv_stats_parity_and_reconcile":
            (_FD + "test_fused_kv_stats_parity_and_reconcile",),
        # the recorded differences: no PMDFC_FUSED, no KVConfig.fused_get,
        # no recompile counters in the port
        "test_fused_mode_env_parsing_is_strict":
            (_FD + "test_fused_mode_env_parsing_is_strict_in_jax_and_"
                   "absent_in_port",),
        "test_fused_config_field_validated":
            (_FD + "test_fused_config_field_validated_in_jax_and_absent_"
                   "in_port",),
        "test_unsupported_configs_ride_composed":
            (_FD + "test_unsupported_configs_ride_composed",),
        "test_fused_cold_rung_bumps_program_and_kernel_once":
            (_FD + "test_fused_cold_rung_counts_in_jax_and_not_in_port",),
        # slow: phase 13's fused_get harness (kernel side == composed chain
        # bit for bit) and phase 10's 4-shard plane through the kernel
        "test_fused_off_kill_switch_plane_is_conformant":
            (_FD + "test_fused_off_kill_switch_plane_is_conformant",),
    },
    "test_hashing.py": {name: (_HD + name,) for name in (
        "test_hash_deterministic_and_seed_sensitive",
        "test_hash_distribution_uniform",
        "test_hash_multi_independent",
        "test_key_pack_roundtrip_and_invalid")},
    "test_cceh.py": {name: (_CD + name,) for name in (
        "test_roundtrip_no_split",
        "test_split_grows_segments_and_keeps_entries",
        "test_eviction_fallback_when_headroom_exhausted",
        "test_update_in_place_and_delete",
        "test_duplicate_keys_in_batch_last_wins",
        "test_recovery_repairs_corrupt_directory",
        "test_paged_kv_pages_survive_splits",
        "test_kv_facade_end_to_end_with_cceh")},
    "test_hotring.py": {
        "test_shift_promotes_hot_keys_to_mirror":
            (_HR + "test_shift_promotes_hot_keys_to_mirror",),
        "test_mirror_never_serves_stale_values":
            (_HR + "test_mirror_never_serves_stale_values",),
        "test_decay_runs_shift":
            (_HR + "test_decay_halves_and_runs_the_shift",),
        # slow: at the JAX drill's own 700 keys; no phase on the card
        # rehashes a HotRing index (ROADMAP Queue 1)
        "test_rehash_splits_by_tag_half_losslessly":
            (_HR + "test_rehash_splits_by_tag_half_losslessly",),
        "test_facade_skew_workload_end_to_end":
            (_HRD + "test_facade_skew_workload_end_to_end",),
        "test_sampled_touch_counts_one_in_n":
            (_HRD + "test_sampled_touch_counts_one_in_n",),
    },
    "test_index_conformance.py": {
        **{name: (_ICD + name,) for name in (
            "test_roundtrip_and_update",
            "test_delete_returns_old_value",
            "test_duplicates_last_wins",
            "test_clean_cache_accounting_under_pressure",
            "test_padding_keys_are_noops",
            "test_scan_powers_find_anyway")},
        **{name: (_ICK + name,) for name in (
            "test_paged_kv_integration",
            "test_hotring_prefers_evicting_cold_entries",
            "test_hotring_decay_halves_counters",
            "test_get_values_matches_get_batch")}},
    "test_admit.py": {
        **{name: (_ENV + name,) for name in (
            "test_admit_env_resolution",
            "test_admit_off_bit_identical_conformance")},
        "test_scan_flood_denied_and_zipf_residency_holds":
            (_ADM + "test_scan_flood_denied_and_zipf_residency_holds",
             _ADM + "test_scan_flood_at_a_get_wider_than_the_epoch_shared_"
                    "by_both"),
        **{name: (_ADM + name,) for name in (
            "test_sketch_doorkeeper_then_cm_and_invalid_lanes",
            "test_sketch_aging_halves_cm_and_clears_doorkeeper",
            "test_ghost_override_readmits_below_threshold",
            "test_put_is_a_touch",
            "test_restore_restart_empty_matrix",
            # slow: at the JAX drill's own 48 keys; no phase on the card
            # restores or reshards a gated plane (ROADMAP Queue 1)
            "test_sharded_restore_and_reshard_restart_empty",
            "test_stats_surfaces_and_wire_pins",
            "test_autotune_admit_knob_registration_and_walks",
            "test_autotune_admit_knob_cadence_exemption",
            "test_autotune_no_gate_no_knob",
            "test_axis_rules_cover_admit_leaves")},
    },
    "test_mesh.py": {
        **{name: (_MD + name,) for name in (
            "test_axis_rules_cover_every_leaf",
            "test_rules_validate_against_mesh",
            "test_sharded_kv_rejects_bad_rules",
            "test_router_binning_is_loss_free_and_stable",
            "test_plane_matches_single_device_results",
            "test_plane_per_shard_attribution_sums_to_truth",
            "test_plane_backend_telemetry_and_warmup_are_stat_clean",
            "test_plane_counting_path_still_migrates_tier",
            # slow: phases 8 and 10 serve the single-device wire and the
            # 4-shard plane behind the coalescing NetServer
            "test_mesh_plane_bit_identical_to_single_device_serving",
            "test_mesh_off_kill_switch_is_conformant",
            "test_kvserver_mesh_mode_serves_engine_verbs",
            "test_kvserver_mesh_respects_kill_switch",
            # slow: no phase on the card reshards an unpaged plane or a
            # tiered one (ROADMAP Queue 1)
            "test_unpaged_reshard_keeps_values_and_extents",
            "test_tiered_reshard_drops_only_stale")},
        # 2 -> 3 and 8 -> 4 slow: the card reshards 4 -> 8 (phase 10),
        # 2 -> 4 (phase 12 (a)) and 4 -> 2 (phase 16), not these two
        "test_reshard_restore_loses_nothing":
            (_MD + "test_reshard_restore_loses_nothing",
             _MCK + "test_reshard_restore_loses_nothing_like_jax"),
        "test_reshard_restore_rejects_mismatched_config":
            (_MCK + "test_reshard_restore_rejects_mismatched_config",),
    },
    "test_durability.py": {
        **{name: (_JR + name,) for name in (
            "test_keyjournal_bounded_set",
            "test_journal_seq_resumes_in_fresh_segment",
            "test_journal_replay_idempotent_no_resurrection",
            "test_torn_tail_truncated_and_counted",
            "test_corrupt_history_refused",
            "test_recovery_state_travels_the_wire",
            "test_server_checkpoint_delta_and_health",
            # slow: phase 9's crashbox kills and phase 17's kill and restore
            "test_crashbox_sigkill_torn_tail_drill")},
        **{name: (_CK + name,) for name in (
            "test_delta_chain_roundtrip_and_refusals",
            "test_restore_refusal_names_the_leaf")},
        **{name: (_DD + name,) for name in (
            "test_miss_recovering_attribution_and_ledger",
            "test_warm_restart_end_to_end",
            "test_warm_restart_empty_chain_replays_from_start",
            "test_ring_rejoin_bumps_epoch_same_members",
            # slow: phases 10 and 12 (a) restore a chain with restore_chain
            # onto as many shards as wrote it; none onto fewer (ROADMAP)
            "test_reshard_after_restore_chain")},
    },
    # -- the last 13 suites, in ROADMAP Queue 1's order --------------------
    "test_qos.py": {
        **{name: (_QOS + name,) for name in (
            "test_tag_roundtrip_and_payload_preserved",
            "test_client_tag_agrees_with_plane_tag",
            "test_untagged_and_unregistered_resolve_to_default",
            "test_token_bucket_all_or_nothing_and_unlimited",
            "test_drr_composition_follows_weights",
            "test_drr_serves_whole_ops_and_repays_debt",
            "test_shed_ladder_lowest_priority_newest_first",
            "test_shed_ladder_spares_nonsheddable_ops",
            "test_kv_account_shed_keeps_causes_exact",
            "test_sharded_account_shed_keeps_causes_exact",
            "test_check_qos_accepts_consistent_lanes",
            "test_check_qos_rejects_drift",
            "test_check_qos_rejects_straggler_lanes",
            "test_miss_shed_in_cause_taxonomy",
            "test_autotune_registers_rate_limited_tenants_only",
            "test_config_validation")},
        # slow: phase 14 (c), the QoS edge shed at 2^11-page verbs
        "test_wire_shed_drill_end_to_end":
            (_QOSD + "test_wire_shed_drill_end_to_end",),
        # slow: phase 14 (c), PMDFC_QOS=off
        "test_qos_off_is_single_tenant_fifo":
            (_QOSD + "test_qos_off_is_single_tenant_fifo",),
        "test_lock_rank_and_module_coverage_pins":
            (_QOSD + "test_lock_rank_and_module_coverage_pins",),
    },
    "test_xray.py": {
        **{name: (_XR + name,) for name in (
            "test_delta_tracker_windows",
            "test_series_ring_wraparound_and_sparse_windows",
            "test_slo_watchdog_breaches_on_shared_windows",
            "test_causes_cold_vs_evicted_flat",
            "test_causes_stale_and_digest_tiered",
            "test_causes_parked_nopage",
            "test_causes_get_extent_and_sharded_arbitration",
            "test_kmv_exact_below_k_and_bounded_error_above",
            "test_heat_sketch_finds_the_hot_region",
            "test_prometheus_render_labels_shard_families")},
        **{name: (_XRD + name,) for name in (
            "test_series_concurrent_writers",
            "test_collector_daemon_dies_with_registry_swap",
            "test_snapshot_v2_carries_series_and_v1_fields",
            "test_workload_window_rolls",
            "test_check_teledump_pins_v2",
            "test_slo_breach_dump_carries_series_tail",
            # slow: phase 14 (b), 2^16 slots a shard
            "test_xray_acceptance_soak_and_teletop")},
    },
    "test_chaos.py": {
        **{name: (_CH + name,) for name in (
            "test_chaos_soak_short",
            "test_chaos_extent_verbs_degrade_to_drop_conn",
            "test_chaos_stats_verb_degrades_to_drop_conn",
            "test_chaos_soak_deterministic_schedule",
            "test_chaos_soak_short_pipelined",
            "test_chaos_pipelined_replies_match_seq_or_drop",
            "test_soak_leaves_attributable_trace")},
        # slow: phase 14 (a) runs the short soak (120 steps, one kill) at
        # 2^18 slots; no phase runs the doubled rates or a second kill
        "test_chaos_soak_long": (_CHD + "test_chaos_soak_long",),
        # slow: phase 14 (a)'s windowed soak (120 steps, no kill); none
        # with kills
        "test_chaos_soak_long_pipelined":
            (_CHD + "test_chaos_soak_long_pipelined",),
        # slow: phase 14 (c), the reconnect storm's bounded backoff
        "test_reconnect_storm_after_phase_failures_is_backoff_bounded":
            (_CHD + "test_reconnect_storm_after_phase_failures_is_backoff_"
                    "bounded",),
        # slow: phase 14 (c), the NACKed ops' spans closed failed
        "test_nacked_ops_close_spans_as_failed_v2_records":
            (_CHD + "test_nacked_ops_close_spans_as_failed_v2_records",),
    },
    "test_containment.py": {
        **{name: (_CO + name,) for name in (
            "test_replica_group_deadline_stops_failover",
            "test_faultplan_seam",
            "test_faulty_backend_capability_mirror",
            "test_shard_quarantine_unit")},
        # the eight slow drills: phase 14 (c) runs each at 2^11-page verbs
        **{name: (_CO + name,) for name in (
            "test_nack_negotiation_and_kill_switch",
            "test_poison_bisection_isolates_culprit",
            "test_unnegotiated_peer_keeps_conn_drop_semantics",
            "test_deadline_shed_lands_in_miss_deadline",
            "test_deadline_zero_means_none",
            "test_plane_shard_quarantine_and_readmission",
            "test_plane_containment_off_is_conformant",
            "test_poison_fingerprint_is_verb_seeded")},
    },
    "test_tracing.py": {
        "test_span_begin_end_ambient_nesting": _SPANS,
        "test_span_out_of_order_end_unwinds_stack": _SPANS,
        "test_span_kill_switch": _SPANS,
        "test_record_span_parents_off_ambient": _SPANS,
        "test_pipelined_get_yields_nested_trace_and_chrome_export":
            (_TR + "test_get_trace_shape_matches_jax",),
        "test_hedge_fires_hedge_marked_attempt_span":
            (_TR + "test_hedge_attempt_spans_match_jax",),
        "test_cold_ladder_rung_increments_exactly_one_named_counter":
            (_TR + "test_cold_ladder_rung_counts_in_jax_and_not_in_port",),
        "test_plane_wrap_cache_miss_is_tracked":
            (_TR + "test_plane_wrap_tracked_in_jax_and_not_in_port",),
        "test_slo_burn_windows_and_starvation":
            (_TR + "test_slo_burn_windows_and_starvation_match_jax",),
        "test_attribute_stage_names_dominant_disjoint_stage":
            (_TR + "test_attribute_stage_matches_jax",),
        "test_slo_watchdog_restartable":
            (_TR + "test_slo_watchdog_restartable_in_both",),
        "test_slo_config_from_dict_roundtrip_and_validation":
            (_TR + "test_slo_config_from_dict_matches_jax",),
        "test_injected_latency_breaches_p99_and_dumps_attributable_flight":
            (_TR + "test_injected_latency_breach_names_flush_get_in_both",),
        "test_dump_dir_rotation_caps_file_count":
            (_TR + "test_dump_dir_rotation_caps_file_count_in_both",),
        "test_shard_span_attribution_sums_to_mesh_counters":
            (_TR + "test_shard_span_attribution_sums_to_mesh_counters_in_"
                   "both",),
        "test_check_bench_lane_regression_gate":
            (_TR + "test_check_bench_gate_over_port_net_sweep_rows",),
        "test_check_bench_fused_kernel_lanes_never_collapse":
            (_TR + "test_check_bench_port_transports_never_collapse",),
    },
    "test_client.py": {name: (_CLD + name,) for name in (
        "test_longkey_construction",
        "test_cleancache_roundtrip_local_backend",
        "test_cleancache_bloom_short_circuits_misses",
        "test_bloom_refresh_pulls_server_truth",
        "test_swap_client",
        "test_paging_sim_seq_read_uses_cleancache",
        "test_paging_sim_writes_never_read_stale",
        "test_page_content_versioning",
        "test_replay_synthetic",
        "test_bundled_fileserver_trace_replays",
        "test_write_fileserver_trace_deterministic",
        "test_parse_trace",
        "test_gen_input_patterns",
        "test_hash_families_lockstep_and_distribution",
        "test_hashing_np_matches_jax")},
    "test_runtime.py": {name: (_RTD + name,) for name in (
        "test_engine_mpmc_roundtrip_no_server",
        "test_single_put_get_known_content",
        "test_threaded_storm_with_content_verification",
        "test_submit_batch_wait_many_roundtrip",
        "test_queue_full_backpressure_without_driver",
        "test_completion_slot_wraparound",
        "test_deep_pipelined_client_needs_comp_slots",
        "test_deep_pipelined_client_wedges_without_comp_slots",
        # slow: phase 7, the engine-backed server under 32 client threads
        "test_reference_grade_storm",
        "test_extent_verbs_through_transport_storm",
        "test_multi_client_arena_isolation",
        "test_unpaged_u64_values_mode",
        "test_double_start_is_idempotent",
        "test_engine_destroy_under_client_fire",
        "test_single_flush_put_delete_get_ordering")},
    "test_pressure.py": {name: (_PRD + name,) for name in (
        "test_fileserver_personality_verifies",
        "test_webserver_personality_verifies",
        "test_dgwebserver_scales_fileset",
        "test_randomread_working_set",
        "test_trim_is_invalidate_inode",
        "test_fileset_gamma_sizes",
        # slow: phase 13's train_pressure (4 KiB pages, 100 steps)
        "test_train_pressure_learns",
        "test_swap_randread_all_remote",
        "test_swap_drops_recover_from_device",
        "test_swap_writes_never_serve_stale",
        "test_swap_iodepth_batch_path_verifies",
        "test_swap_parallel_jobs_aggregate",
        "test_paging_read_batch_matches_per_op_semantics")},
    "test_replica.py": {
        "test_replica_map_stable_spread_and_distinct":
            ("test_torch_replica.py::"
             "test_replica_map_stable_spread_and_distinct",),
        "test_fanout_put_get_invalidate_local": _HERMETIC,
        "test_rejoin_triggers_bloom_guided_repair":
            (_RPD + "test_rejoin_triggers_bloom_guided_repair",
             "test_torch_replica_rejoin.py::"
             "test_rejoin_triggers_bloom_guided_repair"),
        **{name: (_RPD + name,) for name in (
            "test_breaker_state_machine",
            "test_kill_one_server_failover_serves_and_breaker_opens",
            "test_all_replicas_down_is_a_legal_miss",
            # slow: phase 18 (f1), node 0's proxy slowed under 2^11 keys
            "test_hedged_get_fires_on_slow_primary",
            # slow: phase 13's replica_soak (a kill every 30 steps)
            "test_rolling_kill_restore_drill",
            # slow: phase 18 (f2), chaos on three card-backed endpoints
            "test_multi_endpoint_chaos_soak")},
    },
    "test_aux.py": {
        **{name: (_PC + name,) for name in (
            "test_policy_cache_lru",
            "test_policy_cache_lfu",
            "test_policy_cache_fifo",
            "test_policy_cache_update_not_evict")},
        "test_logger_levels": ("test_torch_logger.py::test_logger_levels",),
        "test_checkpoint_roundtrip":
            (_AXD + "test_checkpoint_roundtrip",
             "test_torch_checkpoint.py::test_full_snapshot_crosses_both_"
             "ways"),
        **{name: (_AXD + name,) for name in (
            "test_timers_and_reporter",
            "test_checkpoint_recovery_repairs_cceh",
            "test_checkpoint_rejects_wrong_config")},
    },
    "test_profiler.py": {
        "test_fetch_splits_device_and_dispatch":
            (_PF + "test_fetch_splits_device_and_dispatch_like_jax",),
        "test_kv_sync_verbs_attribute_through_the_seam":
            (_PF + "test_kv_verbs_attribute_like_jax",),
        "test_shard_lanes_reconcile_with_mesh_ops":
            (_PF + "test_shard_lanes_reconcile_like_jax",),
        "test_imbalance_gauge_tracks_skew_within_range":
            (_PF + "test_imbalance_window_matches_jax",),
        # slow: phase 11's MSG_PROFILE capture and its refused second ask
        "test_msg_profile_capture_cooldown_and_old_peer":
            (_PF + "test_msg_profile_port_server_captures_for_both_clients",
             _PF + "test_msg_profile_jax_server_captures_for_the_port_"
                   "client"),
        # slow: no phase asks a server without a dump dir for a capture
        "test_msg_profile_refused_without_dump_dir":
            (_PF + "test_msg_profile_refused_without_dump_dir",),
        "test_proftool_breakdown_and_perfetto":
            (_PF + "test_proftool_reads_the_port_snapshot",),
        "test_prof_off_snapshots_stay_v2":
            (_PF + "test_fetch_is_a_passthrough_when_nothing_attaches",),
    },
    "test_soak.py": {
        # slow: phase 13's soak (0.5 min, 4 KiB pages)
        "test_soak_smoke_clean_run":
            ("test_torch_bench_soaks.py::"
             "test_soak_serves_verified_pages_like_jax",),
        # slow: a recorded difference (ROADMAP), pinned on both packages;
        # no phase runs it (the port's --history is a card-only log)
        "test_soak_history_offchip_exits_3":
            ("test_torch_soak_drills.py::"
             "test_soak_history_offchip_exits_3_in_jax_and_0_in_port",),
        # slow: phase 13's insert_profile
        "test_insert_profile_smoke":
            ("test_torch_bench_sweeps.py::"
             "test_insert_profile_reports_jaxs_pieces",),
    },
    # the whole suite is slow (its module mark)
    "test_multihost.py": {
        # phase 12's multihost_bench, two gloo ranks on the card
        "test_multihost_bench_smoke":
            ("test_torch_multihost_drills.py::test_multihost_bench_smoke",),
        # phase 12 (a): the two-process plane's verbs
        "test_two_process_sharded_kv":
            ("test_torch_multihost.py::"
             "test_two_processes_match_one_process_and_jax",),
    },
}

# every target must run both packages in its own function (the
# function-level check below), or stand in EXEMPT with its reason
_TIER1 = "timed: its JAX side is {} own tier-1 drill; the port's holds " \
         "the same invariants on the same seed"
EXEMPT = {
    _CH + "test_chaos_soak_short": _TIER1.format("test_chaos.py's"),
    _CH + "test_chaos_extent_verbs_degrade_to_drop_conn":
        _TIER1.format("test_chaos.py's") + " (the reconnect loop)",
    _CH + "test_chaos_stats_verb_degrades_to_drop_conn":
        _TIER1.format("test_chaos.py's") + " (a flipped frame's drop)",
    _CH + "test_chaos_soak_short_pipelined": _TIER1.format("test_chaos.py's"),
    _CH + "test_chaos_pipelined_replies_match_seq_or_drop":
        _TIER1.format("test_chaos.py's") + " (four threads, armed faults)",
    _CH + "test_soak_leaves_attributable_trace":
        _TIER1.format("test_chaos.py's") + " (the flight ring of a soak)",
}


def _jax_suites() -> list[str]:
    return sorted(p.name for p in TESTS.glob("test_*.py")
                  if not p.name.startswith("test_torch_"))


def _test_functions(name: str) -> set[str]:
    """The module-level `test_*` functions of tests/<name>."""
    tree = ast.parse((TESTS / name).read_text(), name)
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_")}


def _packages(name: str) -> set[str]:
    """The packages tests/<name> reaches: `pmdfc_tpu` and `pmdfc_tpu_torch`
    directly, or through `torch_twin` (both) or another port test file
    (the port's)."""
    mods = set()
    for n in ast.walk(ast.parse((TESTS / name).read_text(), name)):
        if isinstance(n, ast.Import):
            mods |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module:
            mods.add(n.module)
    tops = {m.split(".")[0] for m in mods}
    out = tops & {"pmdfc_tpu", "pmdfc_tpu_torch"}
    if "torch_twin" in tops:
        out |= {"pmdfc_tpu", "pmdfc_tpu_torch"}
    if any(t.startswith("test_torch_") for t in tops):
        out.add("pmdfc_tpu_torch")
    return out


def test_the_table_names_exactly_the_jax_suites():
    suites = _jax_suites()
    assert len(suites) >= 39
    missing = sorted(set(suites) - set(TWINS))
    gone = sorted(set(TWINS) - set(suites))
    assert not missing, f"JAX suites with no twin and no reason: {missing}"
    assert not gone, f"entries for JAX suites that no longer exist: {gone}"


@pytest.mark.parametrize("suite", sorted(TWINS))
def test_each_jax_suite_has_a_twin_or_a_reason(suite):
    twins = TWINS[suite]
    if isinstance(twins, str):
        assert len(twins) > 40, f"{suite}: the reason is not recorded"
        return
    assert twins, f"{suite}: no twin named"
    for name in twins:
        assert name.startswith("test_torch_"), name
        assert (TESTS / name).exists(), f"{suite}: {name} does not exist"
        assert _test_functions(name), f"{suite}: {name} holds no test"
        assert "pmdfc_tpu_torch" in _packages(name), \
            f"{suite}: {name} does not reach the port"


@pytest.mark.parametrize("suite", sorted(DRILLS))
def test_each_jax_drill_maps_to_an_existing_port_test(suite):
    drills = DRILLS[suite]
    jax_tests = _test_functions(suite)
    missing = sorted(jax_tests - set(drills))
    gone = sorted(set(drills) - jax_tests)
    assert not missing, f"{suite}: drills with no port test: {missing}"
    assert not gone, f"{suite}: entries for drills that are gone: {gone}"
    for drill, targets in drills.items():
        assert targets, f"{suite}::{drill}: no port test named"
        for target in targets:
            name, func = target.split("::")
            assert name in TWINS[suite], \
                f"{suite}::{drill}: {name} is not among the suite's twins"
            assert func in _test_functions(name), \
                f"{suite}::{drill}: {target} does not exist"
            assert _packages(name) == {"pmdfc_tpu", "pmdfc_tpu_torch"}, \
                f"{suite}::{drill}: {name} does not run both packages"


def test_every_twinned_suite_is_mapped_drill_by_drill():
    twinned = sorted(k for k, v in TWINS.items() if not isinstance(v, str))
    assert len(twinned) >= 37
    unmapped = sorted(set(twinned) - set(DRILLS))
    assert not unmapped, f"twinned suites not mapped drill by drill: " \
        f"{unmapped}"
    # the function-level walk takes every mapped suite
    walk, = (m for m in
             test_each_drill_of_the_last_suites_runs_both_packages.pytestmark
             if m.name == "parametrize")
    assert sorted(walk.args[1]) == sorted(DRILLS) and len(DRILLS) >= 37, \
        "a mapped suite is not walked function by function"


def _jax_module(mod: str) -> bool:
    """A module of the JAX side: `pmdfc_tpu` or a JAX test suite."""
    top = mod.split(".")[0]
    return top == "pmdfc_tpu" or (top.startswith("test_")
                                  and not top.startswith("test_torch_"))


_JAX_NAMES = ("JAX", "PKGS", "twin")  # torch_twin's names that run JAX


def _reach_map(source: str, resolve=None) -> dict:
    """For each module-level `test_*` function of a port test file's
    source: whether it reaches JAX's side in its own body, its decorators,
    its fixtures or the module's helpers it names. `resolve(module, name)`
    answers for a name imported from another `test_torch_*` file."""
    tree = ast.parse(source)
    jax, imported, defs = set(), {}, {}
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.module:
            for a in n.names:
                bound = a.asname or a.name
                if _jax_module(n.module) or (n.module == "torch_twin"
                                             and a.name in _JAX_NAMES):
                    jax.add(bound)
                elif n.module.startswith("test_torch_"):
                    imported[bound] = (n.module, a.name)
        elif isinstance(n, ast.Import):
            for a in n.names:
                if _jax_module(a.name):
                    jax.add((a.asname or a.name).split(".")[0])
        elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            defs[n.name] = n
        elif isinstance(n, (ast.Assign, ast.AnnAssign)) and n.value:
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                for x in ast.walk(t):
                    if isinstance(x, ast.Name):
                        defs[x.id] = n.value

    def names(node, bound: bool = False) -> set:
        """The names `node` uses. A module-level value (`bound`) names
        neither a constant it reads (`jmod.RATES`) nor what a comprehension
        iterates: it holds that data, no code of either package."""
        out = set()
        todo = [node]
        while todo:
            x = todo.pop()
            if bound and isinstance(x, ast.Attribute) \
                    and re.fullmatch(r"[A-Z][A-Z0-9_]*", x.attr):
                continue
            if bound and isinstance(x, ast.comprehension):
                todo.extend(x.ifs)
                continue
            if isinstance(x, ast.Name):
                out.add(x.id)
            elif isinstance(x, ast.arg):
                out.add(x.arg)
            elif isinstance(x, ast.Import) and any(
                    _jax_module(a.name) for a in x.names):
                out.add("JAX")
            elif isinstance(x, ast.ImportFrom) and x.module \
                    and _jax_module(x.module):
                out.add("JAX")
            elif isinstance(x, ast.Constant) and isinstance(x.value, str) \
                    and re.fullmatch(r"pmdfc_tpu(\.\w+)+", x.value):
                out.add("JAX")
            todo.extend(ast.iter_child_nodes(x))
        return out

    def reaches(name: str, seen: set) -> bool:
        if name in jax or name == "JAX":
            return True
        if name in seen:
            return False
        seen.add(name)
        if name in imported and resolve is not None:
            return resolve(*imported[name])
        node = defs.get(name)
        return node is not None and any(
            reaches(u, seen)
            for u in names(node, bound=isinstance(node, ast.expr)) - {name})

    return {n.name: any(reaches(u, {n.name}) for u in names(n))
            for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_")}


@functools.lru_cache(maxsize=None)
def _resolve(module: str, name: str, depth: int = 0) -> bool:
    """Whether `name` of tests/<module>.py reaches JAX's side."""
    if depth > 3 or not (TESTS / f"{module}.py").exists():
        return False
    src = (TESTS / f"{module}.py").read_text()
    wrapped = f"{src}\n\ndef test__probe():\n    {name}\n"
    return _reach_map(wrapped, lambda m, n: _resolve(m, n, depth + 1))[
        "test__probe"]


@functools.lru_cache(maxsize=None)
def _file_reach(name: str) -> dict:
    return _reach_map((TESTS / name).read_text(), _resolve)


def _reaches_jax(name: str, func: str) -> bool:
    return _file_reach(name)[func]


@pytest.mark.parametrize("suite", sorted(DRILLS))
def test_each_drill_of_the_last_suites_runs_both_packages(suite):
    alone = []
    for drill, targets in DRILLS[suite].items():
        for target in targets:
            name, func = target.split("::")
            if target in EXEMPT:
                assert len(EXEMPT[target]) > 40, f"{target}: no reason"
                assert not _reaches_jax(name, func), \
                    f"{target} runs both packages: its exemption is stale"
            elif not _reaches_jax(name, func):
                alone.append(f"{drill} -> {target}")
    assert not alone, f"{suite}: port tests that run the port alone: {alone}"


def test_every_exemption_names_a_mapped_target():
    targets = {t for drills in DRILLS.values() for ts in drills.values()
               for t in ts}
    assert set(EXEMPT) <= targets, sorted(set(EXEMPT) - targets)


PLANTED = """
import numpy as np
import pmdfc_tpu.runtime.engine as jeng
import pmdfc_tpu_torch.kv as tkv
import test_analyze as jdrill
from test_torch_analyze import write_tree
from tools.analyze import Allowlist, build_model, jaxrules
from torch_twin import PORT, twin
from torch_twin import JAX as _J

REF = (_J, PORT)
OP_PUT = jeng.OP_PUT
KINDS = [k.value for k in jeng.Kind]


def _port_only(n):
    return PORT.KV(None), tkv.KV


def _both(n):
    return [p for p in REF]


def test_port_only_helper():
    _port_only(3)


def test_port_only_fixture(some_fixture):
    assert np.zeros(3).sum() == 0


def test_through_twin():
    twin(lambda p: p)


def test_through_a_helper():
    _both(2)


def test_through_a_local_import():
    from pmdfc_tpu.bench import soak  # noqa: F401


def test_through_a_child_process():
    run(["python", "-m", "pmdfc_tpu.bench.soak"])


def test_port_only_with_a_jax_constant():
    PORT.KV(OP_PUT)


def test_port_only_with_values_read_from_jax():
    PORT.KV(KINDS)


def test_the_tool_over_a_port_fixture_only(tmp_path):
    files = write_tree(tmp_path, {"pmdfc_tpu_torch/runtime/x.py": "X = 1"})
    assert jaxrules.run(build_model(files), Allowlist({})) == []


def test_the_tool_through_jaxs_own_suite():
    assert jdrill._run_all("clean_locks.py") == []
"""


def test_the_function_check_catches_a_planted_port_only_fixture():
    reach = _reach_map(PLANTED)
    assert reach == {"test_port_only_helper": False,
                     "test_port_only_fixture": False,
                     "test_through_twin": True,
                     "test_through_a_helper": True,
                     "test_through_a_local_import": True,
                     "test_through_a_child_process": True,
                     "test_port_only_with_a_jax_constant": False,
                     "test_port_only_with_values_read_from_jax": False,
                     "test_the_tool_over_a_port_fixture_only": False,
                     "test_the_tool_through_jaxs_own_suite": True}
    # the real files: a port-only twin is caught, a two-package one passes
    assert not _reaches_jax("test_torch_chaos.py", "test_chaos_soak_short")
    assert _reaches_jax("test_torch_replica_drills.py",
                        "test_multi_endpoint_chaos_soak")
